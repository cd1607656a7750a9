"""Experiment runners that reproduce the paper's tables with the port (the
counterparts of the JAX package's ``scripts/ablation_length.py``,
``ablation_pattern.py``, ``comparison_table.py`` and
``run_protocol_all.py``), each run as ``python -m
pathnet_tpu_torch.experiments.<name>``.

They run on the CUDA card unless ``--device cpu`` is given, read data under
``--data-root`` (``data``) and write their artifacts under ``--results-dir``
(``results_torch``), with the JAX scripts' keys; ``results/`` holds the JAX
package's own artifacts under the same names. ``platform`` in an artifact is
the torch device type (``cuda`` or ``cpu``).
"""
import argparse


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags every runner takes beside the JAX script's own."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--data-root", type=str, default="data")
    p.add_argument("--results-dir", type=str, default="results_torch")
    return p
