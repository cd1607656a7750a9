"""CLI: compute MERW transition probabilities and write ``<name>_nsl.in``
(port of ``pathnet_tpu/init_rw.py``; reference: preprocess/init_rw.py:48-89).

    python -m pathnet_tpu_torch.init_rw -data cornell [-data cora ...] \
        [--data-root data] [--out <data-root>/edge_input_torch] [--device cpu]

For each dataset: load its edge structure (``registry.load_structure``), run
the principal-eigenpair power iteration on the card (``merw.merw_graph``,
unit record weights, so a record's multiplicity is its weight, as in
init_rw.py:75; a probability column on the input is ignored) and write the
weighted edge-input file in the reference layout (header ``n m``, then ``u v
P[u,v]`` a directed record, ``formats.write_edge_input``). ``--device``
takes the JAX CLI's ``--platform``'s place (default: the CUDA card). The
default output directory is ``<data-root>/edge_input_torch``:
``<data-root>/edge_input`` holds the JAX package's tracked files, which the
registry reads.
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="MERW edge-input writer")
    p.add_argument("-data", "--data_name", action="append", required=True)
    p.add_argument("--data-root", type=str, default="data")
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default <data-root>/edge_input_torch)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the power iteration (default: the CUDA card)")
    args = p.parse_args(argv)

    import numpy as np

    from .data.formats import write_edge_input
    from .data.registry import load_structure
    from .device import resolve_device
    from .merw import merw_graph

    dev = resolve_device(args.device)
    out_dir = args.out or os.path.join(args.data_root, "edge_input_torch")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in args.data_name:
        t0 = time.time()
        g = load_structure(name, args.data_root)
        gm = merw_graph(g, weights=np.ones(len(g.src)), device=dev)
        path = os.path.join(out_dir, f"{name}_nsl.in")
        write_edge_input(path, gm.n, gm.src, gm.dst, gm.prob)
        print(f"{name}: n={gm.n} m={len(gm.src)} -> {path} "
              f"({time.time() - t0:.1f}s)")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
