#!/usr/bin/env python3
"""The 10 x 1000 protocols that ``chip_smoke.py`` cuts to one round.

Run from the root of a checkout on a machine with one CUDA card:
``python3 full_protocols.py [label ...]`` (default: all eighteen; a label is
``cornell:merw``, ``cornell:uniform``, ``Nba:merw``, ``cora:merw``,
``citeseer:merw``, ``cornell:mlp``, ``cornell:quirk``,
``cornell:gru_bf16``, or ``<dataset>:zoo-<model>`` for a baseline band of
``chip_smoke.BASELINE_BANDS``: ``cornell:zoo-mlp``, ``cora:zoo-mlp``,
``Nba:zoo-mlp``, ``bgp:zoo-mlp``, ``cornell:zoo-gcn``, ``cornell:zoo-gat``,
``cora:zoo-gcn``, ``cora:zoo-gat``, or ``cornell:zoo-gcn-bf16``,
``cornell:zoo-gat-bf16`` for ``chip_smoke.BASELINE_BF16_BANDS`` at ``--dtype
bfloat16``). It copies ``data/edge_input/*.in`` into a temporary data root
and runs, through ``chip_smoke.run_protocol_cli`` (the CLI, 10 rounds x 1000
epochs, temporary results and checkpoint directories), cornell, cornell
``-mk uniform``, Nba at H = 256, cora, citeseer, and cornell ``--rnn mlp``,
``--quirk-compat`` and ``--rnn gru --dtype bfloat16``, and through
``chip_smoke.run_baseline_cli`` each baseline band (``--model``), each held
inside its JAX band. Exits 1 if any lies outside its band or fails.
"""
import glob
import os
import shutil
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

# (label, dataset, hidden, band, payload, run_protocol_cli's choices)
RUNS = [("cornell:merw", "cornell", cs.HIDDEN, cs.CORNELL_BAND, cs.CORNELL_PAYLOAD, {}),
        ("cornell:uniform", "cornell", cs.HIDDEN, cs.CORNELL_UNIFORM_BAND, cs.CORNELL_PAYLOAD,
         dict(marker="uniform")),
        ("Nba:merw", "Nba", cs.NBA_HIDDEN, cs.NBA_BAND, cs.NBA_PAYLOAD, {}),
        ("cora:merw", "cora", cs.HIDDEN, cs.CORA_BAND, cs.HOMO_PAYLOADS["cora"], {}),
        ("citeseer:merw", "citeseer", cs.HIDDEN, cs.CITESEER_BAND,
         cs.HOMO_PAYLOADS["citeseer"], {}),
        ("cornell:mlp", "cornell", cs.HIDDEN, cs.CORNELL_MLP_BAND, cs.CORNELL_PAYLOAD,
         dict(rnn="mlp")),
        ("cornell:quirk", "cornell", cs.HIDDEN, cs.CORNELL_QUIRK_BAND, cs.CORNELL_PAYLOAD,
         dict(quirk=True)),
        ("cornell:gru_bf16", "cornell", cs.HIDDEN, cs.CORNELL_GRU_BF16_BAND,
         cs.CORNELL_PAYLOAD, dict(rnn="gru", dtype="bfloat16"))]
RUNS += [(f"{name}:zoo-{model}", name, hidden, band, payload, dict(model=model))
         for (name, model), (band, payload, hidden) in cs.BASELINE_BANDS.items()]
RUNS += [(f"cornell:zoo-{model}-bf16", "cornell", hidden, band, payload,
          dict(model=model, dtype="bfloat16"))
         for model, (band, payload, hidden) in cs.BASELINE_BF16_BANDS.items()]


def main(only) -> int:
    print(cs.nvidia_smi_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        os.makedirs(os.path.join(root, "edge_input"))
        for f in glob.glob(os.path.join(cs.ROOT, "data", "edge_input", "*.in")):
            shutil.copy(f, os.path.join(root, "edge_input"))
        for label, name, hidden, band, payload, kw in RUNS:
            if only and label not in only:
                continue
            try:
                if "model" in kw:
                    cs.run_baseline_cli(name, kw["model"], root, tmp, 10, hidden, band, payload,
                                        dtype=kw.get("dtype", "float32"))
                else:
                    cs.run_protocol_cli(name, root, tmp, 10, hidden, band, payload, **kw)
            except Exception:
                traceback.print_exc()
                failed.append(label)
    print("FAILED " + " ".join(failed) if failed else "ALL INSIDE THEIR BANDS", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
