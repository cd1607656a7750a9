#!/usr/bin/env python3
"""The 10 x 1000 protocols that ``chip_smoke.py`` cuts to one round.

Run from the root of a checkout on a machine with one CUDA card:
``python3 full_protocols.py [name:marker ...]`` (default: all five). It
copies ``data/edge_input/*.in`` into a temporary data root and runs, through
``chip_smoke.run_protocol_cli`` (the CLI, 10 rounds x 1000 epochs, temporary
results and checkpoint directories), cornell, cornell ``-mk uniform``, Nba
at H = 256, cora and citeseer, each held inside its JAX band. Exits 1 if
any lies outside its band or fails.
"""
import glob
import os
import shutil
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402

RUNS = [("cornell", cs.HIDDEN, cs.CORNELL_BAND, cs.CORNELL_PAYLOAD, "merw"),
        ("cornell", cs.HIDDEN, cs.CORNELL_UNIFORM_BAND, cs.CORNELL_PAYLOAD, "uniform"),
        ("Nba", cs.NBA_HIDDEN, cs.NBA_BAND, cs.NBA_PAYLOAD, "merw"),
        ("cora", cs.HIDDEN, cs.CORA_BAND, cs.HOMO_PAYLOADS["cora"], "merw"),
        ("citeseer", cs.HIDDEN, cs.CITESEER_BAND, cs.HOMO_PAYLOADS["citeseer"], "merw")]


def main(only) -> int:
    print(cs.nvidia_smi_line(), flush=True)
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        os.makedirs(os.path.join(root, "edge_input"))
        for f in glob.glob(os.path.join(cs.ROOT, "data", "edge_input", "*.in")):
            shutil.copy(f, os.path.join(root, "edge_input"))
        for name, hidden, band, payload, marker in RUNS:
            if only and f"{name}:{marker}" not in only:
                continue
            try:
                cs.run_protocol_cli(name, root, tmp, 10, hidden, band, payload, marker=marker)
            except Exception:
                traceback.print_exc()
                failed.append(f"{name}:{marker}")
    print("FAILED " + " ".join(failed) if failed else "ALL INSIDE THEIR BANDS", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
