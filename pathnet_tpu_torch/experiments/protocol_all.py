"""The full reference protocol over many datasets (counterpart of
``scripts/run_protocol_all.py``): 10 rounds x 1000 epochs each through the
port's CLI (``pathnet_tpu_torch.run.main``), so every dataset appends its
reference-format result line and JSONL row to ``--results-dir`` as ``python
-m pathnet_tpu_torch.run`` does.

    python -m pathnet_tpu_torch.experiments.protocol_all [names...] [--epochs E] [--rounds R]

Per-dataset hidden width and microbatch are the JAX script's ``HYPERS``
(the reference's checked-in run configs: cornell hid=64, Nba hid=256,
Electronics hid=32, the rest the CLI defaults), in its ``DEFAULT_ORDER``. A
dataset that raises is recorded and the sweep goes on; the status of each
(``ok``, ``seconds``, and ``error`` for a failure) is rewritten to
``<results-dir>/protocol_all_status.json`` after each.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from . import add_common_args

# (hidden, microbatch) per reference configs + memory limits
HYPERS = {
    "cornell": dict(hid=64),
    "cora": dict(hid=64),
    "citeseer": dict(hid=64),
    "pubmed": dict(hid=64, microbatch=8192),
    "Nba": dict(hid=256),
    "bgp": dict(hid=64, microbatch=8192),
    "Electronics": dict(hid=32, microbatch=4096),
    "Dblp": dict(hid=64, microbatch=8192),
    "texas": dict(hid=64),
    "wisconsin": dict(hid=64),
    "chameleon": dict(hid=64),
    "film": dict(hid=64),
    "squirrel": dict(hid=64),
}
DEFAULT_ORDER = ["cornell", "texas", "wisconsin", "Nba", "cora", "citeseer",
                 "chameleon", "film", "squirrel", "Dblp", "pubmed",
                 "Electronics", "bgp"]


def main(argv=None):
    ap = add_common_args(argparse.ArgumentParser(description="protocol sweep"))
    ap.add_argument("names", nargs="*", default=None)
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args(argv)
    names = args.names or DEFAULT_ORDER

    from ..run import main as run_main

    summary = {}
    os.makedirs(args.results_dir, exist_ok=True)
    for name in names:
        h = HYPERS.get(name, {})
        cli = ["-data", name, "-e", str(args.epochs), "-r", str(args.rounds),
               "-hid", str(h.get("hid", 64)), "-pr", args.data_root,
               "--results-dir", args.results_dir]
        if args.device:
            cli += ["--device", args.device]
        if "microbatch" in h:
            cli += ["--microbatch", str(h["microbatch"])]
        t0 = time.time()
        try:
            run_main(cli)
            summary[name] = {"ok": True, "seconds": time.time() - t0}
        except Exception as e:  # keep going; record the failure
            summary[name] = {"ok": False, "error": repr(e)[:300],
                             "seconds": time.time() - t0}
        print(f"== {name}: {summary[name]}", flush=True)
        with open(os.path.join(args.results_dir, "protocol_all_status.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
