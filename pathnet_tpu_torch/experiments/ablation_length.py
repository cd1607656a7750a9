"""Walk-length ablation (counterpart of ``scripts/ablation_length.py``; the
reference's draw_figs/length.py experiment).

    python -m pathnet_tpu_torch.experiments.ablation_length cornell [rounds] [epochs]

Runs the protocol (``train.run_protocol``) at walk_len 2, 3, 4 and 5 on one
dataset and writes ``<results-dir>/ablation_length_<name>.json`` after each
length: ``dataset``, ``rounds``, ``epochs``, ``platform``, ``payload``,
``ts`` and ``accuracy_by_len`` (``{wl: [mean, std]}``). An artifact is
resumed only when its rounds, epochs, platform and payload fingerprint all
match; one without a payload key is stale.
"""
from __future__ import annotations

import argparse
import json
import os
import time

from . import add_common_args

LENGTHS = (2, 3, 4, 5)


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description="walk-length ablation"))
    p.add_argument("name", nargs="?", default="cornell")
    p.add_argument("rounds", nargs="?", type=int, default=10)
    p.add_argument("epochs", nargs="?", type=int, default=1000)
    args = p.parse_args(argv)

    from ..config import TrainConfig
    from ..data.registry import DATASETS, payload_fingerprint
    from ..device import resolve_device
    from ..train import run_protocol

    dev = resolve_device(args.device)
    name, rounds, epochs = args.name, args.rounds, args.epochs
    cfg = TrainConfig(epochs=epochs, rounds=rounds)
    out_path = os.path.join(args.results_dir, f"ablation_length_{name}.json")
    fp = payload_fingerprint(DATASETS[name])
    prev = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            old = json.load(f)
        if (old.get("rounds") == rounds and old.get("epochs") == epochs
                and old.get("platform") == dev.type and old.get("payload") == fp):
            prev = {int(k): v for k, v in old.get("accuracy_by_len", {}).items()}
    rows = [(wl, m, s) for wl, (m, s) in sorted(prev.items())]

    def save():
        os.makedirs(args.results_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"dataset": name, "rounds": rounds, "epochs": epochs,
                       "platform": dev.type, "payload": fp, "ts": time.time(),
                       "accuracy_by_len": {wl: [m, s] for wl, m, s in rows}},
                      f, indent=2)

    for wl in LENGTHS:
        if wl in prev:
            continue
        agg, _ = run_protocol(name, data_root=args.data_root, cfg=cfg, walk_len=wl,
                              verbose=False, device=dev)
        m, s = agg["accuracy"]
        rows.append((wl, m, s))
        print(f"len={wl}: acc {100 * m:.2f} ± {100 * s:.2f}", flush=True)
        save()
    print("\nwalk_len | accuracy")
    for wl, m, s in rows:
        print(f"{wl:8d} | {100 * m:.2f} ± {100 * s:.2f}")
    save()
    return {wl: (m, s) for wl, m, s in rows}


if __name__ == "__main__":
    main()
