"""Walk-length ablation on the paper's synthetic path-pattern task
(counterpart of ``scripts/ablation_pattern.py``).

    python -m pathnet_tpu_torch.experiments.ablation_pattern [--n 2000] [--rounds 3] \
        [--epochs 800] [--num-walks 80]

The graph is ``synthetic_graph(n, avg_deg=4, num_classes=2, feat_dim=8,
homophily=0.5, seed=7)``; a node's label is the argmax bitmask of parity
features along all its length-3 walks (``path_pattern_labels``, the
reference's gen_cora_syn.cpp), the four most frequent patterns kept and the
rest one class; the features are the node's own parity bit and seven noise
columns (``default_rng(0)``), so the label is recoverable only from walks of
length >= 3. Each of walk_len 2-5 trains ``rounds`` rounds of ``epochs``
epochs (``train.run_round``, split ``get_whole_mask(y, seed=r + 1)``, seed
``r``) on ``num_walks`` uniform walks, H = 64, the sum readout, dropout 0.3.
Writes ``<results-dir>/ablation_pattern.json`` after each length, with the
JAX script's keys (``n``, ``avg_deg``, ``num_classes``, ``rounds``,
``epochs``, ``num_walks``, ``agg``, ``lengths``: ``{wl: {mean, std}}``) and
``platform``, the torch device type, which the JAX artifact lacks; an
artifact is resumed, length by length, when its other keys, the platform
among them, match. The defaults are the JAX script's; smaller sizes serve
tests.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from . import add_common_args

LENGTHS = (2, 3, 4, 5)


def pattern_graph(n: int, avg_deg: float = 4.0):
    """The task's graph, labels (top-4 patterns + rest) and class count."""
    from ..data import Graph
    from ..data.synthetic import path_pattern_labels, synthetic_graph

    base = synthetic_graph(n=n, avg_deg=avg_deg, num_classes=2, feat_dim=8,
                           homophily=0.5, seed=7)
    y = path_pattern_labels(base, walk_len=3)
    # collapse rare patterns so classes are learnable (the reference keeps
    # all 16; small graphs leave most empty)
    uniq, counts = np.unique(y, return_counts=True)
    keep = uniq[np.argsort(counts)[::-1][:4]]
    remap = {int(p): i for i, p in enumerate(keep)}
    y = np.array([remap.get(int(v), len(keep)) for v in y], np.int64)
    C = len(keep) + 1
    rng = np.random.default_rng(0)
    # features: the node's OWN parity bit + noise: the walk patterns that
    # define the label are invisible without path aggregation
    x = np.concatenate([(np.arange(n) % 2)[:, None].astype(np.float32),
                        rng.normal(0, 1, (n, 7)).astype(np.float32)], 1)
    g = Graph(n=n, src=base.src, dst=base.dst, prob=base.prob,
              features=x, labels=y, name="path_pattern")
    return g, C


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description="path-pattern ablation"))
    p.add_argument("--n", type=int, default=2000)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--epochs", type=int, default=800)
    p.add_argument("--num-walks", type=int, default=80)
    args = p.parse_args(argv)

    import torch

    from ..config import TrainConfig
    from ..data.splits import get_whole_mask
    from ..device import resolve_device
    from ..models import PaggSpec
    from ..sample import PathSampler
    from ..train import run_round

    dev = resolve_device(args.device)
    n, avg_deg, rounds, epochs, num_walks = args.n, 4.0, args.rounds, args.epochs, args.num_walks
    g, C = pattern_graph(n, avg_deg)
    X = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    out = {"n": n, "avg_deg": avg_deg, "num_classes": int(C),
           "rounds": rounds, "epochs": epochs, "num_walks": num_walks,
           "agg": "sum", "platform": dev.type, "lengths": {}}
    out_path = os.path.join(args.results_dir, "ablation_pattern.json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        if all(prev.get(k) == v for k, v in out.items() if k != "lengths"):
            out["lengths"] = prev.get("lengths", {})
    for wl in LENGTHS:
        if str(wl) in out["lengths"] or wl in out["lengths"]:
            continue
        ps = PathSampler.build(g, num_walks=num_walks, walk_len=wl, kind="uniform",
                               device=dev)
        # sum aggregation: the label is the argmax of a walk-pattern
        # histogram, a sum over per-walk pattern detectors (the paper's
        # PathNet-Sum ablation row)
        spec = PaggSpec(feat_dim=8, hidden=64, out_dim=C, walk_len=wl,
                        variant="hetero", agg="sum", dropout=0.3)
        cfg = TrainConfig(epochs=epochs, rounds=rounds)
        accs = []
        for r in range(rounds):
            tr, va, te = get_whole_mask(g.labels, seed=r + 1)
            res = run_round(X, y, ps, spec, cfg, tr, va, te, num_classes=C, seed=r)
            accs.append(res.metrics["accuracy"])
        out["lengths"][wl] = {"mean": float(np.mean(accs)), "std": float(np.std(accs))}
        print(f"wl={wl}: {np.mean(accs):.4f} +/- {np.std(accs):.4f}", flush=True)
        os.makedirs(args.results_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
