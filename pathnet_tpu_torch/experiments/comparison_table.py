"""One column of the paper's comparison table (counterpart of
``scripts/comparison_table.py``; SURVEY.md §6.1): PathNet and every model of
the baseline zoo on one dataset, mean ± std test accuracy over rounds.

    python -m pathnet_tpu_torch.experiments.comparison_table cornell [rounds] [epochs]

Writes ``<results-dir>/comparison_<name>.json`` after each model, with the
JAX script's keys (``dataset``, ``rounds``, ``epochs``, ``platform``,
``payload``, ``ts``, ``seeded``, ``accuracy``: ``{model: [mean, std]}``).

- **Resume**: an artifact whose platform, rounds, epochs and payload
  fingerprint all match keeps its models; any other is discarded, so every
  column is held to the current payload (the JAX tables mix payloads).
- **Seeding**: PathNet and ``mlp`` are taken from the latest row of
  ``<results-dir>/results.jsonl`` (the CLI's record) of the same dataset,
  payload, platform and protocol (at least these rounds and epochs; the
  reference configuration's nw 40, wl 4, LSTM, attention, MERW walks, no
  quirk), with that row's own configuration under ``seeded``; otherwise they
  run here.
- **Completeness**: a model that raises is reported and the column goes on;
  the runner exits with code 3 when any column is missing, so a rerun
  completes the remnant.

Each baseline round: ``load_dataset(name, data_root, r)``, H = 64, seed
``r``, full batch (``train.baseline_trainer.run_baseline_round``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from . import add_common_args


def row_platform(device: str):
    """The torch device type of a ``results.jsonl`` row's ``device`` (the
    card's name, or "cpu"); None for rows of other platforms."""
    d = (device or "").lower()
    if d == "cpu":
        return "cpu"
    if "nvidia" in d:
        return "cuda"
    return None


def protocol_row(results_dir, name, model, fp, rounds, epochs, platform):
    """``((mean, std), config)`` of the latest matching CLI row, or None."""
    best = None
    try:
        with open(os.path.join(results_dir, "results.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                c = rec.get("config", {})
                if (rec.get("name") == name
                        and c.get("model", "pathnet") == model
                        and not c.get("quirk_compat")
                        and c.get("payload") == fp
                        and c.get("round", 0) >= rounds
                        and c.get("epoch", 0) >= epochs
                        and c.get("agg", "attention") == "attention"
                        and c.get("rnn", "lstm") == "lstm"
                        and c.get("num_of_walks", 40) == 40
                        and c.get("walk_length", 4) == 4
                        and c.get("marker", "merw") == "merw"
                        and row_platform(rec.get("device")) == platform):
                    a = rec["metrics"]["accuracy"]
                    best = ((a["mean"], a["std"]),
                            {k: c.get(k) for k in ("hidden_size", "num_of_walks", "dropout",
                                                   "dtype", "round", "epoch")})
    except FileNotFoundError:
        pass
    return best


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description="comparison-table column"))
    p.add_argument("name", nargs="?", default="cornell")
    p.add_argument("rounds", nargs="?", type=int, default=10)
    p.add_argument("epochs", nargs="?", type=int, default=500)
    args = p.parse_args(argv)

    from ..config import TrainConfig
    from ..data.registry import DATASETS, load_dataset, payload_fingerprint
    from ..device import resolve_device
    from ..models.baselines import BASELINES, BaselineSpec
    from ..train import run_protocol
    from ..train.baseline_trainer import run_baseline_round
    from ..train.results import aggregate_rounds

    dev = resolve_device(args.device)
    name, rounds, epochs = args.name, args.rounds, args.epochs
    spec_d = DATASETS[name]
    fp = payload_fingerprint(spec_d)
    cfg = TrainConfig(epochs=epochs, rounds=rounds)
    out_path = os.path.join(args.results_dir, f"comparison_{name}.json")
    os.makedirs(args.results_dir, exist_ok=True)
    done, seeded_cfg = {}, {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        if (prev.get("platform") == dev.type and prev.get("rounds") == rounds
                and prev.get("epochs") == epochs and prev.get("payload") == fp):
            done = prev.get("accuracy", {})
            seeded_cfg = dict(prev.get("seeded", {}))
        else:
            print(f"resume: discarding stale artifact (platform={prev.get('platform')} "
                  f"rounds={prev.get('rounds')} epochs={prev.get('epochs')} "
                  f"payload={prev.get('payload')} vs current {dev.type}/{rounds}/{epochs}/{fp})",
                  file=sys.stderr)
    rows = [(m, tuple(v)) for m, v in done.items()]

    def flush():
        with open(out_path, "w") as f:
            json.dump({"dataset": name, "rounds": rounds, "epochs": epochs,
                       "platform": dev.type, "payload": fp, "ts": time.time(),
                       "seeded": seeded_cfg,
                       "accuracy": {m: [v[0], v[1]] for m, v in rows}}, f, indent=2)

    def seeded(model):
        row = protocol_row(args.results_dir, name, model, fp, rounds, epochs, dev.type)
        if row is None:
            return None
        seeded_cfg[model] = row[1]
        print(f"...{model} seeded from protocol row", file=sys.stderr)
        return row[0]

    failed = {}
    if "PathNet" not in done:
        acc = seeded("pathnet")
        if acc is None:
            agg, _ = run_protocol(name, data_root=args.data_root, cfg=cfg, verbose=False,
                                  device=dev)
            acc = agg["accuracy"]
        rows.append(("PathNet", acc))
        flush()
    for model in BASELINES:
        if model in done:
            continue
        if model == "mlp":
            acc = seeded("mlp")
            if acc is not None:
                rows.append(("mlp", acc))
                flush()
                continue
        try:
            results = []
            for round_i in range(rounds):
                g, tr, va, te, _ = load_dataset(name, args.data_root, round_i)
                spec = BaselineSpec(name=model, feat_dim=g.features.shape[1], hidden=64,
                                    out_dim=spec_d.num_classes, n_nodes=g.n)
                results.append(run_baseline_round(g, spec, cfg, tr, va, te,
                                                  spec_d.num_classes, seed=round_i,
                                                  device=dev))
        except Exception as e:   # report it, finish the column, exit 3 below
            traceback.print_exc()
            failed[model] = repr(e)[:300]
            continue
        rows.append((model, aggregate_rounds(results)["accuracy"]))
        flush()
        print(f"...{model} done", file=sys.stderr)

    print(f"\n=== {name}: test accuracy % (mean ± std over {rounds} rounds,"
          f" {epochs} epochs) ===")
    for model, (m, s) in rows:
        print(f"{model:12s} {100 * m:6.2f} ± {100 * s:.2f}")
    have = {m for m, _ in rows}
    expected = {"PathNet"} | set(BASELINES)
    missing = sorted(expected - have)
    if missing:
        print(f"INCOMPLETE column {name}: missing {missing} ({failed})", file=sys.stderr)
        sys.exit(3)
    print(f"column {name} complete: {len(have)}/{len(expected)} models")
    return dict(rows)


if __name__ == "__main__":
    main()
