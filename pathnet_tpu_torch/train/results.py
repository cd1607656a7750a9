"""Result aggregation and reference-format logging (port of
``pathnet_tpu/train/results.py:19-66``).

The reference appends a line per run to ``results/result_for_<name>.txt``
with the full arg dump followed by
``<mode> Avg for <name>: acc.. ± ..  prec.. ± ..  rec.. ± ..  maf1.. ± ..
mif1.. ± ..`` (PathNet_run.py:476-485).  We emit the same human-readable
line (diffable against reference logs) plus a structured JSONL record.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def aggregate_rounds(results) -> Dict[str, Tuple[float, float]]:
    """mean/std (population std, matching np.std in PathNet_run.py:470-474)
    of the five metrics across rounds."""
    agg = {}
    for key in ("accuracy", "macro_precision", "macro_recall", "macro_f1",
                "micro_f1"):
        vals = np.array([r.metrics[key] for r in results])
        agg[key] = (float(vals.mean()), float(vals.std()))
    return agg


def format_result_line(name: str, agg: Dict[str, Tuple[float, float]],
                       mode: str = "pathnet") -> str:
    """The reference's result line format (PathNet_run.py:479-481)."""
    a, pa = agg["accuracy"]
    p, pp = agg["macro_precision"]
    r, pr = agg["macro_recall"]
    f1, pf1 = agg["macro_f1"]
    f2, pf2 = agg["micro_f1"]
    return (f"{mode} Avg for {name}: acc{a:.4f} ± {pa:.4f}\t "
            f"prec{p:.4f} ± {pp:.4f}\t rec{r:.4f} ± {pr:.4f}\t "
            f"maf1{f1:.4f} ± {pf1:.4f}\t mif1{f2:.4f} ± {pf2:.4f}\t ")


def append_results(results_dir: str, name: str, agg, config: dict,
                   mode: str = "pathnet") -> str:
    """Append the text line + a JSONL record; returns the text line."""
    os.makedirs(results_dir, exist_ok=True)
    line = format_result_line(name, agg, mode)
    with open(os.path.join(results_dir, f"result_for_{name}.txt"), "a") as f:
        for k, v in config.items():
            f.write(f"{k}: {v}\n")
        f.write(line + "\n")
    device = (torch.cuda.get_device_name(0)
              if config.get("device") != "cpu" and torch.cuda.is_available()
              else "cpu")
    rec = {"ts": time.time(), "name": name, "config": config,
           "device": device,
           "metrics": {k: {"mean": m, "std": s} for k, (m, s) in agg.items()}}
    with open(os.path.join(results_dir, "results.jsonl"), "a") as f:
        f.write(json.dumps(rec) + "\n")
    return line
