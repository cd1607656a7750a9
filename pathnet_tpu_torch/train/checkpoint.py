"""Checkpoint / resume with ``torch.save`` (port of ``pathnet_tpu/train/checkpoint.py:22-57``).

The JAX package's directory layout, ``<ckpt_dir>/<name>/round_<iii>/``: each
round directory holds ``meta.json`` (round, best validation accuracy, test
metrics at the best epoch, config) and, when the round kept them, the best
parameters as a ``state_dict`` in ``best.pt``. A protocol that finds a
round's checkpoint skips the round and takes its metrics. A round directory
without ``meta.json`` (the JAX package's orbax layout, under the same key) is
not a checkpoint of this package: it counts as absent, and ``save_round``
leaves it as it is and saves nothing there.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import torch


def _round_dir(ckpt_dir: str, name: str, round_i: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, name, f"round_{round_i:03d}"))


def save_round(ckpt_dir: str, name: str, round_i: int, result,
               config: Optional[dict] = None) -> Optional[str]:
    """Persist a round's best params + metrics; returns the directory, or
    None (with a warning) where another package's round directory stands."""
    path = _round_dir(ckpt_dir, name, round_i)
    if os.path.isdir(path) and not os.path.isfile(os.path.join(path, "meta.json")):
        warnings.warn(f"{path} holds a checkpoint of another package; this round "
                      "is not saved")
        return None
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"round": round_i, "best_val_acc": result.best_val_acc,
            "metrics": result.metrics, "config": config or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if result.best_params is not None:
        torch.save({k: v.detach().cpu() for k, v in result.best_params.items()},
                   os.path.join(tmp, "best.pt"))
    if os.path.isdir(path):
        for f in os.listdir(path):
            os.remove(os.path.join(path, f))
        os.rmdir(path)
    os.replace(tmp, path)
    return path


def load_round(ckpt_dir: str, name: str, round_i: int) -> Optional[Dict[str, Any]]:
    """``{"meta": ..., "params": state_dict or None}``; None if absent or if
    the round directory holds no ``meta.json``."""
    path = _round_dir(ckpt_dir, name, round_i)
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isfile(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    best = os.path.join(path, "best.pt")
    params = torch.load(best, weights_only=True) if os.path.isfile(best) else None
    return {"meta": meta, "params": params}


def completed_rounds(ckpt_dir: str, name: str) -> int:
    """Number of consecutive rounds from 0 saved by this package (each
    round directory holds a ``meta.json``)."""
    i = 0
    while os.path.isfile(os.path.join(_round_dir(ckpt_dir, name, i), "meta.json")):
        i += 1
    return i
