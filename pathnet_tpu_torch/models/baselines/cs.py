"""Correct & Smooth post-processing and label propagation (port of
``pathnet_tpu/models/baselines/cs.py``): iterated S1 ``spmm`` with the train
rows clamped to their labels."""
from __future__ import annotations

import torch

from .ops import EdgeGraph, spmm


def label_propagation(eg: EdgeGraph, y_onehot: torch.Tensor, train_mask: torch.Tensor,
                      alpha: float = 0.9, iters: int = 50) -> torch.Tensor:
    """MultiLP: Z <- α Â Z + (1-α) Y0, train rows clamped to true labels."""
    m = train_mask[:, None]
    y0 = torch.where(m, y_onehot, 0.0)
    z = y0
    for _ in range(iters):
        z = alpha * spmm(eg, z) + (1 - alpha) * y0
        z = torch.where(m, y_onehot, z)
    return z


def correct_and_smooth(eg: EdgeGraph, soft: torch.Tensor, y_onehot: torch.Tensor,
                       train_mask: torch.Tensor, alpha1: float = 0.979,
                       alpha2: float = 0.756, iters: int = 50,
                       scale: float = 20.0) -> torch.Tensor:
    """Two-stage C&S (correct_smooth.py semantics).

    Correct: propagate train residuals E = Y - soft with Z <- α1 Â Z,
    rescale and add. Smooth: clamp train rows to labels and propagate with
    α2. Returns refined soft predictions.
    """
    m = train_mask[:, None]
    err = torch.where(m, y_onehot - soft, 0.0)
    z = err
    for _ in range(iters):
        z = alpha1 * spmm(eg, z) + (1 - alpha1) * err
    soft = soft + scale * z

    guess = torch.where(m, y_onehot, soft)
    z = guess
    for _ in range(iters):
        z = alpha2 * spmm(eg, z) + (1 - alpha2) * guess
        z = torch.where(m, y_onehot, z)
    return z
