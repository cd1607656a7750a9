"""Serving: ``predict``, ``make_sharded_predict`` and ``evaluate`` (port of
``pathnet_tpu/train/inference.py``).

Walks are sampled only for the requested nodes and resampled per call;
``num_ensemble > 1`` averages the class probabilities of independent walk
draws (a log-mean-exp of the log-probabilities). Per ensemble member the
path runs the sampler's one launch (K1's walks with K2's hop distances,
``walk_dists``, at ``walk_len <= 4``; with K7's, ``walk_khop_dists``, past
it; with the alias tables K8's walks, ``alias_walk_dists`` and
``alias_walk_khop_dists``), then K3 (encode) and K5 (the ego rows), once
each. :func:`make_sharded_predict` serves with ``X`` row-sharded over the
ranks of a grid, the rows coming through the sparse exchange.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..models.pagg import PathNet
from ..nn.metrics import classification_metrics, confusion_matrix
from ..sample.walk import PathSampler


def _as_index(idx, n: int, device: torch.device) -> torch.Tensor:
    idx = torch.as_tensor(idx).to(device=device, dtype=torch.int32).reshape(-1)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"node ids must lie in [0, {n})")
    return idx.contiguous()


@torch.no_grad()
def predict(model: PathNet, X: torch.Tensor, ps: PathSampler,
            generator: Optional[torch.Generator] = None, idx=None,
            num_ensemble: int = 1, u: Optional[torch.Tensor] = None,
            exchange=None) -> torch.Tensor:
    """Class log-probabilities ``[len(idx), C]`` (default: every node).

    The walks' uniforms come from ``generator`` (a generator on the sampler's
    device), or from ``u [num_ensemble, *ps.uniform_shape(len(idx) * nw)]``
    (``[num_ensemble, wl - 1, len(idx) * nw]`` with the CDF tables).
    ``exchange`` (JAX's ``gather_fn``) takes ``X`` as a rank's row block.
    """
    if num_ensemble < 1:
        raise ValueError("num_ensemble must be >= 1")
    n = ps.sampler.n
    dev = ps.device
    idx = (torch.arange(n, dtype=torch.int32, device=dev) if idx is None
           else _as_index(idx, n, dev))
    walkers = idx.shape[0] * ps.num_walks
    if u is None:
        if generator is None:
            raise ValueError("predict needs a generator or the uniforms u")
        u = torch.stack([ps.draw_uniforms(walkers, generator) for _ in range(num_ensemble)])
    if tuple(u.shape) != (num_ensemble, *ps.uniform_shape(walkers)):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected "
                         f"{(num_ensemble, *ps.uniform_shape(walkers))}")
    logps = []
    for e in range(num_ensemble):
        paths, dists = ps.sample(idx, u=u[e])
        logps.append(torch.log_softmax(model(X, paths, dists, idx, exchange=exchange),
                                       dim=-1))
    return torch.logsumexp(torch.stack(logps), dim=0) - math.log(num_ensemble)


def make_sharded_predict(grid, num_ensemble: int = 1):
    """Serving with graph-partitioned features (JAX's ``:50-78``): ``X`` stays
    row-sharded over the grid's data axis (each rank holds its block,
    ``parallel.mesh.shard_rows``), the request is the same on every rank, and
    the walk rows come through the ownership-keyed sparse exchange (an
    all-reduce of each rank's owned rows: communication grows with the
    request, not with n). Returns ``fn(model, X_block, ps, idx,
    generator=None, u=None) -> log-probs``, the same on every rank; each
    rank's ``generator`` must draw what the others' draw."""
    from ..parallel.mesh import FeatureExchange

    exchange = FeatureExchange(grid, "sparse_replicated")

    def fn(model: PathNet, X: torch.Tensor, ps: PathSampler, idx,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> torch.Tensor:
        return predict(model, X, ps, generator, idx, num_ensemble=num_ensemble, u=u,
                       exchange=exchange)

    return fn


@torch.no_grad()
def evaluate(model: PathNet, X: torch.Tensor, y: torch.Tensor, ps: PathSampler,
             generator: Optional[torch.Generator], mask: np.ndarray,
             num_classes: int, num_ensemble: int = 1,
             u: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The reference's five test metrics over the nodes of ``mask``."""
    idx = torch.as_tensor(np.flatnonzero(mask), dtype=torch.int32)
    logp = predict(model, X, ps, generator, idx, num_ensemble=num_ensemble, u=u)
    pred = logp.argmax(dim=-1)
    cm = confusion_matrix(y[idx.to(y.device).long()], pred, num_classes)
    return {k: float(v) for k, v in classification_metrics(cm).items()}
