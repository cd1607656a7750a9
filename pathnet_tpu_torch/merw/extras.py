"""MERW companion utilities (port of ``pathnet_tpu/merw/extras.py``;
reference: preprocess/compute_merw.py:170-270).

Unused by the PathNet pipeline, but part of the module's surface: the
generic random walk's transitions, MERW and basic SimRank, and the P-distance
resolvent. As in the JAX package they are dense ``[n, n]`` products for small
graphs, here ``torch.matmul`` and ``torch.linalg.inv`` on ``device`` (``None``:
the CUDA card) in ``dtype`` (float32 by default, as JAX's; a host caller may
ask for float64). The products run as PyTorch ships them:
``torch.backends.cuda.matmul.allow_tf32`` is False by default, so a float32
product on the card is a full float32 product, not TF32.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..data.graph import Graph
from ..device import resolve_device

Device = Optional[Union[str, torch.device]]


def _dense_adjacency(g: Graph, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(g.to_adjacency(binary=True).toarray()).to(dev, dtype)


def _simrank(w: torch.Tensor, alpha: float, iters: int) -> torch.Tensor:
    """S <- alpha * W S W^T with a unit diagonal, from the identity."""
    n = w.shape[0]
    s = torch.eye(n, dtype=w.dtype, device=w.device)
    for _ in range(iters):
        s = alpha * (w @ s @ w.T)
        s.fill_diagonal_(1.0)
    return s


def compute_grw(g: Graph, device: Device = None, dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic (degree-normalized) random walk: P = D^-1 A and its
    stationary distribution deg/sum(deg) (compute_merw.py:170-176)."""
    a = _dense_adjacency(g, resolve_device(device), dtype)
    deg = a.sum(dim=1)
    p = a / torch.clamp(deg[:, None], min=1.0)
    pi = deg / torch.clamp(deg.sum(), min=1.0)
    return p, pi


def merw_simrank(g: Graph, alpha: float = 0.8, iters: int = 20, device: Device = None,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """MERW-SimRank fixed point (compute_merw.py:179-202 semantics):

    S = alpha/lambda^2 * D(psi) A D(psi)^-1 S D(psi)^-1 A D(psi) with unit
    diagonal, iterated from identity; ``(psi, lambda)`` from the port's
    power iteration (``merw.principal_eigenpair``) on ``device``.
    """
    from .merw import principal_eigenpair

    dev = resolve_device(device)
    a = _dense_adjacency(g, dev, dtype)
    psi, lam = principal_eigenpair(g, dtype=dtype, device=dev)
    psi = torch.clamp(psi, min=1e-12)
    # W[u,v] = A[u,v] psi_v / (lambda psi_u)  (the MERW transition matrix)
    w = a * psi[None, :] / (float(lam) * psi[:, None])
    return _simrank(w, alpha, iters)


def basic_simrank(g: Graph, alpha: float = 0.8, iters: int = 20, device: Device = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain SimRank (compute_merw.py:205-224 semantics) via the matrix
    form S = alpha * Pn S Pn^T with unit diagonal, Pn = row-normalized A."""
    a = _dense_adjacency(g, resolve_device(device), dtype)
    pn = a / torch.clamp(a.sum(dim=1, keepdim=True), min=1.0)
    return _simrank(pn, alpha, iters)


def p_distance(p: torch.Tensor, alpha: float = 0.8) -> torch.Tensor:
    """Resolvent (I - alpha P)^-1 (compute_merw.py:267-270), on ``p``'s device."""
    n = p.shape[0]
    return torch.linalg.inv(torch.eye(n, dtype=p.dtype, device=p.device) - alpha * p)
