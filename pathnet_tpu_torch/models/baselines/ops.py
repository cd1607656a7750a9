"""Sparse graph ops of the baseline zoo (port of ``pathnet_tpu/models/baselines/ops.py``).

:class:`EdgeGraph` builds Â on the host exactly as JAX does (``src``,
``dst``, ``w`` in scipy's COO order, equal to JAX's arrays) and, once per
graph, the two CSR orders the kernels walk: the edges stably sorted by
destination (rows of ``Â h``) and by source (rows of the transpose, the
input gradient). :func:`spmm` and :func:`segment_softmax` are autograd
functions over kernels S1-S4 (``kernels/spmm.py``,
``kernels/segment_softmax.py``): the forward of ``spmm`` is S1 on the
destination CSR, its backward S1 on the source CSR for ``dh`` and S2 for
the edge weights' gradient; the softmax's backward is S4. :func:`gather_edges`
is ``x[src]`` or ``x[dst]`` whose backward sums the edge rows by node with
S1 (``index_select``'s backward would add them with atomics on the card), so
a seeded round is bit-reproducible there. :class:`BatchNorm` is JAX's
``BatchNormCtx`` as a module: the running statistics are buffers.

Under bf16 compute each op takes the kernel instance of its operands'
dtypes, as JAX promotes them: ``spmm`` of a bf16 ``h`` with the graph's f32
weights is S1 with bf16 rows and an f32 output, and its input gradient the
per-add bf16 S1 of f32 terms; bf16 messages with bf16 weights (GAT) are the
all-bf16 S1, their weights' gradient the bf16 S2; a bf16 softmax is the bf16
S3 and S4; a gather of bf16 rows sums its gradient with the bf16 S1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ...data.graph import Graph
from ...device import resolve_device
from ...kernels import segment_softmax as k_segment_softmax
from ...kernels import segment_softmax_bwd as k_segment_softmax_bwd
from ...kernels import edge_dot as k_edge_dot
from ...kernels import spmm as k_spmm


def _csr(key: np.ndarray, other: np.ndarray, n: int):
    """``(ptr, perm, col)``: the edges stably sorted by ``key``, the row
    pointers, and ``other`` of each edge in that order."""
    perm = np.argsort(key, kind="stable").astype(np.int32)
    ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(key, minlength=n), out=ptr[1:])
    return ptr, perm, other[perm]


@dataclasses.dataclass
class EdgeGraph:
    """Â as an edge list (JAX's order) on a device, with both CSR orders."""

    n: int
    src: torch.Tensor      # int32 [E]
    dst: torch.Tensor      # int32 [E]
    w: torch.Tensor        # float32 [E]
    dst_ptr: torch.Tensor  # int32 [n + 1]: rows = destinations
    dst_perm: torch.Tensor  # int32 [E]: edge ids by destination, stable
    dst_col: torch.Tensor  # int32 [E]: src[dst_perm]
    src_ptr: torch.Tensor  # int32 [n + 1]: rows = sources
    src_perm: torch.Tensor  # int32 [E]
    src_col: torch.Tensor  # int32 [E]: dst[src_perm]

    @staticmethod
    def from_graph(g: Graph, norm: str = "sym", add_self_loops: bool = True,
                   device: Optional[Union[str, torch.device]] = None) -> "EdgeGraph":
        """Build Â from a host Graph (``ops.py:32-56``).

        norm: "sym" = D^-1/2 (A [+I]) D^-1/2 (GCN), "rw" = D^-1 (A [+I]),
        "none" = raw binary.
        """
        a = g.to_adjacency(binary=True)
        a = a.maximum(a.T)
        if add_self_loops:
            a = a + sp.eye(g.n, format="csr")
            a.data = np.minimum(a.data, 1.0)
        coo = a.tocoo()
        src = coo.row.astype(np.int32)
        dst = coo.col.astype(np.int32)
        deg = np.asarray(a.sum(axis=1)).ravel()
        if norm == "sym":
            dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
            w = dinv[src] * dinv[dst]
        elif norm == "rw":
            w = 1.0 / np.maximum(deg[src], 1.0)
        else:
            w = np.ones(len(src))
        dev = resolve_device(device)
        arrays = (src, dst, np.asarray(w, np.float32), *_csr(dst, src, g.n),
                  *_csr(src, dst, g.n))
        return EdgeGraph(g.n, *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                for a in arrays))

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]


class _Spmm(torch.autograd.Function):
    """S1 forward on the destination CSR; backward S1 on the source CSR
    (``dh``) and S2 (``dw``)."""

    @staticmethod
    def forward(ctx, h, w, eg):
        ctx.eg = eg
        ctx.save_for_backward(h, w)
        return k_spmm(h, w, eg.dst_ptr, eg.dst_perm, eg.dst_col)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        eg = ctx.eg
        g = g.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            # a bf16 h under f32 weights: each f32 term rounded, a bf16 sum
            dh = k_spmm(g, w, eg.src_ptr, eg.src_perm, eg.src_col, out_dtype=h.dtype)
        if ctx.needs_input_grad[1]:
            dw = k_edge_dot(g, h, eg.src, eg.dst, w.shape[1]).to(w.dtype)
        return dh, dw, None


def spmm(eg: EdgeGraph, h: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``Â @ h`` (``ops.py:68-73``) for ``h [n, F]``, or the per-head message
    sum for ``h [n, heads, hdim]`` with ``w [E, heads]``; ``w`` None takes
    the graph's weights."""
    weights = eg.w if w is None else w
    w2 = weights.reshape(weights.shape[0], -1).contiguous()
    out = _Spmm.apply(h.reshape(h.shape[0], -1).contiguous(), w2, eg)
    return out.reshape((eg.n,) + tuple(h.shape[1:]))


class _SegmentSoftmax(torch.autograd.Function):
    """S3 forward, S4 backward."""

    @staticmethod
    def forward(ctx, s, eg):
        a = k_segment_softmax(s, eg.dst_ptr, eg.dst_perm)
        ctx.eg = eg
        ctx.save_for_backward(a)
        return a

    @staticmethod
    def backward(ctx, da):
        (a,) = ctx.saved_tensors
        eg = ctx.eg
        return k_segment_softmax_bwd(a, da.contiguous(), eg.dst_ptr, eg.dst_perm), None


def segment_softmax(eg: EdgeGraph, scores: torch.Tensor) -> torch.Tensor:
    """Softmax of edge scores ``[E]`` or ``[E, heads]`` over each
    destination (``ops.py:76-82``, per head as ``zoo.py:327-328`` vmaps it)."""
    s2 = scores.reshape(scores.shape[0], -1).contiguous()
    return _SegmentSoftmax.apply(s2, eg).reshape(scores.shape)


class _GatherEdges(torch.autograd.Function):
    """``x[idx]`` for an endpoint ``idx`` of every edge; the backward sums
    the edge rows by node over that endpoint's CSR with S1 (no weights)."""

    @staticmethod
    def forward(ctx, x, idx, ptr, perm):
        ctx.save_for_backward(ptr, perm)
        return x.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, g):
        ptr, perm = ctx.saved_tensors
        return k_spmm(g.contiguous(), None, ptr, perm, perm), None, None, None


def gather_edges(eg: EdgeGraph, x: torch.Tensor, side: str) -> torch.Tensor:
    """``x[eg.src]`` (``side="src"``) or ``x[eg.dst]`` for ``x [n, F]``,
    rows in the edge list's order."""
    if side == "src":
        return _GatherEdges.apply(x, eg.src, eg.src_ptr, eg.src_perm)
    return _GatherEdges.apply(x, eg.dst, eg.dst_ptr, eg.dst_perm)


class BatchNorm(nn.Module):
    """JAX's ``BatchNormCtx`` (``ops.py:94-138``) for one layer: torch
    ``BatchNorm1d`` semantics with the running statistics as buffers.

    Train mode normalizes with the batch statistics (biased variance,
    ``ops.py:85-91``) and advances ``running_mean`` and ``running_var``
    (momentum 0.1, unbiased variance); eval mode normalizes with them. The
    parameters keep JAX's names, ``scale`` and ``bias``.

    ``cast`` gives the parameters in the compute dtype (bf16: rounded
    copies). The statistics and the normalization are f32, on f32 copies of
    the cast parameters, and the output takes ``h``'s dtype, as
    ``BatchNormCtx`` does; ``stateless`` with a bf16 ``h`` normalizes as
    JAX's stateless ``batch_norm`` (``ops.py:85-91``) does instead, op by op
    in bf16 (the running statistics still advance from the f32 ones).
    """

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, h: torch.Tensor, train: bool, cast=None, stateless: bool = False
                ) -> torch.Tensor:
        scale, bias = self.scale, self.bias
        if cast is not None:
            scale, bias = cast(scale), cast(bias)
        h32 = h.float()
        if train:
            mu = h32.mean(dim=0)
            var = h32.var(dim=0, unbiased=False)
            with torch.no_grad():
                rows = h.shape[0]
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mu)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * (rows / max(rows - 1, 1))))
        else:
            mu, var = self.running_mean, self.running_var
        if stateless and h.dtype == torch.bfloat16:
            mu = h.mean(dim=0, keepdim=True)
            var = h.var(dim=0, unbiased=False, keepdim=True)
            return (h - mu) * torch.rsqrt(var + weak(self.eps, h)) * scale + bias
        out = (h32 - mu) * torch.rsqrt(var + self.eps) * scale.float() + bias.float()
        return out.to(h.dtype)


def weak(c: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak type takes it beside ``like``: rounded
    to bf16 for a bf16 tensor (0.3 becomes 0.30078125), else as it is."""
    return float(torch.tensor(c, dtype=torch.bfloat16)) if like.dtype == torch.bfloat16 else c
