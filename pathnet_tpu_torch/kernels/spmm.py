"""S1 ``spmm`` and S2 ``edge_dot``: the baseline zoo's message passing over a CSR.

Replace the XLA ops of ``pathnet_tpu/models/baselines/ops.py:68-73``
(``spmm``: gather ``h[src]``, scale by the edge weight, ``segment_sum`` into
``dst``), the per-head message sums of GAT, GATJK and FAGCN
(``zoo.py:330-331``, ``:450-452``, ``:390-391``) and their VJPs.

:func:`spmm` is ``out[i, k, :] = sum over row i of w[perm[j], k] *
h[col[j], k, :]`` for ``h`` ``[*, heads * hdim]`` and ``w [E, heads]`` (None:
a weight of 1), over a CSR ``(ptr, perm, col)``: ``perm`` the edge ids in
row order, ``col`` the node each brings. On the destination-sorted CSR
(``col = src[perm]``) it is ``Â h``; on the source-sorted one (``col =
dst[perm]``) the transpose, which gives the input gradient; with ``col =
perm`` and no ``w`` it sums edge rows by node, the VJP of a gather by edge.
:func:`edge_dot` is ``dw[e, k] = <g[dst_e, k, :], h[src_e, k, :]>``, the
gradient of the edge weights. Source ``pathnet_tpu_torch/csrc/spmm.cu``: a
group of lanes a row (S1) or an edge (S2), sized from the row's width as
``walk_dists`` sizes its lanes, float4 loads where the head's width allows;
each row's edges in CSR order, so every sum has one fixed order, no atomics,
and two calls give the same bits. Bound on the H100: bytes, ``h`` (S2: ``g``
and ``h``) read once, the CSR and ``w``, the output written once, over
3.35 TB/s.

The plain versions sum in the same order on the CPU (``index_add_`` adds one
row after another); on the card their ``index_add_`` adds with atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build


def csr_rows(ptr: torch.Tensor) -> torch.Tensor:
    """int64 ``[E]``: the row of each CSR position."""
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   torch.diff(ptr.long()))


def spmm_plain(h: torch.Tensor, w: Optional[torch.Tensor], ptr: torch.Tensor,
               perm: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm` (``index_select``, multiply,
    ``index_add_`` in CSR order)."""
    n, F = ptr.shape[0] - 1, h.shape[1]
    msgs = h.index_select(0, col.long())
    if w is not None:
        heads = w.shape[1]
        we = w.index_select(0, perm.long())
        msgs = (msgs.view(-1, heads, F // heads) * we[:, :, None]).view(-1, F)
    return h.new_zeros((n, F)).index_add_(0, csr_rows(ptr), msgs)


def edge_dot_plain(g: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_dot`."""
    F = h.shape[1]
    ge = g.index_select(0, dst.long()).view(-1, heads, F // heads)
    he = h.index_select(0, src.long()).view(-1, heads, F // heads)
    return (ge * he).sum(-1)


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def spmm(h: torch.Tensor, w: Optional[torch.Tensor], ptr: torch.Tensor, perm: torch.Tensor,
         col: torch.Tensor) -> torch.Tensor:
    """``float32 [n, F]`` for ``h`` float32 ``[m, F]``, ``w`` float32 ``[E,
    heads]`` (``heads`` divides ``F``) or None, ``ptr`` int32 ``[n + 1]``,
    ``perm`` and ``col`` int32 ``[E]`` (``perm`` in ``[0, E)``, ``col`` in
    ``[0, m)``, as :class:`~pathnet_tpu_torch.models.baselines.ops.EdgeGraph`
    builds them)."""
    dev = _device(h, "spmm")
    build.require(h, "h", torch.float32, (None, None), dev)
    F = h.shape[1]
    build.require(ptr, "ptr", torch.int32, (None,), dev)
    build.require(perm, "perm", torch.int32, (None,), dev)
    E = perm.shape[0]
    build.require(col, "col", torch.int32, (E,), dev)
    heads = 1
    if w is not None:
        build.require(w, "w", torch.float32, (E, None), dev)
        heads = w.shape[1]
        if heads == 0 or F % heads:
            raise ValueError(f"spmm: {heads} heads do not divide F = {F}")
    if dev.type == "cpu":
        return spmm_plain(h, w, ptr, perm, col)
    n = ptr.shape[0] - 1
    out = torch.empty((n, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_spmm(h.data_ptr(), None if w is None else w.data_ptr(),
                                          ptr.data_ptr(), perm.data_ptr(), col.data_ptr(),
                                          out.data_ptr(), n, F, heads, build.stream_ptr(h))
    build.check(rc, "spmm")
    spmm.launches += 1
    return out


def edge_dot(g: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             heads: int) -> torch.Tensor:
    """``float32 [E, heads]``: ``<g[dst_e, k, :], h[src_e, k, :]>`` for ``g``
    float32 ``[n, F]``, ``h`` float32 ``[m, F]`` (``heads`` divides ``F``),
    ``src`` (in ``[0, m)``) and ``dst`` (in ``[0, n)``) int32 ``[E]``."""
    dev = _device(h, "edge_dot")
    build.require(h, "h", torch.float32, (None, None), dev)
    F = h.shape[1]
    build.require(g, "g", torch.float32, (None, F), dev)
    build.require(src, "src", torch.int32, (None,), dev)
    E = src.shape[0]
    build.require(dst, "dst", torch.int32, (E,), dev)
    if heads <= 0 or F % heads:
        raise ValueError(f"edge_dot: {heads} heads do not divide F = {F}")
    if dev.type == "cpu":
        return edge_dot_plain(g, h, src, dst, heads)
    out = torch.empty((E, heads), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_edge_dot(g.data_ptr(), h.data_ptr(), src.data_ptr(),
                                              dst.data_ptr(), out.data_ptr(), E, F, heads,
                                              build.stream_ptr(h))
    build.check(rc, "edge_dot")
    edge_dot.launches += 1
    return out


spmm.launches = 0
edge_dot.launches = 0
