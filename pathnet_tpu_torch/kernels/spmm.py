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

The bf16 instances do what XLA does on the CPU under JAX's promotion
(``compute_dtype="bfloat16"``; the graph's weights stay float32). An f32
output is the f32 instance's arithmetic on the loaded values (bf16 rows
times f32 weights: ``spmm`` on a bf16 ``h``). A bf16 output rounds each
term ``w * h`` to bf16, then the sum after each add, one edge at a time in
edge order, as XLA's bf16 scatter-add does (measured bit for bit against
``jax.ops.segment_sum``): all-bf16 operands (GAT's messages and their
input gradient, a gather's VJP) or, with ``out_dtype=torch.bfloat16``, f32
ones (the input gradient of ``spmm`` on a bf16 ``h``: each f32 term
``g[dst] w`` rounded, then summed in bf16). A bf16 ``edge_dot`` rounds each
product and adds them one at a time over the head's width, as XLA's bf16
reduction does on the CPU up to 32 terms (past 32 it adds in an order of
its own, which no sequential or strided order reproduces).

The plain versions sum in the same order on the CPU: ``index_add_`` adds
one row after another in f32, and :func:`per_add_rows` adds a bf16 row at a
time (``index_add_`` on a bf16 tensor of more than one dimension sums in
f32 and rounds once); on the card their ``index_add_`` adds with atomics.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

BF16 = torch.bfloat16
F32 = torch.float32
# S1's instances: (h, w, out) dtypes, w None for a weight of 1
SPMM_INSTANCES = {(F32, F32, F32), (F32, None, F32), (BF16, F32, F32), (BF16, BF16, BF16),
                  (BF16, None, BF16), (F32, F32, BF16), (F32, None, BF16)}


def csr_rows(ptr: torch.Tensor) -> torch.Tensor:
    """int64 ``[E]``: the row of each CSR position."""
    n = ptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   torch.diff(ptr.long()))


def per_add_rows(terms: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """``[n, *]`` bf16: each CSR row of ``terms`` (bf16 ``[E, *]`` in CSR
    order) added one term at a time in that order, rounded to bf16 after
    every add; an empty row is 0. One add a step for every row still
    holding terms, the rows sorted by their length."""
    n = ptr.shape[0] - 1
    deg = torch.diff(ptr.long())
    acc = terms.new_zeros((n,) + tuple(terms.shape[1:]))
    if terms.shape[0] == 0:
        return acc
    order = torch.argsort(deg, descending=True, stable=True)
    start = ptr[:-1].long().index_select(0, order)
    # live[k]: the rows with more than k terms, a prefix of ``order``
    live = (n - torch.cumsum(torch.bincount(deg), 0)).tolist()
    for k in range(len(live) - 1):
        m = live[k]
        acc[:m] = acc[:m] + terms.index_select(0, start[:m] + k)
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def spmm_dtype(h: torch.Tensor, w: Optional[torch.Tensor],
               out_dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The output dtype of :func:`spmm`: ``out_dtype``, else JAX's promotion
    of ``h`` and ``w``."""
    if out_dtype is not None:
        return out_dtype
    return h.dtype if w is None else torch.promote_types(h.dtype, w.dtype)


def spmm_plain(h: torch.Tensor, w: Optional[torch.Tensor], ptr: torch.Tensor,
               perm: torch.Tensor, col: torch.Tensor,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`spmm` (``index_select``, multiply,
    ``index_add_`` in CSR order; a bf16 output: each term rounded, then
    :func:`per_add_rows`)."""
    n, F = ptr.shape[0] - 1, h.shape[1]
    dt = spmm_dtype(h, w, out_dtype)
    msgs = h.index_select(0, col.long())
    if w is not None:
        heads = w.shape[1]
        we = w.index_select(0, perm.long())
        msgs = (msgs.view(-1, heads, F // heads) * we[:, :, None]).view(-1, F)
    if dt == BF16:
        return per_add_rows(msgs.to(BF16), ptr)
    return msgs.new_zeros((n, F)).index_add_(0, csr_rows(ptr), msgs)


def edge_dot_plain(g: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`edge_dot` (bf16: the rounded products
    added one at a time over the head's width)."""
    F = h.shape[1]
    ge = g.index_select(0, dst.long()).view(-1, heads, F // heads)
    he = h.index_select(0, src.long()).view(-1, heads, F // heads)
    prod = ge * he
    if prod.dtype != BF16:
        return prod.sum(-1)
    acc = prod.new_zeros(prod.shape[:2])
    for d in range(prod.shape[2]):
        acc = acc + prod[:, :, d]
    return acc


def _device(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device


def _float(t: torch.Tensor, name: str, what: str) -> None:
    if t.dtype not in (F32, BF16):
        raise TypeError(f"{what}: {name} must be torch.float32 or torch.bfloat16, got {t.dtype}")


def spmm(h: torch.Tensor, w: Optional[torch.Tensor], ptr: torch.Tensor, perm: torch.Tensor,
         col: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``[n, F]`` for ``h`` ``[m, F]``, ``w`` ``[E, heads]`` (``heads``
    divides ``F``) or None, ``ptr`` int32 ``[n + 1]``, ``perm`` and ``col``
    int32 ``[E]`` (``perm`` in ``[0, E)``, ``col`` in ``[0, m)``, as
    :class:`~pathnet_tpu_torch.models.baselines.ops.EdgeGraph` builds them).

    The instances, by dtype (f32 float32, bf16 bfloat16): ``h`` f32 with
    ``w`` f32 or None, f32 out; ``h`` bf16 with ``w`` f32, f32 out; ``h``
    bf16 with ``w`` bf16 or None, bf16 out, per-add; ``h`` and ``w`` f32
    with ``out_dtype`` bf16, per-add. ``out_dtype`` defaults to the
    promotion of ``h`` and ``w``."""
    dev = _device(h, "spmm")
    _float(h, "h", "spmm")
    build.require(h, "h", h.dtype, (None, None), dev)
    F = h.shape[1]
    build.require(ptr, "ptr", torch.int32, (None,), dev)
    build.require(perm, "perm", torch.int32, (None,), dev)
    E = perm.shape[0]
    build.require(col, "col", torch.int32, (E,), dev)
    heads = 1
    if w is not None:
        _float(w, "w", "spmm")
        build.require(w, "w", w.dtype, (E, None), dev)
        heads = w.shape[1]
        if heads == 0 or F % heads:
            raise ValueError(f"spmm: {heads} heads do not divide F = {F}")
    dt = spmm_dtype(h, w, out_dtype)
    if (h.dtype, None if w is None else w.dtype, dt) not in SPMM_INSTANCES:
        raise TypeError(f"spmm: no instance for h {h.dtype}, w "
                        f"{None if w is None else w.dtype}, out {dt}")
    if dev.type == "cpu":
        return spmm_plain(h, w, ptr, perm, col, dt)
    n = ptr.shape[0] - 1
    out = torch.empty((n, F), dtype=dt, device=dev)
    types = int(h.dtype == BF16) | 2 * int(w is not None and w.dtype == BF16) | 4 * int(dt == BF16)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_spmm(h.data_ptr(), None if w is None else w.data_ptr(),
                                          ptr.data_ptr(), perm.data_ptr(), col.data_ptr(),
                                          out.data_ptr(), n, F, heads, types,
                                          build.stream_ptr(h))
    build.check(rc, "spmm")
    spmm.launches += 1
    return out


def edge_dot(g: torch.Tensor, h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             heads: int) -> torch.Tensor:
    """``[E, heads]``: ``<g[dst_e, k, :], h[src_e, k, :]>`` for ``g`` ``[n,
    F]``, ``h`` ``[m, F]`` (``heads`` divides ``F``), ``src`` (in ``[0,
    m)``) and ``dst`` (in ``[0, n)``) int32 ``[E]``. The instances: both
    float32 (f32 out), ``g`` float32 with ``h`` bfloat16 (f32 out), both
    bfloat16 (bf16 out, per-add)."""
    dev = _device(h, "edge_dot")
    for t, name in ((g, "g"), (h, "h")):
        _float(t, name, "edge_dot")
    build.require(h, "h", h.dtype, (None, None), dev)
    F = h.shape[1]
    build.require(g, "g", g.dtype, (None, F), dev)
    build.require(src, "src", torch.int32, (None,), dev)
    E = src.shape[0]
    build.require(dst, "dst", torch.int32, (E,), dev)
    if heads <= 0 or F % heads:
        raise ValueError(f"edge_dot: {heads} heads do not divide F = {F}")
    if g.dtype == BF16 and h.dtype != BF16:
        raise TypeError(f"edge_dot: no instance for g {g.dtype}, h {h.dtype}")
    if dev.type == "cpu":
        return edge_dot_plain(g, h, src, dst, heads)
    dt = torch.promote_types(g.dtype, h.dtype)
    out = torch.empty((E, heads), dtype=dt, device=dev)
    types = int(h.dtype == BF16) | 2 * int(dt == BF16)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_edge_dot(g.data_ptr(), h.data_ptr(), src.data_ptr(),
                                              dst.data_ptr(), out.data_ptr(), E, F, heads,
                                              types, build.stream_ptr(h))
    build.check(rc, "edge_dot")
    edge_dot.launches += 1
    return out


spmm.launches = 0
edge_dot.launches = 0
