"""S3 ``segment_softmax`` and S4 ``segment_softmax_bwd``: GAT's per-destination softmax.

Replace the XLA ops of ``pathnet_tpu/models/baselines/ops.py:76-82``
(``segment_max``, ``exp``, ``segment_sum``, the quotient with its sum clamped
at 1e-16), vmapped over the heads in ``zoo.py:327-328`` and ``:447-448``,
and their VJP, ``ds_e = a_e (da_e - sum over e's row of a da)``. Scores are
``[E, heads]`` in the edge list's order; the rows are the destination-sorted
CSR ``(ptr, perm)``. Source ``pathnet_tpu_torch/csrc/segment_softmax.cu``: a
thread a (row, head), the row's edges in CSR order (the max, the sum of
exponentials, the quotients), so every sum has one fixed order and no
atomics. Bound on the H100: bytes, the scores (S4: ``a`` and ``da``) read
once and the output written once, with the CSR, over 3.35 TB/s.

The bf16 instances take and give bf16 scores. S3 rounds where XLA rounds
JAX's bf16 ``segment_softmax`` on the CPU: the max is exact, ``s - max``
and its ``exp`` are each rounded to bf16, the denominator is a bf16 sum
rounded after each add in edge order, clamped at bf16's 1e-16, and the
quotient is rounded (``exp`` may differ from XLA's by an f32 ulp, so an
output may differ by a bf16 ulp). S4 is the analytic VJP in f32 on the bf16
``a`` and ``da``, rounded once to bf16; JAX differentiates the softmax op by
op, rounding at each, so S4 stays within a tolerance of JAX, not its bits.
"""
from __future__ import annotations

import torch

from . import build
from .spmm import BF16, csr_rows, per_add_rows


def segment_softmax_plain(s: torch.Tensor, ptr: torch.Tensor, perm: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_softmax` (``scatter_reduce``
    "amax", ``exp``, ``index_add_`` in CSR order; bf16: each op rounded,
    the denominator by :func:`~.spmm.per_add_rows`)."""
    n, heads = ptr.shape[0] - 1, s.shape[1]
    rows, edges = csr_rows(ptr), perm.long()
    se = s.index_select(0, edges)
    smax = s.new_full((n, heads), -torch.inf).scatter_reduce(
        0, rows[:, None].expand(-1, heads), se, "amax")
    ex = torch.exp(se - smax.index_select(0, rows))
    if s.dtype == BF16:
        denom = per_add_rows(ex, ptr)
    else:
        denom = s.new_zeros((n, heads)).index_add_(0, rows, ex)
    out = torch.empty_like(s)
    out[edges] = ex / denom.index_select(0, rows).clamp(min=1e-16)
    return out


def segment_softmax_bwd_plain(a: torch.Tensor, da: torch.Tensor, ptr: torch.Tensor,
                              perm: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_softmax_bwd` (bf16: in f32,
    rounded once)."""
    n, heads = ptr.shape[0] - 1, a.shape[1]
    rows, edges = csr_rows(ptr), perm.long()
    ae, dae = a.index_select(0, edges).float(), da.index_select(0, edges).float()
    dot = ae.new_zeros((n, heads)).index_add_(0, rows, ae * dae)
    ds = torch.empty_like(a)
    ds[edges] = (ae * (dae - dot.index_select(0, rows))).to(a.dtype)
    return ds


def _check(t: torch.Tensor, name: str, ptr: torch.Tensor, perm: torch.Tensor,
           what: str) -> torch.device:
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    build.require(perm, "perm", torch.int32, (None,), dev)
    if t.dtype not in (torch.float32, BF16):
        raise TypeError(f"{what}: {name} must be torch.float32 or torch.bfloat16, got {t.dtype}")
    build.require(t, name, t.dtype, (perm.shape[0], None), dev)
    build.require(ptr, "ptr", torch.int32, (None,), dev)
    return dev


def segment_softmax(s: torch.Tensor, ptr: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``[E, heads]``: the softmax of the scores ``s`` (float32 or bfloat16
    ``[E, heads]``, the output's dtype) over each destination row of the
    CSR (``ptr`` int32 ``[n + 1]``, ``perm`` int32 ``[E]``, every edge in one
    row), per head."""
    dev = _check(s, "s", ptr, perm, "segment_softmax")
    if dev.type == "cpu":
        return segment_softmax_plain(s, ptr, perm)
    out = torch.empty_like(s)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_segment_softmax(
            s.data_ptr(), ptr.data_ptr(), perm.data_ptr(), out.data_ptr(), ptr.shape[0] - 1,
            s.shape[1], int(s.dtype == BF16), build.stream_ptr(s))
    build.check(rc, "segment_softmax")
    segment_softmax.launches += 1
    return out


def segment_softmax_bwd(a: torch.Tensor, da: torch.Tensor, ptr: torch.Tensor,
                        perm: torch.Tensor) -> torch.Tensor:
    """``[E, heads]``: the scores' gradient from the softmax ``a`` and its
    gradient ``da`` (both float32 or both bfloat16 ``[E, heads]``, the
    output's dtype) on the CSR of :func:`segment_softmax`."""
    dev = _check(a, "a", ptr, perm, "segment_softmax_bwd")
    build.require(da, "da", a.dtype, tuple(a.shape), dev)
    if dev.type == "cpu":
        return segment_softmax_bwd_plain(a, da, ptr, perm)
    ds = torch.empty_like(a)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_segment_softmax_bwd(
            a.data_ptr(), da.data_ptr(), ptr.data_ptr(), perm.data_ptr(), ds.data_ptr(),
            ptr.shape[0] - 1, a.shape[1], int(a.dtype == BF16), build.stream_ptr(a))
    build.check(rc, "segment_softmax_bwd")
    segment_softmax_bwd.launches += 1
    return ds


segment_softmax.launches = 0
segment_softmax_bwd.launches = 0
