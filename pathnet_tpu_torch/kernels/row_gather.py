"""K5 ``row_gather`` and ``row_gather_bwd``: ``out[i, :] = tbl[idx[i], :]`` and its VJP.

Replaces the Pallas row-gather probe ``scripts/pallas_gather_probe.py:68``
(bodies ``int_indexing``, ``take``, ``row_shuffle_axis0``, ``:31-44``), which
computes the function of ``pagg_forward``'s ``gather_fn`` hook
(``pathnet_tpu/models/pagg.py:200-209,309``): the model's ego gather
``h[ego_idx]`` goes through it, forward and backward. The backward is
``dtbl.index_add_(0, idx, dout)``, an ``atomicAdd`` scatter. On the training
path its sums do not depend on the atomics' order: a chunk's real targets are
unique, and its one repeated index is node 0, where ``_pad_chunks``
(``train/trainer.py``) puts the padding at weight 0, whose rows' gradients
are exact zeros (``tests/test_torch_reproducible.py``); adding +-0 to a sum
in any order gives the same bits.

Source: ``pathnet_tpu_torch/csrc/row_gather.cu``. The forward gives each
row a group of lanes (16 lanes of one float4 each at C = 64), 256 / lanes
rows a block, the row's index loaded once; the backward one thread per float
of ``dout``. Bound on the H100: bytes, ``m * C`` floats read and written plus
the indices, over 3.35 TB/s.

``idx`` is checked to lie in ``[0, n)``: on the host with an ``IndexError``;
on the card the forward kernel asserts it for each row (a bad index stops the
stream, as ``tbl[idx]`` does: one launch a call), and the backward enqueues a
device-side assert on its minimum and maximum, which needs no host sync;
``check=False`` skips that where the caller has checked (the autograd
function's backward, whose forward checked the same ``idx``).
"""
from __future__ import annotations

import torch

from . import build


def row_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_gather` (``index_select``, whose
    backward adds in a fixed order on the CPU)."""
    return tbl.index_select(0, idx.long())


def row_gather_bwd_plain(dout: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`row_gather_bwd`."""
    dtbl = torch.zeros((n, dout.shape[1]), dtype=dout.dtype, device=dout.device)
    return dtbl.index_add_(0, idx.long(), dout)


def _check_idx(idx: torch.Tensor, n: int, name: str) -> None:
    """On the host, raise ``IndexError``; on the card, enqueue a device-side
    assert (no host sync: a bad index stops the stream, as ``tbl[idx]``
    does)."""
    if not idx.numel():
        return
    lo, hi = torch.aminmax(idx)
    if idx.device.type == "cpu":
        if lo < 0 or hi >= n:
            raise IndexError(f"{name}: index {int(lo if lo < 0 else hi)} outside [0, {n})")
    else:
        torch._assert_async((lo >= 0) & (hi < n), f"{name}: index outside [0, {n})")


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``float32 [m, C]`` of ``tbl`` (float32 ``[n, C]``) at ``idx``
    (int32 ``[m]``, in ``[0, n)``)."""
    dev = tbl.device
    build.require(tbl, "tbl", torch.float32, (None, None), dev)
    n, C = tbl.shape
    build.require(idx, "idx", torch.int32, (None,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather: unsupported device {dev}")
    if dev.type == "cpu":
        _check_idx(idx, n, "row_gather")
        return row_gather_plain(tbl, idx)
    m = idx.shape[0]
    out = torch.empty((m, C), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.pathnet_row_gather(tbl.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    m, n, C, build.stream_ptr(tbl))
    build.check(rc, "row_gather")
    row_gather.launches += 1
    return out


def row_gather_bwd(dout: torch.Tensor, idx: torch.Tensor, n: int,
                   check: bool = True) -> torch.Tensor:
    """``dtbl float32 [n, C]``: ``dtbl[v] = sum of dout[i] over i with idx[i] = v``."""
    dev = dout.device
    build.require(dout, "dout", torch.float32, (None, None), dev)
    m, C = dout.shape
    build.require(idx, "idx", torch.int32, (m,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"row_gather_bwd: unsupported device {dev}")
    if check:
        _check_idx(idx, n, "row_gather_bwd")
    if dev.type == "cpu":
        return row_gather_bwd_plain(dout, idx, n)
    dtbl = torch.zeros((n, C), dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        rc = lib.pathnet_row_gather_bwd(dout.data_ptr(), idx.data_ptr(),
                                        dtbl.data_ptr(), m, C, build.stream_ptr(dout))
    build.check(rc, "row_gather_bwd")
    row_gather_bwd.launches += 1
    return dtbl


row_gather.launches = 0
row_gather_bwd.launches = 0
