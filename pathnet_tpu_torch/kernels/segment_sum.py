"""``segment_sum``: rows summed per node in an order fixed by the node ids.

Replaces the scatter-add of JAX's gather VJP (``pathnet_tpu/models/pagg.py:83-93``;
XLA's scatter, deterministic there): ``out[v] = sum of rows[r] with
index[r] = v``, ``out [n, H]``. K4 (``kernels/pagg_encode_bwd.py``) stores
one gradient row per gathered row and hands them here, in place of adding
them into ``dh`` with atomics in an order that changes from run to run.

:func:`segments` sorts ``index`` once, stably (``torch.sort``), so each
node's rows form a run in the order they have in ``rows``: the order depends
only on ``index``, that is on the paths. Source
``pathnet_tpu_torch/csrc/segment_sum.cu``, two launches: a warp per piece
of at most ``PIECE`` rows of a node's run adds them one after another from
0, then a warp per node adds its pieces in order, each lane over its own
columns. Pieces keep a long run (the padding's node 0 in a microbatch) from
holding one warp. The plain version adds each node's rows in their sorted
order with ``index_add_`` over the sorted rows, which on the CPU is one add
after another; the kernel's sum equals it up to rounding where a run is
longer than ``PIECE``, and is the same on every run.

Bound on the H100: bytes, each row read once; at the bgp microbatch (8192
targets, nw = 40, wl = 4, H = 64) 1.64 M rows of 256 B, ~0.42 GB, ~0.13 ms
at 3.35 TB/s, plus the sort.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

PIECE = 256   # rows a warp adds before the per-node pass


def segments(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order int64 [R], offsets int32 [n + 1])``: the row ids sorted
    stably by node, and where each node's run starts in ``order``."""
    keys, order = torch.sort(index, stable=True)
    nodes = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    return order, torch.searchsorted(keys, nodes, out_int32=True)


def segment_sum_plain(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`segment_sum`."""
    order, _ = segments(index, n)
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, index[order].long(),
                                                         rows[order])


def segment_sum(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``float32 [n, H]``: ``rows [R, H]`` float32 summed by node ``index [R]``
    (int32, each in ``[0, n)``), each node's rows in their order in ``rows``."""
    dev = rows.device
    build.require(rows, "rows", torch.float32, (None, None), dev)
    R, H = rows.shape
    build.require(index, "index", torch.int32, (R,), dev)
    if dev.type == "cpu":
        return segment_sum_plain(rows, index, n)
    if dev.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {dev}")
    order, offsets = segments(index, n)
    # each node's pieces: piece_off[v] : piece_off[v + 1]; pieces past the
    # last node's (at most R // PIECE + n in all) get node n and do nothing
    pieces = (offsets[1:] - offsets[:-1] + PIECE - 1) // PIECE
    piece_off = F.pad(pieces.cumsum(0, dtype=torch.int32), (1, 0))
    npieces = R // PIECE + n
    piece_node = torch.searchsorted(
        piece_off, torch.arange(npieces, dtype=torch.int32, device=dev), right=True,
        out_int32=True) - 1
    partial = torch.empty((npieces, H), dtype=torch.float32, device=dev)
    out = torch.empty((n, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_segment_sum(
            rows.data_ptr(), order.data_ptr(), offsets.data_ptr(), piece_off.data_ptr(),
            piece_node.data_ptr(), partial.data_ptr(), out.data_ptr(), n, npieces, H, PIECE,
            build.stream_ptr(rows))
    build.check(rc, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
