"""``segment_sum``: rows summed per node in an order fixed by the node ids.

Replaces the scatter-add of JAX's gather VJP (``pathnet_tpu/models/pagg.py:83-93``;
XLA's scatter, deterministic there): ``out[v] = sum of rows[r] with
index[r] = v``, ``out [n, H]``. K4 (``kernels/pagg_encode_bwd.py``) stores
one gradient row per gathered row and hands them here, in place of adding
them into ``dh`` with atomics in an order that changes from run to run.

:func:`segments` groups the rows by node. Its items are units: runs of equal
ids cut at every ``RUN``-th row (K4's position-0 and ego rows lie 40 to a
target, the padding of a microbatch in one long run to node 0), each named by
its first row and its length, put in (node, first row) order, so each node's
rows come in the order they have in ``rows``: the order depends only on
``index``, that is on the paths. Source ``pathnet_tpu_torch/csrc/segment_sum.cu``:
on the card the grouping is the port's own stable radix sort of the units,
8 bits of the node id a pass (three launches a pass, each block's items
staged in shared memory so each digit's run is written contiguously), and a
launch for the offsets; then a warp per 32 sorted units adds their rows one
after another from 0 and writes each node it holds whole, and a last launch
adds the parts of the nodes that span warps in an order fixed by their count
(a node past 32 warps' worth, the padding's node 0, by a whole block) and
writes zeros for empty nodes. The plain version adds each node's rows in
that order with ``index_add_``, which on the CPU is one add after another;
the kernel's sum equals it up to rounding where a node spans warps, and is
the same on every run.

Bound on the H100: bytes, each row read once; at the bgp microbatch (8192
targets, nw = 40, wl = 4, H = 64) 1.64 M rows of 256 B, ~0.42 GB, ~0.13 ms
at 3.35 TB/s.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build

RUN = 16            # rows of an aligned window; no unit crosses one
TASK = 32           # units a summing warp takes (csrc/segment_sum.cu)
MAX_ROWS = 1 << 26  # a unit is first row * RUN + length - 1 in an int32


def segments_plain(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`segments`."""
    R = index.shape[0]
    r = torch.arange(R, dtype=torch.int32, device=index.device)
    start = r % RUN == 0
    start[1:] |= index[1:] != index[:-1]
    first = r[start]
    length = torch.diff(first, append=first.new_tensor([R]))
    key = index[first]
    order = torch.sort(key, stable=True).indices
    units = torch.zeros(R, dtype=torch.int32, device=index.device)
    units[:first.shape[0]] = first[order] * RUN + length[order] - 1
    nodes = torch.arange(n + 1, dtype=torch.int32, device=index.device)
    return units, torch.searchsorted(key[order], nodes, out_int32=True)


def unit_rows(units: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """int64 ``[R]``: the rows of ``segments``' units, unit after unit, each
    unit's rows in order (a host sync: it reads the unit count)."""
    u = units[:int(offsets[-1])].long()
    first, length = u // RUN, u % RUN + 1
    rows = torch.repeat_interleave(first, length)
    before = torch.repeat_interleave(length.cumsum(0) - length, length)
    return rows + torch.arange(rows.shape[0], device=rows.device) - before


def segment_sum_plain(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`segment_sum`."""
    order = unit_rows(*segments_plain(index, n))
    return rows.new_zeros((n, rows.shape[1])).index_add_(0, index[order].long(),
                                                         rows[order])


def _check(index: torch.Tensor, n: int, dev: torch.device, what: str) -> None:
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    if index.shape[0] > MAX_ROWS:
        raise ValueError(f"{what}: {index.shape[0]} rows, more than {MAX_ROWS}")
    if n < 0:
        raise ValueError(f"{what}: n = {n}")


def _scratch(R: int, n: int, dev: torch.device):
    """The launch's int32 scratch, and the units and offsets within it."""
    size = build.library().pathnet_segment_scratch(R)
    ints = torch.empty(size + R + n + 1, dtype=torch.int32, device=dev)
    return ints, ints[size:size + R], ints[size + R:]


def segments(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(units int32 [R], offsets int32 [n + 1])`` for ``index`` int32 ``[R]``
    (each in ``[0, n)``): ``units[:offsets[n]]`` are the units in (node,
    first row) order, each ``first row * RUN + length - 1``, and node ``v``'s
    are ``units[offsets[v]:offsets[v + 1]]``; the rest of ``units`` is
    unspecified. On the card the grouping launches of :func:`segment_sum`
    alone (for tests and timing; it counts no launch)."""
    dev = index.device
    build.require(index, "index", torch.int32, (None,), dev)
    _check(index, n, dev, "segments")
    if dev.type == "cpu":
        return segments_plain(index, n)
    R = index.shape[0]
    ints, units, offsets = _scratch(R, n, dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_segment_group(
            index.data_ptr(), ints.data_ptr(), units.data_ptr(), offsets.data_ptr(), R, n,
            build.stream_ptr(index))
    build.check(rc, "segments")
    return units, offsets


def segment_sum(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """``float32 [n, H]``: ``rows [R, H]`` float32 summed by node ``index [R]``
    (int32, each in ``[0, n)``), each node's rows in their order in ``rows``."""
    dev = rows.device
    build.require(rows, "rows", torch.float32, (None, None), dev)
    R, H = rows.shape
    build.require(index, "index", torch.int32, (R,), dev)
    _check(index, n, dev, "segment_sum")
    if dev.type == "cpu":
        return segment_sum_plain(rows, index, n)
    ints, units, offsets = _scratch(R, n, dev)
    part = torch.empty((2 * -(-R // TASK), H), dtype=torch.float32, device=dev)
    out = torch.empty((n, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_segment_sum(
            rows.data_ptr(), index.data_ptr(), ints.data_ptr(), units.data_ptr(),
            offsets.data_ptr(), part.data_ptr(), out.data_ptr(), R, n, H,
            build.stream_ptr(rows))
    build.check(rc, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
