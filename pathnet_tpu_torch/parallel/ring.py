"""The ring boundary-feature exchange (port of ``pathnet_tpu/parallel/ring.py``).

In the graph-partitioned mode each rank of the ``data`` axis keeps only its
row block ``[n/d, H]`` of the feature table; a walk may visit any node, so
the gather ``h[idx]`` needs rows that other ranks own. Here the blocks
rotate ``d - 1`` times around the axis by ``batch_isend_irecv``
(:func:`~pathnet_tpu_torch.parallel.comm.ring_step`), and after each
rotation a rank takes from the block it holds the rows it asked for. The
next step's send and receive are posted before this step's gather, as JAX's
``ppermute`` for step ``s + 1`` is issued before the gather of step ``s``.
Peak memory is two blocks a rank.

The local gather is K5 (``kernels/row_gather.py``) on the clipped ids,
``where``-selected where the block owns them: each row is owned by exactly
one block, so the result is ``h[idx]`` bit for bit. The backward rotates the
gradient blocks the other way and adds each step's owned rows into the block
in transit with ``segment_sum`` (``kernels/segment_sum.py``: a fixed order,
so a seeded round stays bit-equal on the card).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..kernels.row_gather import row_gather
from ..kernels.segment_sum import segment_sum
from .comm import Axis, Grid, ring_step


def pad_rows(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Pad dim 0 with zero rows to a multiple of ``multiple``; returns
    ``(padded, original length)`` (``pathnet_tpu/parallel/ring.py:91-98``)."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]), n


def owned(idx: torch.Tensor, owner: int, bs: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(local ids int32, mask)``: ``idx`` relative to ``owner``'s block of
    ``bs`` rows, and which of them lie in it."""
    local = idx - owner * bs
    return local.to(torch.int32), (local >= 0) & (local < bs)


def owned_rows(block: torch.Tensor, local: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``where(mask, block[local], 0)`` with K5 on the clipped ids."""
    rows = row_gather(block, local.clamp(0, block.shape[0] - 1).contiguous())
    return torch.where(mask[:, None], rows, 0.0)


def scatter_owned(g: torch.Tensor, local: torch.Tensor, mask: torch.Tensor,
                  bs: int) -> torch.Tensor:
    """``[bs, H]``: the rows of ``g`` where ``mask``, summed into their
    local ids in row order (``segment_sum``)."""
    sel = mask.nonzero().squeeze(1)
    return segment_sum(g.index_select(0, sel).contiguous(),
                       local.index_select(0, sel).contiguous(), bs)


class RingGather(torch.autograd.Function):
    """``h[idx]`` from this rank's ``block`` of ``h`` and its ``idx [m]``."""

    @staticmethod
    def forward(ctx, block, idx, axis: Axis):
        d, me, bs = axis.size, axis.index, block.shape[0]
        ctx.axis, ctx.bs = axis, bs
        ctx.save_for_backward(idx)
        out = block.new_zeros((idx.shape[0], block.shape[1]))
        cur = block.contiguous()
        for s in range(d):
            nxt = ring_step(cur, axis) if s + 1 < d else None
            local, mask = owned(idx, (me + s) % d, bs)
            out = torch.where(mask[:, None], owned_rows(cur, local, mask), out)
            if nxt is not None:
                cur = nxt.wait()
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        axis, bs = ctx.axis, ctx.bs
        d, me = axis.size, axis.index
        g = g.contiguous()
        # at step s this rank holds the gradient block of owner (me + s) % d:
        # the last step's owner first, then a rotation the other way a step
        acc = None
        for s in reversed(range(d)):
            local, mask = owned(idx, (me + s) % d, bs)
            part = scatter_owned(g, local, mask, bs)
            acc = part if acc is None else acc + part
            if s > 0:
                acc = ring_step(acc, axis, reverse=True).wait()
        return acc, None, None


def make_ring_gather(grid: Grid) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``gather(block, idx) -> h[idx]`` over the grid's ``data`` axis
    (``pathnet_tpu/parallel/ring.py:39-88``): ``block`` is this rank's rows
    of ``h`` (rank ``r`` of the axis owns rows ``r * bs`` to ``r * bs + bs``,
    :func:`~pathnet_tpu_torch.parallel.mesh.shard_rows`), ``idx`` this
    rank's global row ids, of any shape; the result has ``idx``'s shape
    and ``block``'s width."""
    axis = grid.data_axis

    def gather(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        flat = idx.reshape(-1).to(torch.int32)
        out = RingGather.apply(block, flat, axis)
        return out.reshape(*idx.shape, block.shape[1])

    return gather
