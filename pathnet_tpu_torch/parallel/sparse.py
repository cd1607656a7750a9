"""The sparse (ownership-keyed) boundary-feature exchange (port of
``pathnet_tpu/parallel/sparse.py``).

Every rank of the ``data`` axis owns a contiguous row block ``[n/d, H]``;
for a gather ``h[idx]`` each rank contributes the rows it owns,
``where(owner(idx) == me, block[idx - me * bs], 0)`` (K5 on the clipped
ids, :func:`~pathnet_tpu_torch.parallel.ring.owned_rows`), and a collective
sums the one-hot contributions into the exact gather:

- :func:`make_sparse_gather` (``:59-98``), replicated requests (serving):
  every rank asks for the same rows and an all-reduce gives every rank the
  whole answer. Its backward takes the replicated gradient as each rank's
  (the loss computed alike on every rank) and adds the owned rows into the
  block.
- :func:`make_sparse_gather_sharded` (``:101-147``), sharded requests
  (training): the request ids are all-gathered, each rank contributes its
  owned rows to the whole request list, and a reduce-scatter returns each
  rank its own rows. Its backward all-gathers the gradients and adds the
  owned rows into the block.

The backward's adds are ``segment_sum``'s, in a fixed order
(:func:`~pathnet_tpu_torch.parallel.ring.scatter_owned`).
:func:`exchange_comm_words` is JAX's analytic volume model, copied.
"""
from __future__ import annotations

from typing import Callable

import torch

from .comm import Axis, Grid, all_gather, all_reduce_sum, reduce_scatter
from .ring import owned, owned_rows, scatter_owned


class OwnedRows(torch.autograd.Function):
    """``where(mask, block[local], 0)``; backward: the owned rows' gradients
    summed into the block in row order."""

    @staticmethod
    def forward(ctx, block, local, mask):
        ctx.bs = block.shape[0]
        ctx.save_for_backward(local, mask)
        return owned_rows(block, local, mask)

    @staticmethod
    def backward(ctx, g):
        local, mask = ctx.saved_tensors
        return scatter_owned(g.contiguous(), local, mask, ctx.bs), None, None


def _contribution(block: torch.Tensor, ids: torch.Tensor, axis: Axis) -> torch.Tensor:
    local, mask = owned(ids, axis.index, block.shape[0])
    return OwnedRows.apply(block.contiguous(), local, mask)


def make_sparse_gather(grid: Grid) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``gather(block, idx) -> h[idx]`` with ``idx`` the same on every rank
    of the ``data`` axis and the result replicated there."""
    axis = grid.data_axis

    def gather(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        flat = idx.reshape(-1).to(torch.int32)
        out = all_reduce_sum(_contribution(block, flat, axis), axis)
        return out.reshape(*idx.shape, block.shape[1])

    return gather


def make_sparse_gather_sharded(grid: Grid
                               ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``gather(block, idx) -> h[idx]`` with each rank's own ``idx`` (every
    rank of the ``data`` axis asking for as many rows) and its own rows as
    the result."""
    axis = grid.data_axis

    def gather(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        flat = idx.reshape(-1).to(torch.int32).contiguous()
        ids = all_gather(flat, axis)                       # [d * ml], ids only
        out = reduce_scatter(_contribution(block, ids, axis), axis)
        return out.reshape(*idx.shape, block.shape[1])

    return gather


def exchange_comm_words(n: int, h: int, m: int, d: int) -> dict:
    """Analytic per-device communication volume (words) of the three
    boundary-exchange modes for a ``[n, h]`` sharded feature matrix and an
    ``m``-row gather on a ``d``-device axis (``:150-162``)."""
    if d <= 1:
        return {"gspmd": 0, "ring": 0, "sparse": 0, "sparse_sharded": 0}
    return {
        "gspmd": (d - 1) * (n // d) * h,
        "ring": (d - 1) * (n // d) * h,
        "sparse": 2 * (d - 1) * m * h // d,
        "sparse_sharded": (d - 1) * m * h,   # m = per-shard request count
    }
