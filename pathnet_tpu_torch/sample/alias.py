"""Inverse-CDF transition tables (port of ``pathnet_tpu/sample/alias.py:118-147``).

The alias sampler of the same JAX module is still to be ported (ROADMAP §1
item 9).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..data.graph import DeviceGraph
from ..kernels.walk_dists import sorted_rows

_BLOCK = 16


def _blocked_cumsum(p: torch.Tensor) -> torch.Tensor:
    """Row prefix sums of ``p [n, L]`` in XLA's order, bit for bit.

    XLA computes a long cumulative sum as sequential sums within blocks of
    16, plus the (recursively summed) totals of the blocks before. Summing in
    that order makes the table equal to the JAX package's, so equal uniforms
    give equal walks.
    """
    n, L = p.shape
    nb = -(-L // _BLOCK)
    local = F.pad(p, (0, nb * _BLOCK - L)).reshape(n, nb, _BLOCK).clone()
    for j in range(1, _BLOCK):
        local[:, :, j] += local[:, :, j - 1]
    if nb == 1:
        return local.reshape(n, _BLOCK)[:, :L]
    before = F.pad(_blocked_cumsum(local[:, :, -1].contiguous())[:, :-1], (1, 0))
    return (local + before[:, :, None]).reshape(n, nb * _BLOCK)[:, :L]


@dataclasses.dataclass
class CdfSampler:
    """Neighbour table, inclusive CDF table and sorted rows of one graph, on
    its device."""

    n: int
    max_deg: int
    nbr: torch.Tensor    # int32 [n, D]
    cdf: torch.Tensor    # float32 [n, D]
    deg: torch.Tensor    # int32 [n]
    srt: torch.Tensor    # int32 [n, D]: each row's real entries ascending

    @staticmethod
    def from_device_graph(dg: DeviceGraph) -> "CdfSampler":
        # Saturate the last real slot and all padding to 1.0: draws lie in
        # [0, 1), so idx = #{cdf < u} never passes deg - 1, and a row whose
        # float sum is slightly below 1 still resolves to its last edge.
        cdf = _blocked_cumsum(dg.prob)
        col = torch.arange(dg.max_deg, device=dg.prob.device)[None, :]
        last = dg.deg.clamp(min=1)[:, None] - 1
        cdf = torch.where(col >= last, torch.ones_like(cdf), cdf).contiguous()
        return CdfSampler(n=dg.n, max_deg=dg.max_deg, nbr=dg.nbr, cdf=cdf,
                          deg=dg.deg, srt=sorted_rows(dg.nbr, dg.deg))
