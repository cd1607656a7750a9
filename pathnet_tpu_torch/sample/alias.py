"""Transition tables: inverse-CDF rows and Vose alias tables (port of
``pathnet_tpu/sample/alias.py``).

:class:`CdfSampler` holds the inverse-CDF rows that K1 scans
(``alias.py:118-147``). :class:`AliasSampler` holds Vose's alias tables,
three ``[n, D]`` arrays (``lo``, ``hi``, ``split``) with the degrees, that
K8 rolls in O(1) a step (``alias.py:75-104``). :func:`build_alias_tables`
builds them on the host once a graph, in numpy, step for step as JAX's
``_build_alias_tables_np`` does, so the tables are bit-equal. The JAX
package also has a C++ copy of the construction
(``csrc/fastgraph.cpp``); the port keeps none: the numpy construction takes
a few seconds on the bgp stand-in (n = 63,977, D = 25; ``chip_smoke.py``
phase 16 prints the time), once a graph, against the 10 x 1000 epochs that
follow.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
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


def build_alias_tables(nbr: np.ndarray, prob: np.ndarray, deg: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vose's alias tables ``(lo, hi, split)`` of each row, as
    ``pathnet_tpu/sample/alias.py:42-70`` builds them.

    ``prob`` rows sum to 1 over their first ``deg[u]`` slots. Slot ``j``
    drawn uniformly from ``[0, deg[u])`` and a coin ``u2`` in ``[0, 1)``
    give ``lo[u, j]`` if ``u2 < split[u, j]``, else ``hi[u, j]``. Built step
    for step as JAX builds them (float64 ``q``, the small and large stacks
    popped from the back, ``split`` clipped to 1), so the tables are
    bit-equal. A row with ``deg <= 1`` keeps ``split = 1`` and ``lo = hi =
    nbr``: isolated nodes (pure self-loops) and padding.
    """
    n, D = prob.shape
    lo = nbr.copy()
    hi = nbr.copy()
    split = np.ones((n, D), np.float32)
    for u in range(n):
        k = int(deg[u])
        if k <= 1:
            continue
        q = prob[u, :k].astype(np.float64) * k
        alias = np.arange(k)
        small = [i for i in range(k) if q[i] < 1.0]
        large = [i for i in range(k) if q[i] >= 1.0]
        while small and large:
            s = small.pop()
            big = large.pop()
            alias[s] = big
            q[big] = (q[big] + q[s]) - 1.0
            if q[big] < 1.0:
                small.append(big)
            else:
                large.append(big)
        for i in small + large:
            q[i] = 1.0
        split[u, :k] = np.minimum(q, 1.0).astype(np.float32)
        lo[u, :k] = nbr[u, :k]
        hi[u, :k] = nbr[u, alias]
    return lo, hi, split


@dataclasses.dataclass
class AliasSampler:
    """Alias tables of one graph on its device, with the neighbour table
    and sorted rows that the membership distances read (as
    :class:`CdfSampler` carries them)."""

    n: int
    max_deg: int
    lo: torch.Tensor     # int32 [n, D]
    hi: torch.Tensor     # int32 [n, D]
    split: torch.Tensor  # float32 [n, D]
    deg: torch.Tensor    # int32 [n]
    nbr: torch.Tensor    # int32 [n, D]
    srt: torch.Tensor    # int32 [n, D]: each row's real entries ascending

    @staticmethod
    def from_device_graph(dg: DeviceGraph) -> "AliasSampler":
        """The tables of ``dg``, built on the host and moved to its device."""
        lo, hi, split = build_alias_tables(dg.nbr.cpu().numpy(), dg.prob.cpu().numpy(),
                                           dg.deg.cpu().numpy())
        dev = dg.nbr.device
        return AliasSampler(n=dg.n, max_deg=dg.max_deg, lo=torch.from_numpy(lo).to(dev),
                            hi=torch.from_numpy(hi).to(dev),
                            split=torch.from_numpy(split).to(dev), deg=dg.deg, nbr=dg.nbr,
                            srt=sorted_rows(dg.nbr, dg.deg))
