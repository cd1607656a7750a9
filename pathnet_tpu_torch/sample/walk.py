"""Path sampling (port of ``pathnet_tpu/sample/walk.py:36-55,85-164``).

``sample_paths`` draws the walks with K1 (``kernels/cdf_walk.py``);
``PathSampler.sample`` draws them and resolves their hop distances with the
backend ``build`` picked: at ``walk_len <= 4`` in one launch, ``walk_dists``
(``kernels/walk_dists.py``: K1 and K2 fused); at ``walk_len >= 5`` in one
launch, ``walk_khop_dists`` (``kernels/khop_dists.py``: K1 and K7 fused);
with a dense table, K1 then a lookup in the table. The uniforms of the
``wl - 1`` steps come from an explicit ``torch.Generator``, or from the
caller: a test that hands in JAX's own draws gets JAX's walks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..data.graph import DeviceGraph, Graph
from ..device import resolve_device
from ..kernels.cdf_walk import cdf_walk
from ..kernels.khop_dists import KhopTables, walk_khop_dists
from ..kernels.walk_dists import walk_dists
from .alias import CdfSampler
from .distance import bfs_distance_table, bfs_distance_table_host, build_khop_tables

# one k-hop level's table at most (int32 [n, Dk]); past it the dense [n, n]
# int8 table is no larger, and the khop backend falls back to it
KHOP_MAX_BYTES = 1 << 30
BACKENDS = ("membership", "khop", "dense", "host", "none")


def draw_uniforms(walk_len: int, walkers: int, generator: torch.Generator,
                  device: torch.device) -> torch.Tensor:
    """``float32 [walk_len - 1, walkers]`` in ``[0, 1)``, one row per step."""
    return torch.rand((walk_len - 1, walkers), generator=generator,
                      device=device, dtype=torch.float32)


def sample_paths(sampler: CdfSampler, starts: torch.Tensor, num_walks: int,
                 walk_len: int, u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Walk tensor ``int32 [len(starts), num_walks, walk_len]``.

    ``u`` (``[walk_len - 1, len(starts) * num_walks]``) gives the draws; else
    they come from ``generator``, which must then be given.
    """
    u = _uniforms(u, generator, walk_len, starts.shape[0] * num_walks,
                  sampler.nbr.device)
    return cdf_walk(sampler.nbr, sampler.cdf, starts, u, num_walks)


def _uniforms(u, generator, walk_len, walkers, device) -> torch.Tensor:
    """``u`` checked against ``walk_len``, or drawn from ``generator``."""
    if u is None:
        if generator is None:
            raise ValueError("sampling needs the uniforms u or a generator")
        u = draw_uniforms(walk_len, walkers, generator, device)
    if u.shape[0] != walk_len - 1:
        raise ValueError(f"u has {u.shape[0]} steps, walk_len {walk_len} needs "
                         f"{walk_len - 1}")
    return u


@dataclasses.dataclass
class PathSampler:
    """Per-graph sampling state: the CDF tables and the distance backend's
    state (``khop``: the packed k-hop rows; ``dense``, ``host``: the
    ``[n, n]`` int8 table; ``membership``: the sampler's sorted rows)."""

    num_walks: int
    walk_len: int
    sampler: CdfSampler
    backend: str = "membership"
    khop: Optional[KhopTables] = None
    dist_table: Optional[torch.Tensor] = None

    @staticmethod
    def build(g: Graph, num_walks: int, walk_len: int, kind: str = "merw",
              sampler: str = "cdf", distance_backend: str = "auto",
              distance_chunk: int = 1024,
              device: Optional[Union[str, torch.device]] = None) -> "PathSampler":
        """From a host graph whose records carry transition probabilities.

        ``kind="merw"`` and ``sampler="cdf"`` are ported; the others raise
        ``NotImplementedError``. The distance backend is chosen as JAX
        chooses it: ``auto`` is ``membership`` for ``walk_len <= 4`` (which
        it alone supports) and ``khop`` past it; ``khop`` caps a level's
        widest row at ``max(64, KHOP_MAX_BYTES // (4 n))`` (and ``n``) and
        falls back to the dense table when a level passes it; ``dense`` and
        ``host`` build the ``[n, n]`` table truncated at ``walk_len`` hops
        (``distance_chunk`` starts at a time, or with scipy on the host);
        ``none`` keeps no distances.
        """
        if kind != "merw":
            raise NotImplementedError(
                f"kind={kind!r}: only 'merw' is ported (ROADMAP §1 item 12)")
        if sampler != "cdf":
            raise NotImplementedError(
                f"sampler={sampler!r}: the alias sampler is not ported yet "
                "(ROADMAP §1 item 9)")
        if distance_backend == "auto":
            distance_backend = "membership" if walk_len <= 4 else "khop"
        if distance_backend not in BACKENDS:
            raise ValueError(f"distance_backend={distance_backend!r}: expected 'auto' or one "
                             f"of {BACKENDS}")
        if walk_len < 1:
            raise ValueError(f"walk_len must be >= 1, got {walk_len}")
        if distance_backend == "membership" and walk_len > 4:
            raise ValueError("membership distances support walk_len <= 4; "
                             "use distance_backend='khop'")
        dev = resolve_device(device)
        dg = DeviceGraph.from_graph(g, device=dev)
        ps = PathSampler(num_walks=num_walks, walk_len=walk_len,
                         sampler=CdfSampler.from_device_graph(dg), backend=distance_backend)
        if distance_backend == "khop":
            max_width = min(max(64, KHOP_MAX_BYTES // (4 * g.n)), g.n)
            try:
                levels = build_khop_tables(g, walk_len - 1, max_width, device=dev)
            except ValueError:      # a level wider than max_width
                ps.backend = "dense"
            else:
                ps.khop = KhopTables.pack(levels)
        if ps.backend == "dense":
            ps.dist_table = bfs_distance_table(g, walk_len, distance_chunk, device=dev)
        elif ps.backend == "host":
            ps.dist_table = torch.from_numpy(bfs_distance_table_host(g, walk_len)).to(dev)
        return ps

    @property
    def device(self) -> torch.device:
        return self.sampler.nbr.device

    def sample(self, starts: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """``(paths, dists)``, both ``int32 [S, num_walks, walk_len]``
        (``dists`` None for the ``none`` backend).

        ``dists`` holds each walk node's 0-based hop distance from its start
        (the reference's ``o[_] - 1``, gen_merw.cpp:199-204). ``starts``
        defaults to every node in order; ``u`` and ``generator`` as in
        :func:`sample_paths`. The dense table is read with a 2-D index
        ``[starts, paths]``: a flat one would pass int32 at n > ~46k.
        """
        smp = self.sampler
        if starts is None:
            starts = torch.arange(smp.n, dtype=torch.int32, device=self.device)
        nw = self.num_walks
        u = _uniforms(u, generator, self.walk_len, starts.shape[0] * nw, self.device)
        if self.backend == "membership":
            return walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, nw)
        if self.backend == "khop":
            return walk_khop_dists(smp.nbr, smp.cdf, self.khop, starts, u, nw)
        paths = cdf_walk(smp.nbr, smp.cdf, starts, u, nw)
        if self.dist_table is None:
            return paths, None
        dists = self.dist_table[starts.long()[:, None, None], paths.long()]
        return paths, dists.to(torch.int32)
