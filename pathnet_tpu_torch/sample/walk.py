"""Path sampling (port of ``pathnet_tpu/sample/walk.py``).

Two samplers, as in JAX: the inverse-CDF rows (``sampler="cdf"``, K1's
step) and Vose's alias tables (``sampler="alias"``, K8's step, O(1) a step).
``sample_paths`` draws the walks alone (``kernels/cdf_walk.py`` or
``kernels/alias_walk.py``); ``PathSampler.sample`` draws them and resolves
their hop distances with the backend ``build`` picked: at ``walk_len <= 4``
in one launch, ``walk_dists`` or ``alias_walk_dists``
(``kernels/walk_dists.py``: the walk and K2 fused); at ``walk_len >= 5`` in
one launch, ``walk_khop_dists`` or ``alias_walk_khop_dists``
(``kernels/khop_dists.py``: the walk and K7 fused); with a dense table, the
walks then a lookup in the table. ``kind="uniform"`` (RW-PathNet) walks the
symmetrized graph with one self-loop a node, uniform over each row's
records; the distances are then taken on that graph too, as in JAX.

The uniforms come from an explicit ``torch.Generator``, or from the caller:
a test that hands in JAX's own draws gets JAX's walks. K1 takes one a step,
``u [wl - 1, W]``; K8 two, ``u [wl - 1, 2, W]`` (``u1`` for the slot, then
``u2`` for the coin, JAX's ``k1`` and ``k2``). ``PathSampler.sample_epoch``
keys an epoch's generator by the round seed and the epoch
(``rng.make_generator``), as the trainer draws each epoch's walks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..data.graph import DeviceGraph, Graph
from ..device import resolve_device
from ..kernels.alias_walk import alias_walk
from ..kernels.cdf_walk import cdf_walk
from ..kernels.khop_dists import KhopTables, alias_walk_khop_dists, walk_khop_dists
from ..kernels.walk_dists import alias_walk_dists, walk_dists
from ..rng import STREAM_WALKS, make_generator
from .alias import AliasSampler, CdfSampler
from .distance import bfs_distance_table, bfs_distance_table_host, build_khop_tables

# one k-hop level's table at most (int32 [n, Dk]); past it the dense [n, n]
# int8 table is no larger, and the khop backend falls back to it
KHOP_MAX_BYTES = 1 << 30
BACKENDS = ("membership", "khop", "dense", "host", "none")
SAMPLERS = ("cdf", "alias")
KINDS = ("merw", "uniform")


def uniform_shape(walk_len: int, walkers: int, per_step: int = 1) -> Tuple[int, ...]:
    """The draws' shape: ``[walk_len - 1, walkers]`` with one a step (K1),
    ``[walk_len - 1, 2, walkers]`` with two (K8)."""
    return (walk_len - 1, walkers) if per_step == 1 else (walk_len - 1, per_step, walkers)


def draws_per_step(sampler: Union[CdfSampler, AliasSampler]) -> int:
    return 2 if isinstance(sampler, AliasSampler) else 1


def draw_uniforms(walk_len: int, walkers: int, generator: torch.Generator,
                  device: torch.device, per_step: int = 1) -> torch.Tensor:
    """float32 draws in ``[0, 1)`` of :func:`uniform_shape`."""
    return torch.rand(uniform_shape(walk_len, walkers, per_step), generator=generator,
                      device=device, dtype=torch.float32)


def sample_paths(sampler: Union[CdfSampler, AliasSampler], starts: torch.Tensor,
                 num_walks: int, walk_len: int, u: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Walk tensor ``int32 [len(starts), num_walks, walk_len]``.

    ``u`` (:func:`uniform_shape` of ``walk_len``, ``len(starts) * num_walks``
    and the sampler's draws a step) gives the draws; else they come from
    ``generator``, which must then be given.
    """
    u = _uniforms(u, generator, walk_len, starts.shape[0] * num_walks,
                  sampler.nbr.device, draws_per_step(sampler))
    if isinstance(sampler, AliasSampler):
        return alias_walk(sampler.lo, sampler.hi, sampler.split, sampler.deg, starts, u,
                          num_walks)
    return cdf_walk(sampler.nbr, sampler.cdf, starts, u, num_walks)


def _uniforms(u, generator, walk_len, walkers, device, per_step) -> torch.Tensor:
    """``u`` checked against ``walk_len`` and the draws a step, or drawn
    from ``generator``."""
    if u is None:
        if generator is None:
            raise ValueError("sampling needs the uniforms u or a generator")
        u = draw_uniforms(walk_len, walkers, generator, device, per_step)
    if u.shape[0] != walk_len - 1:
        raise ValueError(f"u has {u.shape[0]} steps, walk_len {walk_len} needs "
                         f"{walk_len - 1}")
    if tuple(u.shape[1:-1]) != uniform_shape(walk_len, walkers, per_step)[1:-1]:
        raise ValueError(f"u has shape {tuple(u.shape)}, the sampler takes "
                         f"{uniform_shape(walk_len, walkers, per_step)}")
    return u


@dataclasses.dataclass
class PathSampler:
    """Per-graph sampling state: the CDF or alias tables and the distance
    backend's state (``khop``: the packed k-hop rows; ``dense``, ``host``:
    the ``[n, n]`` int8 table; ``membership``: the sampler's sorted rows)."""

    num_walks: int
    walk_len: int
    sampler: Union[CdfSampler, AliasSampler]
    backend: str = "membership"
    khop: Optional[KhopTables] = None
    dist_table: Optional[torch.Tensor] = None

    @staticmethod
    def build(g: Graph, num_walks: int, walk_len: int, kind: str = "merw",
              sampler: str = "cdf", distance_backend: str = "auto",
              distance_chunk: int = 1024,
              device: Optional[Union[str, torch.device]] = None) -> "PathSampler":
        """From a host graph whose records carry transition probabilities.

        ``kind="merw"`` walks ``g.prob`` as it is; ``kind="uniform"``
        symmetrizes ``g`` (``Graph.symmetrized``, one self-loop a node, as
        JAX's default ``add_self_loops``) and walks uniformly over each
        row's records, with every distance backend on that graph
        (gen.cpp:83-94, the RW-PathNet ablation). ``sampler="cdf"`` builds the inverse-CDF rows
        (K1), ``"alias"`` Vose's alias tables (K8). The distance backend is
        chosen as JAX chooses it: ``auto`` is ``membership`` for ``walk_len
        <= 4`` (which it alone supports) and ``khop`` past it; ``khop`` caps a level's
        widest row at ``max(64, KHOP_MAX_BYTES // (4 n))`` (and ``n``) and
        falls back to the dense table when a level passes it; ``dense`` and
        ``host`` build the ``[n, n]`` table truncated at ``walk_len`` hops
        (``distance_chunk`` starts at a time, or with scipy on the host);
        ``none`` keeps no distances.
        """
        if kind not in KINDS:
            raise ValueError(f"kind={kind!r}: expected one of {KINDS}")
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler={sampler!r}: expected one of {SAMPLERS}")
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
        if kind == "uniform":
            g = g.symmetrized(add_self_loops=True)
        dg = DeviceGraph.from_graph(g, device=dev)
        tables = AliasSampler if sampler == "alias" else CdfSampler
        ps = PathSampler(num_walks=num_walks, walk_len=walk_len,
                         sampler=tables.from_device_graph(dg), backend=distance_backend)
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

    def uniform_shape(self, walkers: int) -> Tuple[int, ...]:
        """The shape of the draws ``sample`` takes for ``walkers`` walks."""
        return uniform_shape(self.walk_len, walkers, draws_per_step(self.sampler))

    def draw_uniforms(self, walkers: int, generator: torch.Generator) -> torch.Tensor:
        """Draws of :meth:`uniform_shape` from ``generator``, on the
        sampler's device."""
        return draw_uniforms(self.walk_len, walkers, generator, self.device,
                             draws_per_step(self.sampler))

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
        u = _uniforms(u, generator, self.walk_len, starts.shape[0] * nw, self.device,
                      draws_per_step(smp))
        alias = isinstance(smp, AliasSampler)
        if self.backend == "membership":
            if alias:
                return alias_walk_dists(smp.lo, smp.hi, smp.split, smp.deg, smp.nbr, smp.srt,
                                        starts, u, nw)
            return walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, nw)
        if self.backend == "khop":
            if alias:
                return alias_walk_khop_dists(smp.lo, smp.hi, smp.split, smp.deg, self.khop,
                                             starts, u, nw)
            return walk_khop_dists(smp.nbr, smp.cdf, self.khop, starts, u, nw)
        paths = sample_paths(smp, starts, nw, self.walk_len, u=u)
        if self.dist_table is None:
            return paths, None
        dists = self.dist_table[starts.long()[:, None, None], paths.long()]
        return paths, dists.to(torch.int32)

    def sample_epoch(self, seed: int, epoch: int):
        """One epoch's ``(paths, dists)`` for every node: a fresh walk set an
        epoch, reproducible from the round ``seed`` and the ``epoch``
        (JAX's ``fold_in(base_key, epoch)``), the draws from
        ``rng.make_generator(seed, epoch, STREAM_WALKS)`` on the sampler's
        device."""
        return self.sample(generator=make_generator(seed, epoch, STREAM_WALKS,
                                                    device=self.device))


def sample_epoch(ps: PathSampler, seed: int, epoch: int):
    return ps.sample_epoch(seed, epoch)
