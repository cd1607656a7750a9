"""Path sampling for serving (port of ``pathnet_tpu/sample/walk.py:36-55,85-164``).

``sample_paths`` draws the walks with K1 (``kernels/cdf_walk.py``);
``PathSampler.sample`` draws them and resolves their hop distances in one
launch, ``walk_dists`` (``kernels/walk_dists.py``: K1 and K2 fused). The
uniforms of the ``wl - 1`` steps come
from an explicit ``torch.Generator``, or from the caller: a test that hands in
JAX's own draws gets JAX's walks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..data.graph import DeviceGraph, Graph
from ..device import resolve_device
from ..kernels.cdf_walk import cdf_walk
from ..kernels.walk_dists import walk_dists
from .alias import CdfSampler


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
    """Per-graph sampling state: the CDF tables and the membership rows."""

    num_walks: int
    walk_len: int
    sampler: CdfSampler

    @staticmethod
    def build(g: Graph, num_walks: int, walk_len: int, kind: str = "merw",
              sampler: str = "cdf", distance_backend: str = "auto",
              device: Optional[Union[str, torch.device]] = None) -> "PathSampler":
        """From a host graph whose records carry transition probabilities.

        Only the serving path's choices are ported: ``kind="merw"``,
        ``sampler="cdf"`` and the ``membership`` distance backend
        (``walk_len <= 4``). The others raise ``NotImplementedError``.
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
        if distance_backend != "membership":
            raise NotImplementedError(
                f"distance_backend={distance_backend!r}: only 'membership' "
                "(walk_len <= 4) is ported (ROADMAP §1 item 8)")
        if not 1 <= walk_len <= 4:
            raise ValueError("membership distances support 1 <= walk_len <= 4")
        dg = DeviceGraph.from_graph(g, device=resolve_device(device))
        return PathSampler(num_walks=num_walks, walk_len=walk_len,
                           sampler=CdfSampler.from_device_graph(dg))

    @property
    def device(self) -> torch.device:
        return self.sampler.nbr.device

    def sample(self, starts: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """``(paths, dists)``, both ``int32 [S, num_walks, walk_len]``, from
        one ``walk_dists`` launch.

        ``dists`` holds each walk node's 0-based hop distance from its start
        (the reference's ``o[_] - 1``, gen_merw.cpp:199-204). ``starts``
        defaults to every node in order; ``u`` and ``generator`` as in
        :func:`sample_paths`.
        """
        smp = self.sampler
        if starts is None:
            starts = torch.arange(smp.n, dtype=torch.int32, device=self.device)
        u = _uniforms(u, generator, self.walk_len, starts.shape[0] * self.num_walks,
                      self.device)
        return walk_dists(smp.nbr, smp.cdf, smp.deg, smp.srt, starts, u, self.num_walks)
