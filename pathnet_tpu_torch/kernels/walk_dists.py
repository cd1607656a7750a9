"""``walk_dists``: the inverse-CDF walks (K1) and their hop distances (K2) in one launch.

Replaces ``pathnet_tpu/sample/alias.py:142-147`` (``CdfSampler.step``) as
scanned by ``pathnet_tpu/sample/walk.py:36-55`` (``sample_paths``), followed
by ``pathnet_tpu/sample/distance.py:77-139`` (``membership_dists``): from
``(nbr, cdf, deg, starts, u)`` it gives ``(paths, dists)``, exactly
:func:`~pathnet_tpu_torch.kernels.cdf_walk.cdf_walk` followed by
:func:`~pathnet_tpu_torch.kernels.membership_dists.membership_dists`, with
their layouts. ``PathSampler.sample`` calls it; the walks and distances
never go through device memory between the two.

Source: ``pathnet_tpu_torch/csrc/walk_dists.cu``, which ``cdf_walk`` and
``membership_dists`` also launch. The walks lie flat across the grid, a lane
group per walk (from the table width D: one lane to D = 32, as at bgp's 25;
16 to D = 512, as at cornell's 190 and Nba's 442; 32 past). A walk step counts the CDF entries below the uniform, G at a time,
with warp votes; the distance tests binary-search the start's row, sorted
once per graph (:func:`sorted_rows`, ``srt``), and the N2 test reads
``nbr[v3]`` coalesced and stops at the first hit. The header of the source
says why a sorted row and not a bitmap of node ids.

Bound on the H100: latency of each walk's dependent loads; the tables of
every graph the port runs fit in the 50 MB L2. The byte bound (the tables,
``u``, ``paths`` and ``dists`` once) is ~0.01 ms at the bgp request.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

_INT32_MAX = 2 ** 31 - 1


def sorted_rows(nbr: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """int32 ``[n, D]``: the first ``deg`` entries of each row of ``nbr``
    ascending (``deg`` clamped to ``[0, D]``), then ``2**31 - 1``."""
    D = nbr.shape[1]
    col = torch.arange(D, device=nbr.device)
    real = col[None, :] < deg[:, None]
    return torch.where(real, nbr, _INT32_MAX).sort(dim=1).values.contiguous()


def launch(nbr: torch.Tensor, cdf: Optional[torch.Tensor], deg: Optional[torch.Tensor],
           srt: Optional[torch.Tensor], starts: torch.Tensor, u: Optional[torch.Tensor],
           paths: torch.Tensor, dists: Optional[torch.Tensor]) -> None:
    """One launch of the device code on checked CUDA tensors: walks into
    ``paths`` from ``u`` (or, with ``u`` None, the walks read from
    ``paths``), distances into ``dists`` unless it is None."""
    S, nw, wl = paths.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(nbr.device):
        rc = build.library().pathnet_walk_dists(
            nbr.data_ptr(), ptr(cdf), ptr(deg), ptr(srt), starts.data_ptr(), ptr(u),
            paths.data_ptr(), ptr(dists), nbr.shape[1], S, nw, wl, int(u is not None),
            build.stream_ptr(nbr))
    build.check(rc, "walk_dists")


def walk_dists_plain(nbr: torch.Tensor, cdf: torch.Tensor, deg: torch.Tensor,
                     srt: torch.Tensor, starts: torch.Tensor, u: torch.Tensor,
                     num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``cdf_walk_plain`` then ``membership_dists_plain``
    (``srt`` is not needed)."""
    # imported here: those two modules launch this module's device code
    from .cdf_walk import cdf_walk_plain
    from .membership_dists import membership_dists_plain

    paths = cdf_walk_plain(nbr, cdf, starts, u, num_walks)
    return paths, membership_dists_plain(nbr, deg, starts, paths)


def walk_dists(nbr: torch.Tensor, cdf: torch.Tensor, deg: torch.Tensor, srt: torch.Tensor,
               starts: torch.Tensor, u: torch.Tensor,
               num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(paths, dists)``, both int32 ``[S, num_walks, wl]`` with
    ``wl = u.shape[0] + 1 <= 4``.

    ``nbr`` int32 ``[n, D]``, ``cdf`` float32 ``[n, D]``, ``deg`` int32
    ``[n]``, ``srt`` = :func:`sorted_rows` ``(nbr, deg)``, ``starts`` int32
    ``[S]`` in ``[0, n)``, ``u`` float32 ``[wl - 1, S * num_walks]`` in
    ``[0, 1)``; walker ``w`` starts at ``starts[w // num_walks]``.
    """
    dev = nbr.device
    build.require(nbr, "nbr", torch.int32, (None, None), dev)
    n, D = nbr.shape
    build.require(cdf, "cdf", torch.float32, (n, D), dev)
    build.require(deg, "deg", torch.int32, (n,), dev)
    build.require(srt, "srt", torch.int32, (n, D), dev)
    build.require(starts, "starts", torch.int32, (None,), dev)
    S = starts.shape[0]
    build.require(u, "u", torch.float32, (None, S * num_walks), dev)
    wl = u.shape[0] + 1
    if wl > 4:
        raise ValueError(f"membership distances need 1 <= walk_len <= 4, got {wl}")
    if dev.type == "cpu":
        return walk_dists_plain(nbr, cdf, deg, srt, starts, u, num_walks)
    if dev.type != "cuda":
        raise ValueError(f"walk_dists: unsupported device {dev}")
    paths, dists = torch.empty((2, S, num_walks, wl), dtype=torch.int32, device=dev)
    launch(nbr, cdf, deg, srt, starts, u, paths, dists)
    walk_dists.launches += 1
    return paths, dists


walk_dists.launches = 0
