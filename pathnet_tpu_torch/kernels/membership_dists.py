"""K2 ``membership_dists``: exact hop distances of walk nodes, ``walk_len <= 4``.

Replaces ``pathnet_tpu/sample/distance.py:77-139``. ``d0 = 0``; ``d1 = 0`` iff
``v1 == s`` else 1; ``d2`` adds the ``N1(s)`` test; ``d3`` adds the ``N2(s)``
test, ``N(v3) ∩ N(s) ≠ ∅``. Rows are masked by degree, so padding never
counts as a neighbour.

Source: ``pathnet_tpu_torch/csrc/walk_dists.cu``, the device code of
:func:`~pathnet_tpu_torch.kernels.walk_dists.walk_dists` run on given walks
(the sampler's path takes ``walk_dists``; this entry serves walks from
elsewhere, JAX's in the parity tests). A lane group per walk; each
membership test a binary search of the start's row, sorted
(:func:`~pathnet_tpu_torch.kernels.walk_dists.sorted_rows`, made by this
wrapper on each call); the N2 test the group's lanes over ``nbr[v3]``,
stopping at the first hit: at most ``deg(v3) * log2(D)`` loads, mostly L1
hits, where a scan of both rows would compare ``deg(v3) * deg(s)`` pairs.
The result is exactly the plain version's.

Bound on the H100: latency of the ``nbr[v3]`` row reads; the bytes of
``nbr``, ``paths`` and the output are far fewer.
"""
from __future__ import annotations

import torch

from . import build
from .walk_dists import launch, sorted_rows

# the plain version takes the [S, nw, D, D] N2 compare in start chunks of at
# most this many elements
_CHUNK_ELEMS = 1 << 24


def _n1(rows: torch.Tensor, mask: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v [S, nw]`` is among the first ``deg`` entries of its row ``[S, D]``."""
    return ((rows[:, None, :] == v[:, :, None]) & mask[:, None, :]).any(dim=-1)


def membership_dists_plain(nbr: torch.Tensor, deg: torch.Tensor,
                           starts: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version; same arguments and result as :func:`membership_dists`."""
    S, nw, wl = paths.shape
    D = nbr.shape[1]
    s = starts.long()
    rows = nbr[s]                                           # [S, D]
    col = torch.arange(D, device=nbr.device)
    mask = col[None, :] < deg[s][:, None]                   # [S, D]
    sv = starts[:, None]
    cols = [torch.zeros((S, nw), dtype=torch.int32, device=nbr.device)]
    if wl > 1:
        cols.append((paths[:, :, 1] != sv).to(torch.int32))
    if wl > 2:
        v2 = paths[:, :, 2]
        d2 = torch.where(v2 == sv, 0, torch.where(_n1(rows, mask, v2), 1, 2))
        cols.append(d2.to(torch.int32))
    if wl > 3:
        v3 = paths[:, :, 3]
        in1 = _n1(rows, mask, v3)
        step = max(1, _CHUNK_ELEMS // max(1, nw * D * D))
        in2 = []
        for lo in range(0, S, step):
            v = v3[lo:lo + step].long()
            rv = nbr[v]                                     # [c, nw, D]
            mv = col[None, None, :] < deg[v][:, :, None]
            hit = rv[:, :, :, None] == rows[lo:lo + step, None, None, :]
            hit &= mv[:, :, :, None] & mask[lo:lo + step, None, None, :]
            in2.append(hit.any(dim=(-1, -2)))
        in2 = torch.cat(in2, dim=0)
        d3 = torch.where(v3 == sv, 0,
                         torch.where(in1, 1, torch.where(in2, 2, 3)))
        cols.append(d3.to(torch.int32))
    return torch.stack(cols, dim=-1)


def membership_dists(nbr: torch.Tensor, deg: torch.Tensor, starts: torch.Tensor,
                     paths: torch.Tensor) -> torch.Tensor:
    """Hop distances ``int32 [S, nw, wl]`` of ``paths`` from their starts.

    ``nbr`` int32 ``[n, D]``, ``deg`` int32 ``[n]``, ``starts`` int32 ``[S]``,
    ``paths`` int32 ``[S, nw, wl <= 4]`` with node ids in ``[0, n)``.
    """
    dev = nbr.device
    build.require(nbr, "nbr", torch.int32, (None, None), dev)
    n, D = nbr.shape
    build.require(deg, "deg", torch.int32, (n,), dev)
    build.require(starts, "starts", torch.int32, (None,), dev)
    build.require(paths, "paths", torch.int32, (starts.shape[0], None, None), dev)
    S, nw, wl = paths.shape
    if not 1 <= wl <= 4:
        raise ValueError(f"membership distances need 1 <= walk_len <= 4, got {wl}")
    if dev.type == "cpu":
        return membership_dists_plain(nbr, deg, starts, paths)
    if dev.type != "cuda":
        raise ValueError(f"membership_dists: unsupported device {dev}")
    out = torch.empty((S, nw, wl), dtype=torch.int32, device=dev)
    launch(nbr, None, deg, sorted_rows(nbr, deg), starts, None, paths, out)
    membership_dists.launches += 1
    return out


membership_dists.launches = 0
