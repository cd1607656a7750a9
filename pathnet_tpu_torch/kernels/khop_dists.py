"""K7 ``khop_dists``: hop distances of walk nodes from sorted k-hop tables, any walk length.

Replaces ``pathnet_tpu/sample/distance.py:194-229`` (``_row_membership``,
``khop_dists``). A node at walk position ``i`` has ``d = min(i, BFS level)``:
``d0 = 0``; ``d1 = 0`` iff ``v1 == s`` else 1; at ``i >= 2`` the smallest
level ``k`` in ``1..i-1`` whose sorted row ``tables[k-1][s]`` holds ``v_i``,
else ``i``, and 0 where ``v_i == s``. The rows are those of
``build_khop_tables`` (``sample/distance.py``): each level's exact-k-hop
neighbours ascending, padded with the sentinel ``n``.

Two entries, one device code (``pathnet_tpu_torch/csrc/walk_dists.cu``):
:func:`walk_khop_dists` draws the walks (K1's step) and their k-hop
distances in one launch, the sampler's path at ``walk_len >= 5`` as
``walk_dists`` is at ``walk_len <= 4``; :func:`khop_dists` gives the
distances of walks from elsewhere (JAX's in the parity tests, and K7 timed
alone). Each distance is found as the walk reaches its position: a binary
search of the start's row at each level from 1 up, stopped at the first
hit, so the walk length has no cap. The levels lie packed in one buffer
(:class:`KhopTables`) with each level's offset and width.
:func:`alias_walk_khop_dists` is the fused launch with K8's alias step
(``pathnet_tpu/sample/alias.py:93-104``, ``kernels/alias_walk.py``) in
place of K1's, one lane a walk: the sampler's path past ``walk_len`` 4
with the alias tables.

Bound on the H100: the latency of each walk's dependent loads. The bytes
(the start's rows once, the walks and distances) are well under a megabyte
at cornell and Nba, below what one launch costs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from . import build
from .walk_dists import check_alias_tables


@dataclasses.dataclass
class KhopTables:
    """The sorted exact-k-hop rows of levels ``1..L`` of one graph, packed.

    ``levels[k - 1]`` is int32 ``[n, Dk]``, a view into ``packed``; level
    ``k`` starts at element ``offsets[k - 1]`` and is ``widths[k - 1]``
    wide (int64 and int32 ``[L]``, on the tables' device, for the kernel).
    """

    levels: Tuple[torch.Tensor, ...]
    packed: torch.Tensor
    offsets: torch.Tensor
    widths: torch.Tensor

    @staticmethod
    def pack(levels: Sequence[torch.Tensor]) -> "KhopTables":
        """Pack int32 ``[n, Dk]`` tables (one per level, on one device; none
        packs to an empty buffer on the host)."""
        dev = levels[0].device if len(levels) else torch.device("cpu")
        for k, t in enumerate(levels):
            build.require(t, f"level {k + 1}", torch.int32, (levels[0].shape[0], None), dev)
        sizes = [t.numel() for t in levels]
        packed = (torch.cat([t.reshape(-1) for t in levels]) if levels
                  else torch.zeros(0, dtype=torch.int32, device=dev))
        offsets = [sum(sizes[:k]) for k in range(len(sizes))]
        views = tuple(packed[o:o + s].view(t.shape)
                      for o, s, t in zip(offsets, sizes, levels))
        return KhopTables(
            levels=views, packed=packed,
            offsets=torch.tensor(offsets, dtype=torch.int64, device=dev),
            widths=torch.tensor([t.shape[1] for t in levels], dtype=torch.int32, device=dev))

    @property
    def device(self) -> torch.device:
        return self.packed.device

    def __len__(self) -> int:
        return len(self.levels)


def _check_levels(tables: KhopTables, wl: int) -> None:
    if wl < 1:
        raise ValueError(f"k-hop distances need walk_len >= 1, got {wl}")
    if wl > len(tables) + 1:
        raise ValueError(f"walk_len {wl} needs k-hop tables for levels 1..{wl - 1}, "
                         f"got {len(tables)}")


def khop_dists_plain(levels: Sequence[torch.Tensor], starts: torch.Tensor,
                     paths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`khop_dists` on the unpacked
    ``levels``: ``torch.searchsorted`` in each start's row, as JAX's
    ``jnp.searchsorted``."""
    S, nw, wl = paths.shape
    dev = paths.device
    sv = starts[:, None]
    cols = [torch.zeros((S, nw), dtype=torch.int32, device=dev)]
    if wl > 1:
        cols.append((paths[:, :, 1] != sv).to(torch.int32))
    rows = [t[starts.long()] for t in levels[:wl - 1]]      # [S, Dk]
    for i in range(2, wl):
        v = paths[:, :, i].contiguous()
        d = torch.full((S, nw), i, dtype=torch.int32, device=dev)
        for level in range(i - 1, 0, -1):
            row = rows[level - 1]
            j = torch.searchsorted(row, v).clamp_(max=row.shape[1] - 1)
            d = torch.where(row.gather(1, j) == v, level, d)
        cols.append(torch.where(v == sv, 0, d))
    return torch.stack(cols, dim=-1).to(torch.int32)


def walk_khop_dists_plain(nbr: torch.Tensor, cdf: torch.Tensor, tables: KhopTables,
                          starts: torch.Tensor, u: torch.Tensor,
                          num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`walk_khop_dists`: ``cdf_walk_plain``
    then :func:`khop_dists_plain`."""
    from .cdf_walk import cdf_walk_plain

    paths = cdf_walk_plain(nbr, cdf, starts, u, num_walks)
    return paths, khop_dists_plain(tables.levels, starts, paths)


def launch(nbr: Optional[torch.Tensor], cdf: Optional[torch.Tensor], starts: torch.Tensor,
           u: Optional[torch.Tensor], tables: KhopTables, paths: torch.Tensor,
           dists: torch.Tensor) -> None:
    """One launch of K7 on checked CUDA tensors: walks into ``paths`` from
    ``u`` (or, with ``u`` None, the walks read from ``paths``), their k-hop
    distances into ``dists``."""
    S, nw, wl = paths.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(paths.device):
        rc = build.library().pathnet_khop_dists(
            ptr(nbr), ptr(cdf), starts.data_ptr(), ptr(u), tables.packed.data_ptr(),
            tables.offsets.data_ptr(), tables.widths.data_ptr(), paths.data_ptr(),
            dists.data_ptr(), 0 if nbr is None else nbr.shape[1], S, nw, wl,
            int(u is not None), build.stream_ptr(paths))
    build.check(rc, "khop_dists")


def khop_dists(tables: KhopTables, starts: torch.Tensor, paths: torch.Tensor) -> torch.Tensor:
    """Hop distances ``int32 [S, nw, wl]`` of ``paths`` from their starts.

    ``tables`` packs levels ``1..L`` with ``L >= wl - 1`` (JAX's bound; the
    last level is never read), ``starts`` int32 ``[S]``, ``paths`` int32
    ``[S, nw, wl]``, node ids in ``[0, n)``.
    """
    dev = tables.device
    build.require(starts, "starts", torch.int32, (None,), dev)
    build.require(paths, "paths", torch.int32, (starts.shape[0], None, None), dev)
    S, nw, wl = paths.shape
    _check_levels(tables, wl)
    if dev.type == "cpu":
        return khop_dists_plain(tables.levels, starts, paths)
    if dev.type != "cuda":
        raise ValueError(f"khop_dists: unsupported device {dev}")
    out = torch.empty((S, nw, wl), dtype=torch.int32, device=dev)
    launch(None, None, starts, None, tables, paths, out)
    khop_dists.launches += 1
    return out


def walk_khop_dists(nbr: torch.Tensor, cdf: torch.Tensor, tables: KhopTables,
                    starts: torch.Tensor, u: torch.Tensor,
                    num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(paths, dists)``, both int32 ``[S, num_walks, wl]`` with ``wl =
    u.shape[0] + 1 <= len(tables) + 1``: the walks of
    :func:`~pathnet_tpu_torch.kernels.cdf_walk.cdf_walk` and their
    :func:`khop_dists`, in one launch.

    ``nbr`` int32 ``[n, D]``, ``cdf`` float32 ``[n, D]``, ``starts`` int32
    ``[S]``, ``u`` float32 ``[wl - 1, S * num_walks]`` in ``[0, 1)``; walker
    ``w`` starts at ``starts[w // num_walks]``.
    """
    dev = tables.device
    build.require(nbr, "nbr", torch.int32, (None, None), dev)
    n, D = nbr.shape
    build.require(cdf, "cdf", torch.float32, (n, D), dev)
    build.require(starts, "starts", torch.int32, (None,), dev)
    S = starts.shape[0]
    build.require(u, "u", torch.float32, (None, S * num_walks), dev)
    wl = u.shape[0] + 1
    _check_levels(tables, wl)
    if dev.type == "cpu":
        return walk_khop_dists_plain(nbr, cdf, tables, starts, u, num_walks)
    if dev.type != "cuda":
        raise ValueError(f"walk_khop_dists: unsupported device {dev}")
    paths, dists = torch.empty((2, S, num_walks, wl), dtype=torch.int32, device=dev)
    launch(nbr, cdf, starts, u, tables, paths, dists)
    walk_khop_dists.launches += 1
    return paths, dists


khop_dists.launches = 0
walk_khop_dists.launches = 0


def alias_walk_khop_dists_plain(lo: torch.Tensor, hi: torch.Tensor, split: torch.Tensor,
                                deg: torch.Tensor, tables: KhopTables, starts: torch.Tensor,
                                u: torch.Tensor,
                                num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`alias_walk_khop_dists`:
    ``alias_walk_plain`` then :func:`khop_dists_plain`."""
    from .alias_walk import alias_walk_plain

    paths = alias_walk_plain(lo, hi, split, deg, starts, u, num_walks)
    return paths, khop_dists_plain(tables.levels, starts, paths)


def alias_walk_khop_dists(lo: torch.Tensor, hi: torch.Tensor, split: torch.Tensor,
                          deg: torch.Tensor, tables: KhopTables, starts: torch.Tensor,
                          u: torch.Tensor,
                          num_walks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(paths, dists)``, both int32 ``[S, num_walks, wl]`` with ``wl =
    u.shape[0] + 1 <= len(tables) + 1``: K8's walks (the alias tables ``lo``,
    ``hi``, ``split``, ``deg`` and draws ``u [wl - 1, 2, S * num_walks]``,
    as ``kernels/alias_walk.py`` takes them) and their :func:`khop_dists`,
    in one launch.
    """
    dev = tables.device
    check_alias_tables(lo, hi, split, deg, starts, u, num_walks)
    if lo.device != dev:
        raise ValueError(f"lo: on {lo.device}, expected {dev}")
    S, wl = starts.shape[0], u.shape[0] + 1
    _check_levels(tables, wl)
    if dev.type == "cpu":
        return alias_walk_khop_dists_plain(lo, hi, split, deg, tables, starts, u, num_walks)
    if dev.type != "cuda":
        raise ValueError(f"alias_walk_khop_dists: unsupported device {dev}")
    paths, dists = torch.empty((2, S, num_walks, wl), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build.library().pathnet_alias_khop_dists(
            lo.data_ptr(), hi.data_ptr(), split.data_ptr(), deg.data_ptr(), starts.data_ptr(),
            u.data_ptr(), tables.packed.data_ptr(), tables.offsets.data_ptr(),
            tables.widths.data_ptr(), paths.data_ptr(), dists.data_ptr(), lo.shape[1], S,
            num_walks, wl, build.stream_ptr(lo))
    build.check(rc, "alias_walk_khop_dists")
    alias_walk_khop_dists.launches += 1
    return paths, dists


alias_walk_khop_dists.launches = 0
