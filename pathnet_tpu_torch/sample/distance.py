"""Hop-distance backends (port of ``pathnet_tpu/sample/distance.py``).

- ``membership`` (``walk_len <= 4``): kernel K2,
  :func:`~pathnet_tpu_torch.kernels.membership_dists.membership_dists`,
  re-exported here; its docstring states the rule.
- ``khop`` (any ``walk_len``, the default at ``walk_len >= 5``):
  :func:`build_khop_tables` makes the sorted exact-k-hop rows once a graph on
  the host; :func:`khop_dists` resolves walks with kernel K7
  (``kernels/khop_dists.py``).
- ``dense``: the ``[n, n]`` int8 truncated-BFS table of
  :func:`bfs_distance_table`, built in plain torch on the sampler's device.
- ``host``: the same table from scipy, :func:`bfs_distance_table_host`.

Every backend gives the reference's ``d_i = dis[start][v_i] - 1``
(gen_merw.cpp:101-123,199-204) on the walks the sampler draws.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.graph import Graph
from ..device import resolve_device
from ..kernels.khop_dists import KhopTables
from ..kernels.khop_dists import khop_dists as _khop_kernel
from ..kernels.membership_dists import membership_dists

__all__ = ["membership_dists", "build_khop_tables", "khop_dists", "KhopTables",
           "bfs_distance_table", "bfs_distance_table_host"]


def _bfs_chunk(src: torch.Tensor, dst: torch.Tensor, starts: torch.Tensor, n: int,
               max_hops: int) -> torch.Tensor:
    """Distances int8 ``[C, n]`` from each of the ``C`` starts, -1 beyond
    ``max_hops``.

    One wave a hop: ``reached[c, v] = sum over records (u, v) of
    frontier[c, u]``, an ``index_add_`` over the edge list. Each wave holds
    a float32 ``[C, E]`` intermediate (``frontier[:, src]``, E records) and
    the ``[C, n]`` sums, as JAX's ``segment_sum`` does: 4 * C * E bytes, 4
    GB at C = 1024 and a million records.
    """
    C = starts.shape[0]
    rows = torch.arange(C, device=src.device)
    dist = torch.full((C, n), -1, dtype=torch.int8, device=src.device)
    dist[rows, starts] = 0
    frontier = torch.zeros((C, n), dtype=torch.float32, device=src.device)
    frontier[rows, starts] = 1.0
    for k in range(1, max_hops + 1):
        vals = frontier[:, src]                                       # [C, E]
        reached = torch.zeros((C, n), dtype=torch.float32,
                              device=src.device).index_add_(1, dst, vals)
        new = (reached > 0) & (dist < 0)
        dist.masked_fill_(new, k)
        frontier = new.to(torch.float32)
    return dist


def bfs_distance_table(g: Graph, max_hops: int, chunk: int = 1024,
                       device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """The ``[n, n]`` int8 truncated-BFS table on ``device`` (default: the
    card), ``chunk`` starts at a time: 0 on the diagonal, the hop count up to
    ``max_hops``, -1 beyond.

    Uses the directed records as they are (the reference's inputs hold both
    directions). The last chunk is padded with start 0 to ``chunk`` rows, as
    JAX pads it to a static shape, and its extra rows dropped; each chunk is
    written into the table in place.
    """
    dev = resolve_device(device)
    n = g.n
    src = torch.tensor(g.src, dtype=torch.int64, device=dev)
    dst = torch.tensor(g.dst, dtype=torch.int64, device=dev)
    table = torch.empty((n, n), dtype=torch.int8, device=dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        starts = torch.zeros(chunk, dtype=torch.int64, device=dev)
        starts[:hi - lo] = torch.arange(lo, hi, device=dev)
        table[lo:hi] = _bfs_chunk(src, dst, starts, n, max_hops)[:hi - lo]
    return table


def build_khop_tables(g: Graph, max_level: int, max_width: Optional[int] = None,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> List[torch.Tensor]:
    """Sorted exact-k-hop neighbour tables of levels ``1..max_level`` on
    ``device`` (default: the card).

    ``tables[k - 1]`` is int32 ``[n, Dk]``: the node ids at BFS distance
    exactly ``k`` from each row's node, ascending, padded with the sentinel
    ``n`` (greater than any id, so a search never matches it); ``Dk`` is the
    widest row, at least 1. Built on the host with scipy's sparse boolean
    products, over the records taken in both directions, exactly as JAX
    builds them. Raises ``ValueError`` naming the level when a level's widest
    row passes ``max_width``, so the caller can fall back to the dense table.
    """
    import scipy.sparse as sp

    def binarize(m):
        m = m.tocsr()
        m.eliminate_zeros()
        m.data = np.ones_like(m.data)
        return m

    dev = resolve_device(device)
    ones = np.ones(len(g.src), np.int8)
    a = binarize(sp.csr_matrix((ones, (g.src, g.dst)), shape=(g.n, g.n))
                 + sp.csr_matrix((ones, (g.dst, g.src)), shape=(g.n, g.n)))
    reach = sp.identity(g.n, dtype=np.int8, format="csr")     # dist <= level - 1
    frontier = a.copy()
    tables = []
    for level in range(1, max_level + 1):
        exact = binarize(frontier - frontier.multiply(reach))   # dist == level
        exact.sort_indices()
        widths = np.diff(exact.indptr)
        Dk = max(int(widths.max()) if len(widths) else 0, 1)
        if max_width is not None and Dk > max_width:
            raise ValueError(
                f"k-hop level {level} widest row is {Dk} > {max_width}; "
                "use distance_backend='dense' or 'host'")
        tab = np.full((g.n, Dk), g.n, np.int32)
        rows = np.repeat(np.arange(g.n), widths)
        pos = np.arange(len(exact.indices)) - np.repeat(exact.indptr[:-1], widths)
        tab[rows, pos] = exact.indices                         # CSR rows are sorted
        tables.append(torch.from_numpy(tab).to(dev))
        if level < max_level:
            reach = binarize(reach + exact)
            frontier = binarize(a @ reach)
    return tables


def khop_dists(tables: Union[KhopTables, Sequence[torch.Tensor]], starts: torch.Tensor,
               paths: torch.Tensor) -> torch.Tensor:
    """Hop distances int32 ``[S, nw, wl]`` of ``paths`` from the k-hop
    ``tables`` (packed, or the list :func:`build_khop_tables` returns), for
    any ``wl <= len(tables) + 1``: kernel K7 on a CUDA tensor, its plain
    version on a CPU one."""
    if not isinstance(tables, KhopTables):
        tables = KhopTables.pack(tables)
    return _khop_kernel(tables, starts, paths)


def bfs_distance_table_host(g: Graph, max_hops: int, chunk: int = 2048) -> np.ndarray:
    """The same table from scipy's unweighted ``dijkstra`` on the host
    (numpy int8 ``[n, n]``), ``chunk`` sources at a time so its float64
    intermediate stays ``chunk x n``."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    adj = sp.csr_matrix((np.ones(len(g.src), np.float32), (g.src, g.dst)), shape=(g.n, g.n))
    out = np.empty((g.n, g.n), np.int8)
    for lo in range(0, g.n, chunk):
        hi = min(lo + chunk, g.n)
        d = csgraph.dijkstra(adj, unweighted=True, limit=max_hops, directed=True,
                             indices=np.arange(lo, hi))
        out[lo:hi] = np.where(np.isfinite(d), d, -1).astype(np.int8)
    return out
