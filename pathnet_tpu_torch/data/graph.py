"""Graph containers: host edge records (numpy) and the padded CSR on a device.

Port of ``pathnet_tpu/data/graph.py``. The padded CSR keeps dense
``[n, max_deg]`` neighbour and probability tables plus a degree vector, so
every sampling and distance kernel indexes a fixed-width row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..device import resolve_device


@dataclasses.dataclass
class Graph:
    """Directed edge records in file order plus optional payloads.

    Duplicate records are kept: each adds probability mass to its row, as in
    the reference sampler (gen_merw.cpp:166-176).
    """

    n: int
    src: np.ndarray        # int32 [m]
    dst: np.ndarray        # int32 [m]
    prob: np.ndarray       # float64 [m] per-record transition probability
    features: Optional[np.ndarray] = None   # float32 [n, f]
    labels: Optional[np.ndarray] = None     # int64 [n], -1 = unlabeled
    name: str = ""

    @staticmethod
    def from_edge_input(path: str, name: str = "") -> "Graph":
        from .formats import read_edge_input
        n, src, dst, prob = read_edge_input(path)
        return Graph(n=n, src=src, dst=dst, prob=prob, name=name or path)

    @staticmethod
    def from_edge_index(n: int, edge_index: np.ndarray, name: str = "") -> "Graph":
        """From a ``[2, m]`` COO edge index (npy-triple datasets)."""
        src = edge_index[0].astype(np.int32)
        dst = edge_index[1].astype(np.int32)
        return Graph(n=n, src=src, dst=dst, prob=np.ones(len(src)), name=name)

    @staticmethod
    def from_scipy(adj: sp.spmatrix, name: str = "") -> "Graph":
        coo = adj.tocoo()
        return Graph(n=adj.shape[0], src=coo.row.astype(np.int32),
                     dst=coo.col.astype(np.int32),
                     prob=coo.data.astype(np.float64), name=name)

    def to_adjacency(self, binary: bool = True) -> sp.csr_matrix:
        """Collapse records to a CSR adjacency (duplicates summed or binarized)."""
        a = sp.csr_matrix((self.prob, (self.src, self.dst)), shape=(self.n, self.n))
        if binary:
            a.data = np.ones_like(a.data)
        return a

    def symmetrized(self, add_self_loops: bool = False) -> "Graph":
        """Undirected structural copy for uniform walks (gen.cpp:83-94).

        The records are ``src ++ dst (++ loops)`` and ``dst ++ src (++
        loops)``, each with probability 1, one self-loop a node with
        ``add_self_loops``: :meth:`padded_csr` then makes each row uniform
        over its multiset of records (duplicates stay duplicates).
        """
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        if add_self_loops:
            loops = np.arange(self.n, dtype=np.int32)
            src = np.concatenate([src, loops])
            dst = np.concatenate([dst, loops])
        return Graph(n=self.n, src=src.astype(np.int32), dst=dst.astype(np.int32),
                     prob=np.ones(len(src)), features=self.features,
                     labels=self.labels, name=self.name)

    def degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int32)

    def padded_csr(self, pad_to: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(nbr [n, D] int32, prob [n, D] float32, deg [n] int32)``.

        Records keep file order within a row. Padding slots point at the row
        node itself with probability 0, so a gather past the degree stays in
        bounds. Rows are renormalized to sum to 1; an isolated node becomes a
        pure self-loop.
        """
        deg = self.degrees()
        D = int(pad_to if pad_to is not None else max(1, deg.max(initial=1)))
        order = np.argsort(self.src, kind="stable")
        s, d, p = self.src[order], self.dst[order], self.prob[order]
        offsets = np.zeros(self.n + 1, np.int64)
        np.cumsum(deg, out=offsets[1:])
        nbr = np.tile(np.arange(self.n, dtype=np.int32)[:, None], (1, D))
        prob = np.zeros((self.n, D), np.float32)
        slot = np.arange(len(s)) - offsets[s]
        nbr[s, slot] = d
        prob[s, slot] = p.astype(np.float32)
        rowsum = prob.sum(axis=1, keepdims=True)
        prob = prob / np.where(rowsum > 0, rowsum, 1.0)
        prob[deg == 0, 0] = 1.0
        return nbr, prob, deg


@dataclasses.dataclass
class DeviceGraph:
    """The padded CSR as tensors on one device."""

    n: int
    max_deg: int
    nbr: torch.Tensor      # int32 [n, D]
    prob: torch.Tensor     # float32 [n, D], rows sum to 1
    deg: torch.Tensor      # int32 [n]

    @staticmethod
    def from_graph(g: Graph, device: Optional[Union[str, torch.device]] = None
                   ) -> "DeviceGraph":
        dev = resolve_device(device)
        nbr, prob, deg = g.padded_csr()
        return DeviceGraph(n=g.n, max_deg=nbr.shape[1],
                           nbr=torch.from_numpy(nbr).to(dev),
                           prob=torch.from_numpy(prob).to(dev),
                           deg=torch.from_numpy(deg).to(dev))
