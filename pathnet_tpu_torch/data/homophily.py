"""Homophily measures (port of ``pathnet_tpu/data/homophily.py``; reference:
baseline/Mixhop/homophily.py:7-40), host numpy in the JAX module's order.

- edge homophily: fraction of edges joining same-label endpoints;
- node homophily: mean over nodes of the same-label fraction of their
  neighborhood;
- class compatibility matrix: row-normalized label-to-label edge counts.

Self-loops and records with an unlabeled (negative) endpoint are left out.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph


def edge_homophily(g: Graph, y: np.ndarray) -> float:
    mask = g.src != g.dst
    s, d = g.src[mask], g.dst[mask]
    labeled = (y[s] >= 0) & (y[d] >= 0)
    if labeled.sum() == 0:
        return 0.0
    return float((y[s[labeled]] == y[d[labeled]]).mean())


def node_homophily(g: Graph, y: np.ndarray) -> float:
    same = np.zeros(g.n)
    deg = np.zeros(g.n)
    mask = (g.src != g.dst) & (y[g.src] >= 0) & (y[g.dst] >= 0)
    np.add.at(deg, g.src[mask], 1.0)
    np.add.at(same, g.src[mask], (y[g.src[mask]] == y[g.dst[mask]]).astype(float))
    has = deg > 0
    if not has.any():
        return 0.0
    return float((same[has] / deg[has]).mean())


def compatibility_matrix(g: Graph, y: np.ndarray, num_classes: int
                         ) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes))
    mask = (g.src != g.dst) & (y[g.src] >= 0) & (y[g.dst] >= 0)
    np.add.at(cm, (y[g.src[mask]], y[g.dst[mask]]), 1.0)
    rowsum = cm.sum(axis=1, keepdims=True)
    return cm / np.maximum(rowsum, 1.0)
