"""Adjacency transforms (port of ``pathnet_tpu/data/transforms.py``;
reference: dataset.py:33-160 TransformAdj / TransformSPAdj and the Chebyshev
helpers at :798-827).

Host-side scipy, as in the JAX package: these feed preprocessing and
analysis, not the hot path. The code is the JAX module's, in its order, so
the results are equal entry for entry.
"""
from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp


def add_self_loops(a: sp.spmatrix) -> sp.csr_matrix:
    a = a.tocsr() + sp.eye(a.shape[0], format="csr")
    a.data = np.minimum(a.data, 1.0)
    return a


def remove_self_loops(a: sp.spmatrix) -> sp.csr_matrix:
    a = a.tocsr().copy()
    a.setdiag(0)
    a.eliminate_zeros()
    return a


def sym_normalize(a: sp.spmatrix) -> sp.csr_matrix:
    """D^-1/2 A D^-1/2 (dataset.py:112-118 semantics)."""
    deg = np.asarray(a.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
    dinv[deg == 0] = 0.0
    d = sp.diags(dinv)
    return (d @ a @ d).tocsr()


def rw_normalize(a: sp.spmatrix) -> sp.csr_matrix:
    """D^-1 A (dataset.py:119-126 semantics)."""
    deg = np.asarray(a.sum(axis=1)).ravel()
    dinv = 1.0 / np.maximum(deg, 1e-12)
    dinv[deg == 0] = 0.0
    return (sp.diags(dinv) @ a).tocsr()


def laplacian(a: sp.spmatrix, normalized: bool = True) -> sp.csr_matrix:
    """L = D - A, or normalized I - D^-1/2 A D^-1/2 (dataset.py:88-101)."""
    if not normalized:
        deg = np.asarray(a.sum(axis=1)).ravel()
        return (sp.diags(deg) - a).tocsr()
    return (sp.eye(a.shape[0]) - sym_normalize(a)).tocsr()


def nhood(a: sp.spmatrix, k: int, include_self: bool = True) -> sp.csr_matrix:
    """Binary k-hop reachability (dataset.py:35-80 ``nhood``)."""
    base = add_self_loops(a) if include_self else a.tocsr()
    out = base.copy()
    for _ in range(k - 1):
        out = out @ base
    out.data = np.ones_like(out.data)
    return out.tocsr()


def nhood_split(a: sp.spmatrix, k: int) -> List[sp.csr_matrix]:
    """Exact-distance rings: list of strict h-hop adjacencies for h=1..k
    (dataset.py:141-160 ``nhoodSplit`` semantics)."""
    rings = []
    reached = add_self_loops(sp.csr_matrix(a.shape))   # identity
    cur = remove_self_loops(a)
    for _ in range(k):
        ring = cur - cur.multiply(reached)
        ring.eliminate_zeros()
        ring.data = np.ones_like(ring.data)
        rings.append(ring.tocsr())
        reached = reached + ring
        reached.data = np.ones_like(reached.data)
        cur = ring @ remove_self_loops(a)
        cur = remove_self_loops(cur)
    return rings


def chebyshev_polynomials(a: sp.spmatrix, k: int) -> List[sp.csr_matrix]:
    """Chebyshev basis T_0..T_k of the scaled Laplacian (dataset.py:798-827).

    Scaled by the largest Laplacian eigenvalue: L~ = 2L/lmax - I.
    """
    import scipy.sparse.linalg as spla

    lap = laplacian(a, normalized=True)
    lmax = float(spla.eigsh(lap, 1, which="LM",
                            return_eigenvectors=False)[0])
    scaled = (2.0 / lmax) * lap - sp.eye(a.shape[0])
    tks = [sp.eye(a.shape[0], format="csr"), scaled.tocsr()]
    for _ in range(2, k + 1):
        tks.append((2 * scaled @ tks[-1] - tks[-2]).tocsr())
    return tks
