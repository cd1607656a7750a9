"""Maximal-entropy random walk (MERW) transition probabilities (port of
``pathnet_tpu/merw/merw.py``).

``P[u, v] = A[u, v] * psi[v] / (lambda * psi[u])`` from the principal
eigenpair ``(psi, lambda)`` of the (possibly weighted) symmetric adjacency.
As in the JAX package, the eigenpair of a connected graph comes from a power
iteration on the device, a padded SpMV over ``[n, max_deg]`` neighbour and
weight tables (no dense ``[n, n]`` matrix), in f32 by default; the per-record
and padded-CSR probabilities are assembled from it. Disconnected graphs, and
callers that repair a broken probability column (``force_log=True``), take
the host f64 log-space solver per component (``_log_psi_power``,
``merw_graph_per_component``), which keeps relative precision where psi
decays below 1e-15. ``recover_integer_weights`` rebuilds the integer
adjacency a reference ``.in`` column was made from. The host code is the JAX
module's numpy, in its order.

The power iteration's start vector is uniform in [0.1, 1.1) from an explicit
``torch.Generator`` (seed 0 by default). JAX draws it with threefry, which
torch cannot reproduce; both converge to the same Perron vector, so the
probabilities agree to the iteration's tolerance. The convergence test runs
on the device every iteration and freezes the vector once it has converged,
as JAX's ``while_loop`` stops; the host reads it only every
``CHECK_EVERY`` iterations to leave the loop.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..data.graph import DeviceGraph, Graph
from ..device import resolve_device

CHECK_EVERY = 32


def _power_iteration(nbr: torch.Tensor, w: torch.Tensor, v0: torch.Tensor,
                     iters: int, tol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant eigenpair of the weighted symmetric adjacency.

    ``nbr``/``w`` are padded neighbour/weight tables (padding weight 0). One
    SpMV gathers ``v`` at ``nbr`` and takes the weighted row sum. The loop
    stops after the first iteration whose largest change of the normalised
    vector is at most ``tol``, or after ``iters`` (JAX ``merw.py:38-69``).
    """
    rows = nbr.long()

    def spmv(v):
        return (v[rows] * w).sum(dim=1)

    v = v0 / torch.linalg.norm(v0)
    done = torch.zeros((), dtype=torch.bool, device=v.device)
    it = 0
    while it < iters:
        for _ in range(min(CHECK_EVERY, iters - it)):
            u = spmv(v)
            u = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
            delta = (u - v).abs().max()
            # eigenvector (not eigenvalue) convergence: the eigenvalue
            # plateaus well before psi on graphs with small spectral gaps
            v = torch.where(done, v, u)
            done = done | (delta <= tol)
            it += 1
        if bool(done):
            break
    lam = torch.dot(v, spmv(v)) / torch.dot(v, v)   # Rayleigh polish
    v = v.abs()                                      # Perron vector, fixed sign
    return v / torch.linalg.norm(v), lam


def _adjacency_csr(g: Graph, weights: Optional[np.ndarray] = None,
                   binary: bool = True) -> sp.csr_matrix:
    """Canonical deduplicated adjacency.

    With ``weights`` given, duplicate records sum (MERW probabilities are
    invariant to the uniform 2x that both-directions-twice reference files
    produce); otherwise ``binary=True`` collapses multiplicities to 1 (the
    reference's 0/1 adjacency).
    """
    data = weights if weights is not None else np.ones(len(g.src))
    a = sp.csr_matrix((data, (g.src, g.dst)), shape=(g.n, g.n))
    a.sum_duplicates()
    if binary and weights is None:
        a.data = np.ones_like(a.data)
    return a


def _padded_adjacency(a: sp.csr_matrix
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side padded (nbr, weight, deg) tables of a CSR adjacency."""
    n = a.shape[0]
    deg = np.diff(a.indptr).astype(np.int32)
    D = max(1, int(deg.max(initial=1)))
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, D))
    w = np.zeros((n, D), np.float32)
    slot = np.arange(len(a.indices)) - np.repeat(a.indptr[:-1], deg)
    rows = np.repeat(np.arange(n), deg)
    nbr[rows, slot] = a.indices.astype(np.int32)
    w[rows, slot] = a.data.astype(np.float32)
    return nbr, w, deg


def principal_eigenpair(g, weights: Optional[np.ndarray] = None,
                        binary: bool = True, iters: int = 1000,
                        tol: float = 1e-6, dtype: torch.dtype = torch.float32,
                        device: Optional[Union[str, torch.device]] = None,
                        generator: Optional[torch.Generator] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(psi, lambda)`` of the symmetric adjacency of ``g``, on ``device``
    (``None``: the CUDA card).

    ``g`` may be a host Graph (weighted adjacency supported via ``weights``,
    aligned with record order) or a DeviceGraph (binary structure of the
    padded table; duplicate records collapse on host). ``generator`` draws
    the start vector (default: seed 0 on ``device``).
    """
    dev = resolve_device(device)
    if isinstance(g, DeviceGraph):
        deg = g.deg.cpu().numpy()
        nbr_np = g.nbr.cpu().numpy()
        mask = np.arange(g.max_deg)[None, :] < deg[:, None]
        g = Graph(n=g.n,
                  src=np.repeat(np.arange(g.n, dtype=np.int32), deg),
                  dst=nbr_np[mask].astype(np.int32),
                  prob=np.ones(int(deg.sum())))
    a = _adjacency_csr(g, weights, binary)
    nbr, w, _ = _padded_adjacency(a)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    v0 = torch.rand(g.n, generator=generator, device=dev, dtype=dtype) + 0.1
    return _power_iteration(torch.from_numpy(nbr).to(dev),
                            torch.from_numpy(w).to(device=dev, dtype=dtype),
                            v0, iters, tol)


def merw_record_probs(g: Graph, psi: np.ndarray, lam: float,
                      weights: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-record MERW probabilities aligned with ``g.src/g.dst`` order:
    ``P[u, v] = A[u, v] * psi[v] / (lambda * psi[u])``.

    ``A``/``lambda`` must be consistent: entries come from the same
    deduplicated adjacency the eigenpair was computed on (duplicate records
    of a pair all receive the pair's full probability, as in the reference
    files).
    """
    psi = np.asarray(psi, np.float64)
    # per-record adjacency entries without scipy fancy indexing (which is
    # O(minutes) for millions of records): group duplicate (u, v) records
    # via packed-key unique + bincount.
    key = g.src.astype(np.int64) * g.n + g.dst.astype(np.int64)
    _, inv = np.unique(key, return_inverse=True)
    data = weights if weights is not None else np.ones(len(g.src))
    if weights is None:
        a_uv = np.ones(len(g.src))                 # binary adjacency
    else:
        a_uv = np.bincount(inv, weights=data)[inv]  # duplicate records sum
    return a_uv * psi[g.dst] / (float(lam) * psi[g.src])


def merw_padded_probs(dg: DeviceGraph, psi: torch.Tensor, lam: torch.Tensor
                      ) -> torch.Tensor:
    """Padded-CSR MERW transition table ``P[u, j] ∝ psi[nbr[u, j]]/psi[u]``.

    Rows renormalized (guards truncation error); padding slots get 0;
    isolated nodes become pure self-loops.
    """
    slots = torch.arange(dg.max_deg, device=psi.device)[None, :]
    mask = slots < dg.deg[:, None]
    p = torch.where(mask, psi[dg.nbr.long()]
                    / (lam * torch.clamp(psi[:, None], min=1e-30)),
                    torch.zeros((), dtype=psi.dtype, device=psi.device))
    rowsum = p.sum(dim=1, keepdim=True)
    p = p / torch.clamp(rowsum, min=1e-30)
    return torch.where(dg.deg[:, None] > 0, p, (slots == 0).to(psi.dtype))


def stationary_distribution(psi: torch.Tensor) -> torch.Tensor:
    """MERW stationary distribution pi = psi^2 (compute_merw.py:121)."""
    pi = psi * psi
    return pi / pi.sum()


def merw_graph(g: Graph, weights: Optional[np.ndarray] = None,
               iters: int = 3000, tol: float = 1e-6,
               device: Optional[Union[str, torch.device]] = None,
               generator: Optional[torch.Generator] = None) -> Graph:
    """Structure in, Graph with MERW record probs out; the eigenpair on
    ``device`` (``None``: the CUDA card).

    Equivalent of the ``init_rw.py`` CLI step (load structure, compute MERW,
    write ``<name>_nsl.in``) without the filesystem round-trip.
    """
    psi, lam = principal_eigenpair(g, weights=weights, iters=iters, tol=tol,
                                   device=device, generator=generator)
    probs = merw_record_probs(g, psi.cpu().numpy(), float(lam), weights)
    return Graph(n=g.n, src=g.src, dst=g.dst, prob=probs,
                 features=g.features, labels=g.labels, name=g.name)


def _log_psi_power(a: sp.csr_matrix, iters: int = 5000, tol: float = 1e-12
                   ) -> Tuple[np.ndarray, float]:
    """Principal eigenvector in LOG space: (log psi, lambda).

    The Perron vector of a graph with spectral radius lambda decays like
    lambda**-dist(core) — down to 1e-19 and beyond on real graphs (cora).
    Any linear-space solver (LAPACK eigh, ARPACK, plain power iteration)
    computes psi to ~1e-15 *absolute*, so the decay tail is pure noise and
    the assembled MERW rows there are garbage — this is precisely the defect
    in the reference's checked-in probability files.  Iterating
    ``log v <- row_logsumexp(log A + log v)`` keeps full relative precision
    at every scale.  A ``+I`` shift makes bipartite components converge
    (same eigenvectors, lambda+1).
    """
    n = a.shape[0]
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    logA = np.log(a.data.astype(np.float64))
    logv = np.zeros(n)
    loglam = 0.0
    for _ in range(iters):
        contrib = np.concatenate([logA + logv[a.indices], logv])  # +I shift
        r = np.concatenate([rows, np.arange(n)])
        mx = np.full(n, -np.inf)
        np.maximum.at(mx, r, contrib)
        s = np.zeros(n)
        np.add.at(s, r, np.exp(contrib - mx[r]))
        new = mx + np.log(s)
        delta = new - logv
        loglam = float(np.median(delta))
        logv = new - new.max()
        if float(np.ptp(delta)) < tol:
            break
    return logv, float(np.exp(loglam) - 1.0)


def merw_graph_per_component(g: Graph, weights: Optional[np.ndarray] = None,
                             iters: int = 3000, tol: float = 1e-6,
                             dense_max: int = 4096,
                             force_log: bool = False,
                             device: Optional[Union[str, torch.device]] = None,
                             generator: Optional[torch.Generator] = None) -> Graph:
    """MERW of a disconnected graph — computed per connected component.

    The reference computes ONE global ARPACK eigenvector
    (compute_merw.py:111) and assembles P from it even when the graph is
    disconnected; on minor components psi is ~0 / sign-flipped noise and the
    emitted probability columns go negative with rows that no longer sum
    to 1 — the checked-in ``cora_nsl.in`` / ``citeseer.in`` exhibit exactly
    this (516 / 656 negative records, row-sum deviations up to 93).  MERW of
    a disconnected graph is defined per component; each component here gets
    its own principal eigenpair, yielding a proper stochastic matrix
    everywhere.  Every component goes through the host f64 log-space solver
    (``dense_max`` is accepted for the JAX signature and unused there too);
    only a connected graph without ``force_log`` takes :func:`merw_graph` on
    ``device`` (``None``: the CUDA card).
    """
    a = _adjacency_csr(g, weights, binary=weights is None)
    ncomp, comp = sp.csgraph.connected_components(a, directed=False)
    if ncomp == 1 and not force_log:
        # single-component fast path: float32 device power iteration.  Its
        # absolute-precision decay tail is fine for *sampling* (tail probs
        # round to 0), but callers recomputing broken probability columns
        # must pass force_log=True to run the log-space solver even when
        # connected (ADVICE r3 #3).
        return merw_graph(g, weights=weights, iters=iters, tol=tol,
                          device=device, generator=generator)
    probs = np.zeros(len(g.src))
    for c in range(ncomp):
        nodes = np.flatnonzero(comp == c)
        m = (comp[g.src] == c) & (comp[g.dst] == c)
        if not m.any():
            continue                       # isolated node with no records
        remap = np.zeros(g.n, np.int64)
        remap[nodes] = np.arange(len(nodes))
        sub = Graph(n=len(nodes), src=remap[g.src[m]].astype(np.int32),
                    dst=remap[g.dst[m]].astype(np.int32),
                    prob=np.ones(int(m.sum())))
        w_sub = weights[m] if weights is not None else None
        asub = _adjacency_csr(sub, w_sub, binary=w_sub is None)
        logpsi, lam = _log_psi_power(asub, iters=max(iters, 2000))
        if lam <= 0:                       # edgeless component (paranoia)
            continue
        # P[u,.] = normalize(A[u,.] * psi), assembled from LOG psi
        # differences — neighbor psi ratios are O(lambda*deg), so this stays
        # fully precise even where psi itself underflows to 1e-300.
        key_s = sub.src.astype(np.int64) * sub.n + sub.dst.astype(np.int64)
        _, inv_s = np.unique(key_s, return_inverse=True)
        data = w_sub if w_sub is not None else np.ones(len(sub.src))
        a_uv = (np.bincount(inv_s, weights=data)[inv_s] if w_sub is not None
                else np.ones(len(sub.src)))
        lp = np.log(a_uv) + logpsi[sub.dst]
        # segmented logsumexp over rows for exact normalization
        mx = np.full(sub.n, -np.inf)
        np.maximum.at(mx, sub.src, lp)
        _, sfirst = np.unique(key_s, return_index=True)
        ssum = np.zeros(sub.n)
        np.add.at(ssum, sub.src[sfirst],
                  np.exp(lp[sfirst] - mx[sub.src[sfirst]]))
        probs[m] = np.exp(lp - mx[sub.src] - np.log(ssum[sub.src]))
    return Graph(n=g.n, src=g.src, dst=g.dst, prob=probs,
                 features=g.features, labels=g.labels, name=g.name)


def recover_integer_weights(g: Graph, probs: np.ndarray, max_weight: int = 8
                            ) -> np.ndarray:
    """Recover integer adjacency multiplicities from a MERW probability column.

    Given record probabilities produced by some integer-weighted adjacency,
    estimate ``A[u, v] = round(P[u, v] * lambda * psi[u] / psi[v])`` using
    the binary-adjacency eigenpair as a first-order proxy.  Used to
    round-trip reference ``.in`` files whose source adjacency is lost.
    """
    # psi-FREE estimator: P[u,v]*P[v,u] = (A[u,v]/lam)^2, so the eigenvector
    # (including its noise-dominated decay tail — see _log_psi_power) cancels
    # exactly.  A is integer and mostly 1, so lam = 1/median(sqrt(prod)).
    # A psi-ratio estimator (probs*lam*psi_u/psi_v) hallucinates weights
    # from tail noise, and a few spurious heavy edges relocalize the
    # eigenvector and corrupt *every* probability (observed on cora).
    s64, d64 = g.src.astype(np.int64), g.dst.astype(np.int64)
    canon = np.minimum(s64, d64) * g.n + np.maximum(s64, d64)
    dkey = s64 * g.n + d64
    _, dfirst = np.unique(dkey, return_index=True)   # drop duplicate records
    _, inv = np.unique(canon, return_inverse=True)
    inv_u = inv[dfirst]
    p_u = np.abs(probs[dfirst])                      # sign flips are psi noise
    # only trust a pair's product when BOTH endpoint rows are approximately
    # stochastic (the registry's row-sum test): a pair whose two directional
    # records are both psi-noise can coincidentally produce a near-integer
    # a>=1 and be assigned a spurious heavy weight (ADVICE r3 #2)
    rowsum = np.zeros(g.n)
    np.add.at(rowsum, g.src[dfirst], probs[dfirst])
    row_ok = np.abs(rowsum - 1.0) < 1e-2
    good = (p_u > 1e-12) & row_ok[g.src[dfirst]] & row_ok[g.dst[dfirst]]
    sumlog = np.bincount(inv_u[good], weights=np.log(p_u[good]),
                         minlength=inv.max() + 1)
    ndir = np.bincount(inv_u[good], minlength=inv.max() + 1)
    selfloop = np.zeros(inv.max() + 1, bool)
    selfloop[inv[g.src == g.dst]] = True
    # sqrt(P_uv*P_vu) for 2-directional pairs; P itself for self-loops
    sqrtprod = np.where(selfloop, np.exp(sumlog),
                        np.exp(0.5 * sumlog))
    ok = (ndir == 2) | (selfloop & (ndir == 1))
    lam_f = 1.0 / np.median(sqrtprod[ok & ~selfloop]) if (
        ok & ~selfloop).any() else 1.0
    a = lam_f * sqrtprod
    w_pair = np.where(ok & (np.abs(a - np.round(a)) < 0.1)
                      & (np.round(a) >= 1),
                      np.round(a), 1.0)
    return np.clip(w_pair[inv], 1, max_weight).astype(np.float64)
