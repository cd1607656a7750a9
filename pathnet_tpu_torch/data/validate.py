"""Input validation (port of ``pathnet_tpu/data/validate.py``).

The JAX package's numpy checks, copied so the port imports nothing of it.

The reference's only error handling is a FileNotFoundError hint and an
``exit(0)`` on an empty alias queue (SURVEY.md §5: PathNet_run.py:418-426,
gen_merw.cpp:84-87); a corrupt payload silently trains on garbage.  Here
every ingested artifact can be checked once, on the host, before it reaches
a device buffer — cheap O(n+m) numpy scans that turn a silent wrong answer
into an immediate, named error.

Used by ``registry.load_dataset`` (post-assembly).
"""
from __future__ import annotations

import numpy as np


class DataValidationError(ValueError):
    """An ingested artifact is structurally invalid (wrong shape/range/NaN)."""


def _fail(name: str, msg: str):
    raise DataValidationError(f"{name}: {msg}")


def validate_graph(g) -> None:
    """Structural checks for a host Graph: index ranges, finiteness,
    per-source probability mass (row sums ≈ an integer ≥ 1 — reference edge
    files carry each record once or twice; arbitrary positive mass is fine
    for our samplers but NaN/negative/zero-degree-with-mass is always a bug).
    """
    name = g.name or "graph"
    if g.n <= 0:
        _fail(name, f"n={g.n} must be positive")
    if len(g.src) != len(g.dst) or len(g.src) != len(g.prob):
        _fail(name, f"ragged edge arrays: src={len(g.src)} dst={len(g.dst)} "
                    f"prob={len(g.prob)}")
    if len(g.src):
        lo = min(int(g.src.min()), int(g.dst.min()))
        hi = max(int(g.src.max()), int(g.dst.max()))
        if lo < 0 or hi >= g.n:
            _fail(name, f"edge endpoint {lo if lo < 0 else hi} outside "
                        f"[0, {g.n})")
    if len(g.prob):
        if not np.isfinite(g.prob).all():
            _fail(name, "non-finite transition probability")
        if (np.asarray(g.prob) < 0).any():
            _fail(name, "negative transition probability")
    if g.features is not None:
        if g.features.shape[0] != g.n:
            _fail(name, f"features rows {g.features.shape[0]} != n={g.n}")
        if not np.isfinite(g.features).all():
            _fail(name, "non-finite feature value")
    if g.labels is not None:
        if g.labels.shape[0] != g.n:
            _fail(name, f"labels rows {g.labels.shape[0]} != n={g.n}")
        if (np.asarray(g.labels) < -1).any():
            _fail(name, "label below -1 (-1 is the only unlabeled marker)")


def validate_masks(name: str, n: int, *masks) -> None:
    """Split masks must be boolean [n] and pairwise disjoint."""
    total = np.zeros(n, np.int32)
    for i, m in enumerate(masks):
        m = np.asarray(m)
        if m.shape != (n,) or m.dtype != bool:
            _fail(name, f"mask {i}: shape {m.shape} dtype {m.dtype}, "
                        f"want bool[{n}]")
        total += m.astype(np.int32)
    if (total > 1).any():
        _fail(name, "train/val/test masks overlap")


def validate_path_tensor(name: str, nodes: np.ndarray, dists: np.ndarray,
                         n: int, walk_len: int) -> None:
    """An ingested path dump (``formats.parse_path_file``) must index real
    nodes and carry hop distances in [0, walk_len-1] (record grammar:
    SURVEY.md §2.1, gen_merw.cpp:188-206).
    """
    if nodes.shape != dists.shape or nodes.shape[-1] != walk_len:
        _fail(name, f"paths {nodes.shape} vs dists {dists.shape}, "
                    f"want trailing dim {walk_len}")
    if nodes.size == 0:
        _fail(name, "empty path tensor")
    if int(nodes.min()) < 0 or int(nodes.max()) >= n:
        _fail(name, f"path node id {int(nodes.min())}/{int(nodes.max())} "
                    f"outside [0, {n})")
    if int(dists.min()) < 0 or int(dists.max()) >= walk_len:
        _fail(name, f"hop distance outside [0, {walk_len})")
