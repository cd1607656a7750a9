"""File readers and writers (port of ``pathnet_tpu/data/formats.py``), numpy only.

- **edge-input** ``.in`` text: header ``n m``, then one ``u v p`` line per
  directed edge record (reference: edge_input/cornell.in, written by
  preprocess/init_rw.py:81-86). ``p`` is the MERW transition probability
  P[u, v]; files may hold self-loops and duplicate records.
- **path text** dumps of the reference C++ samplers (gen_merw.cpp:182-207):
  one line a walk, ``[v0, ..., v_{L-1}, d0, ..., d_{L-1}]`` with ``d_i`` the
  0-based truncated-BFS hop distance of ``v_i`` from ``v0``; lines are
  epoch-major, node-major, walk-minor.
- **npy triples** ``{x,y,edge_index}.npy`` under ``other_data/<name>/``
  (reference: data_loader.py:122-140).
- **Geom-GCN** text files ``out1_graph_edges.txt`` and
  ``out1_node_feature_label.txt`` (reference: dataset.py:601-680).
- **Planetoid pickles** ``ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}``
  (reference: dataset.py:197-307).
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp


def read_edge_input(path: str) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Return ``(n, src, dst, prob)``: int32 records in file order, float64 probs.

    The header's edge count is a hint only; the records parsed win.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        n = int(header[0])
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if data.size == 0:
        return n, np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0)
    src = data[:, 0].astype(np.int32)
    dst = data[:, 1].astype(np.int32)
    prob = data[:, 2] if data.shape[1] > 2 else np.ones(len(src))
    hi = max(src.max(initial=-1), dst.max(initial=-1))
    if hi >= n or min(src.min(initial=0), dst.min(initial=0)) < 0:
        raise ValueError(f"{path}: node id {hi} out of range for declared n={n}")
    return n, src, dst, prob


def write_edge_input(path: str, n: int, src: np.ndarray, dst: np.ndarray,
                     prob: np.ndarray) -> None:
    """Write an edge-input file in the reference layout (init_rw.py:81-86)."""
    with open(path, "w") as f:
        f.write(f"{n} {len(src)}\n")
        for u, v, p in zip(src, dst, prob):
            f.write(f"{int(u)} {int(v)} {float(p)}\n")


# ---------------------------------------------------------------------------
# reference path-text dumps (for golden-parity tests and interop)
# ---------------------------------------------------------------------------

# '[' -> space, ']' -> ',' : turns the whole dump into one comma-separated
# number stream (a line's trailing ']' provides the separator to the next)
_PATH_TRANS = str.maketrans({"[": " ", "]": ","})


def parse_path_file(path: str, walk_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a reference sampler dump into ``(nodes, dists)`` int32 arrays.

    Shapes are ``[num_lines, walk_len]`` each; the caller reshapes to
    ``(epochs, n, num_walks, walk_len)`` (the reference reshapes at
    PathNet_run.py:310-313). Uniform dumps parse as one comma-separated
    number stream; anything else takes the line-by-line path, which names
    the first malformed line.
    """
    with open(path, "r") as f:
        txt = f.read()
    if txt:
        stream = txt.translate(_PATH_TRANS).strip(", \n\t")
        try:
            flat = np.array(stream.split(","), dtype=np.int64)
        except ValueError:
            flat = np.zeros(1, np.int64)  # odd size -> line path
    else:
        flat = np.zeros(0, np.int64)
    if flat.size % (2 * walk_len) == 0 and flat.size > 0:
        rec = flat.reshape(-1, 2 * walk_len)
        return (rec[:, :walk_len].astype(np.int32),
                rec[:, walk_len:].astype(np.int32))
    nodes, dists = [], []
    for lineno, line in enumerate(txt.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        try:
            vals = [int(tok) for tok in line[1:-1].split(",")]
        except ValueError as e:
            raise ValueError(
                f"{path}:{lineno}: malformed path record {line[:60]!r} "
                f"({e})") from None
        if len(vals) != 2 * walk_len:
            raise ValueError(
                f"{path}:{lineno}: record has {len(vals)} fields, expected "
                f"{2 * walk_len} (walk_len={walk_len}; grammar "
                f"gen_merw.cpp:188-206)")
        nodes.append(vals[:walk_len])
        dists.append(vals[walk_len:])
    return np.asarray(nodes, np.int32), np.asarray(dists, np.int32)


def write_path_file(path: str, nodes: np.ndarray, dists: np.ndarray) -> None:
    """Write walks in the reference text layout (one line per walk)."""
    nodes = nodes.reshape(-1, nodes.shape[-1])
    dists = dists.reshape(-1, dists.shape[-1])
    with open(path, "w") as f:
        for nv, dv in zip(nodes, dists):
            f.write("[" + ", ".join(str(int(x)) for x in nv) + ", "
                    + ", ".join(str(int(x)) for x in dv) + "]\n")


# ---------------------------------------------------------------------------
# npy triples (heterophily datasets: Nba / Electronics / bgp)
# ---------------------------------------------------------------------------

def load_npy_dataset(root: str, name: str
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Load ``{x,y,edge_index}.npy`` from ``root/name/``.

    Returns ``(x float32 [n, f], y int64 [n], edge_index int64 [2, m] or
    None)``.  Mirrors data_loader.py:122-131 (which ignores edge_index for
    training but we need it to build the graph).
    """
    d = os.path.join(root, name)
    x = np.load(os.path.join(d, "x.npy")).astype(np.float32)
    y = np.load(os.path.join(d, "y.npy")).astype(np.int64)
    ei_path = os.path.join(d, "edge_index.npy")
    edge_index = np.load(ei_path).astype(np.int64) if os.path.exists(ei_path) else None
    return x, y, edge_index


# ---------------------------------------------------------------------------
# Geom-GCN text format (chameleon / film / squirrel / texas / wisconsin)
# ---------------------------------------------------------------------------

def load_geomgcn(edge_path: str, feat_path: str
                 ) -> Tuple[sp.csr_matrix, np.ndarray, np.ndarray]:
    """Load the Geom-GCN text format (reference: dataset.py:601-680).

    ``out1_graph_edges.txt``: header line then ``u v`` per edge;
    ``out1_node_feature_label.txt``: header then ``id\\tf1,f2,...\\tlabel``.
    For the ``film`` dataset features are sparse index lists (931-dim
    one-hot multi-hot); detected by non-dense feature rows.

    Returns (symmetric binary adj csr, features float32 [n, f], labels int64).
    """
    rows = []
    with open(feat_path) as f:
        next(f)
        for line in f:
            idx, feat, label = line.strip().split("\t")
            rows.append((int(idx), feat, int(label)))
    n = max(r[0] for r in rows) + 1
    first = rows[0][1].split(",")
    dense = all("." in tok or tok in ("0", "1") for tok in first) and len(first) > 1
    # film: features are indices into a 931-dim space (dataset.py:641-655)
    if not dense and all(tok.isdigit() for tok in first):
        fdim = 931
        x = np.zeros((n, fdim), np.float32)
        for idx, feat, _ in rows:
            x[idx, [int(t) for t in feat.split(",")]] = 1.0
    else:
        fdim = len(first)
        x = np.zeros((n, fdim), np.float32)
        for idx, feat, _ in rows:
            x[idx] = [float(t) for t in feat.split(",")]
    y = np.full(n, -1, np.int64)
    for idx, _, label in rows:
        y[idx] = label
    es, ed = [], []
    with open(edge_path) as f:
        next(f)
        for line in f:
            u, v = line.split()[:2]
            es.append(int(u))
            ed.append(int(v))
    adj = sp.csr_matrix((np.ones(len(es), np.float32), (es, ed)), shape=(n, n))
    adj = adj.maximum(adj.T)
    adj.data = np.ones_like(adj.data)
    return adj, x, y


# ---------------------------------------------------------------------------
# Planetoid pickles (homophily datasets: cora / citeseer / pubmed)
# ---------------------------------------------------------------------------

def _pkl_load(f):
    if sys.version_info > (3, 0):
        return pickle.load(f, encoding="latin1")
    return pickle.load(f)


def _graph_dict_to_adj(graph: Dict[int, list]) -> sp.csr_matrix:
    """Adjacency from a {node: [neighbors]} dict, nodelist = range(len).

    Numpy-only replacement for the reference's
    ``nx.adjacency_matrix(nx.from_dict_of_lists(graph))`` (dataset.py:186-188):
    symmetric binary adjacency, no self-loop injection, duplicate neighbor
    entries collapsed to 1.
    """
    n = len(graph)
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    a = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n))
    a = a.maximum(a.T)
    a.data = np.ones_like(a.data)
    return a


def load_planetoid(dataset_str: str, dataset_path: str, val_size: Optional[int] = None):
    """Load a Kipf-style Planetoid pickle set with H2GCN split semantics.

    Reimplements dataset.py:197-307 including the citeseer isolated-node
    patch (:228-244) and val-mask sizing (:262-269).  Returns a dict with
    ``adj`` (csr), ``features`` (csr), ``labels`` (one-hot [n, c]),
    ``train_mask/val_mask/test_mask`` (bool [n]).
    """
    names = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    objs = []
    for nm in names:
        with open(os.path.join(dataset_path, f"{dataset_str}.{nm}"), "rb") as f:
            objs.append(_pkl_load(f))
    x, y, tx, ty, allx, ally, graph = objs
    with open(os.path.join(dataset_path, f"{dataset_str}.test.index")) as f:
        test_idx_reorder = [int(line.strip()) for line in f if line.strip()]
    test_idx_range = np.sort(test_idx_reorder)

    non_valid = set()
    full = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
    if len(full) != len(test_idx_range):
        # citeseer: isolated test nodes get zero rows (dataset.py:228-244)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - min(test_idx_range), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - min(test_idx_range), :] = ty
        ty = ty_ext
        non_valid = set(full) - set(test_idx_range)

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    adj = _graph_dict_to_adj(graph).astype(np.float32)

    labels = np.vstack((ally, ty))
    labels[test_idx_reorder, :] = labels[test_idx_range, :]
    non_valid = non_valid.union(set(np.where(labels.sum(1) == 0)[0].tolist()))

    n = labels.shape[0]
    train_mask = np.zeros(n, bool)
    train_mask[range(len(y))] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_idx_range.tolist()] = True
    val_mask = ~(train_mask | test_mask)
    if val_size is not None and val_mask.sum() > val_size:
        val_mask = np.zeros(n, bool)
        val_mask[range(len(y), len(y) + val_size)] = True
    for i in non_valid:
        train_mask[i] = False
        test_mask[i] = False
        val_mask[i] = False

    return {
        "adj": adj.tocsr(),
        "features": sp.csr_matrix(features),
        "labels": labels.astype(np.float32),
        "train_mask": train_mask,
        "val_mask": val_mask,
        "test_mask": test_mask,
    }
