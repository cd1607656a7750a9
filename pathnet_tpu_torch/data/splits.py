"""Train/val/test split generation (port of ``pathnet_tpu/data/splits.py:26-92``).

The JAX package's numpy code, copied so the port imports nothing of it; the
masks are exactly the JAX package's for the same seeds.

Two regimes (PathNet_run.py:437-454):

- **Heterophily** (Nba/Electronics/bgp/new data): per-round random 48/32/20
  split over labeled nodes, seeded ``round + 1``, produced by
  ``get_whole_mask`` (data_loader.py:74-119).  We reproduce the *exact*
  masks: the reference shuffles with Python's ``random.shuffle`` (Mersenne
  Twister), so we use the stdlib RNG with the same seed to stay
  bit-identical with reference splits.
- **Homophily** (cora/citeseer/pubmed/cornell): 10 fixed H2GCN split
  directories of re-pickled Planetoid data; the split semantics live in
  the Planetoid loader (formats.load_planetoid).  ``planetoid_masks``
  regenerates H2GCN-style random splits when the original split files are
  unavailable (they are absent from the reference snapshot,
  .MISSING_LARGE_BLOBS:13).
"""
from __future__ import annotations

import random as _pyrandom
from typing import List, Tuple

import numpy as np


def get_order(ratio: List[int], masked_index: np.ndarray, total_node_num: int,
              seed: int = 1234567) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffled ratio split of ``masked_index`` (data_loader.py:74-102).

    Returns boolean masks over ``total_node_num`` nodes.  Uses Python's
    stdlib Mersenne-Twister shuffle so masks match the reference exactly for
    a given seed.
    """
    rng = _pyrandom.Random(seed)
    m = len(masked_index)
    order = list(range(m))
    rng.shuffle(order)
    tvt_sum = sum(ratio)
    train_end = int(ratio[0] / tvt_sum * m)
    val_end = train_end + int(ratio[1] / tvt_sum * m)
    masks = []
    for lo, hi in ((0, train_end), (train_end, val_end), (val_end, m)):
        mask = np.zeros(total_node_num, bool)
        mask[masked_index[order[lo:hi]]] = True
        masks.append(mask)
    return tuple(masks)


def get_whole_mask(y: np.ndarray, ratio: List[int] = [48, 32, 20],
                   seed: int = 1234567):
    """48/32/20 split over labeled (``y != -1``) nodes (data_loader.py:105-119)."""
    labeled = np.flatnonzero(np.asarray(y) != -1)
    return get_order(ratio, labeled, len(y), seed)


def planetoid_masks(n: int, num_train: int, val_size: int, test_size: int,
                    seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """H2GCN-style random split stand-in when fixed split files are missing.

    The original fixed splits draw 48%/32%/20% of nodes per split directory;
    here we draw ``num_train``/``val_size``/``test_size`` disjoint index sets
    from a seeded numpy permutation.  Deterministic per (n, seed).
    """
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    train = np.zeros(n, bool)
    val = np.zeros(n, bool)
    test = np.zeros(n, bool)
    train[perm[:num_train]] = True
    val[perm[num_train:num_train + val_size]] = True
    test[perm[num_train + val_size:num_train + val_size + test_size]] = True
    return train, val, test


def ratio_masks(n: int, seed: int, ratio=(0.48, 0.32, 0.20),
                val_size=None):
    """Convenience: ratio-based split over all nodes with a numpy seed.

    ``val_size`` overrides the ratio-derived validation count with the
    dataset's documented fixed-split size (dataset.json: cornell 59,
    cora 1019, citeseer 1879, pubmed 6310); test keeps the 20% fraction and
    train takes the remainder (the exact H2GCN split files are absent from
    the snapshot, .MISSING_LARGE_BLOBS:13)."""
    if val_size is None:
        num_train = int(ratio[0] * n)
        val_size = int(ratio[1] * n)
        test_size = n - num_train - val_size
    else:
        test_size = int(round(ratio[2] * n))
        val_size = min(val_size, n - test_size - 1)
        num_train = n - val_size - test_size
    return planetoid_masks(n, num_train, val_size, test_size, seed)
