"""Hand-written CUDA kernels of the serving, training and probe paths, each beside its plain version.

| kernel | module | replaces (JAX) |
|---|---|---|
| K1 ``cdf_walk`` | ``kernels/cdf_walk.py`` | ``sample/alias.py:142-147`` ``CdfSampler.step``, scanned by ``sample/walk.py:36-55`` |
| K2 ``membership_dists`` | ``kernels/membership_dists.py`` | ``sample/distance.py:77-139`` |
| K1 + K2 ``walk_dists`` | ``kernels/walk_dists.py`` | both above in one launch (the sampler's path at ``walk_len <= 4``); ``cdf_walk`` and ``membership_dists`` run its device code |
| K7 ``khop_dists`` | ``kernels/khop_dists.py`` | ``sample/distance.py:194-229`` (``_row_membership``, ``khop_dists``): the k-hop distances of given walks, any walk length |
| K1 + K7 ``walk_khop_dists`` | ``kernels/khop_dists.py`` | K1's walk and K7 in one launch (the sampler's path at ``walk_len >= 5``, the ``khop`` backend) |
| K8 ``alias_walk`` | ``kernels/alias_walk.py`` | ``sample/alias.py:93-104`` ``AliasSampler.step``, scanned by ``sample/walk.py:36-55`` (the alias tables' walks alone: the dense, host and ``none`` backends, ``sample_paths``) |
| K8 + K2 ``alias_walk_dists`` | ``kernels/walk_dists.py`` | K8's walk and K2 in one launch (the sampler's path with the alias tables at ``walk_len <= 4``) |
| K8 + K7 ``alias_walk_khop_dists`` | ``kernels/khop_dists.py`` | K8's walk and K7 in one launch (the alias tables past ``walk_len`` 4) |
| K3 ``pagg_encode_fwd`` | ``kernels/pagg_encode.py`` | ``models/pagg.py:235-307`` encode + readout (serving, and training with a dropout mask; hetero and homo, ``homo=True``; the LSTM or the GRU, ``cell``; the attention, mean or sum readout, ``agg``); two launches (``encode_walks``, ``readout``) behind one wrapper |
| K4 ``pagg_encode_bwd`` | ``kernels/pagg_encode_bwd.py`` | the VJP of ``models/pagg.py:235-307`` with the gather VJP ``:83-93``; three launches (``encode_walks_streams``, ``attention_bwd``, ``bptt``) behind one wrapper, then the weight ``contractions`` (``pagg_contract``); every variant, cell and readout of K3 |
| ``pagg_contract`` | ``kernels/pagg_encode_bwd.py`` | the weight part of that VJP: ``_dist_select``'s (``pagg.py:150-176``), the cells' (``nn/cells.py:22,49``) and the MLP head's (``pagg.py:185-186``) weight gradients from K4's streams (K4's ``contractions``) |
| ``segment_sum`` | ``kernels/segment_sum.py`` | the scatter-add of the gather VJP, ``models/pagg.py:83-93``: K4's row gradients into ``dh`` in a fixed order |
| K5 ``row_gather``, ``row_gather_bwd`` | ``kernels/row_gather.py`` | ``scripts/pallas_gather_probe.py:68``, the ``gather_fn`` of ``models/pagg.py:209,309`` |
| K6 ``lane_gather`` | ``kernels/lane_gather.py`` | ``scripts/pallas_gather_probe.py:68``, body ``lane_gather_axis1`` ``:45-50`` (the gather probe only) |
| S1 ``spmm``, S2 ``edge_dot`` | ``kernels/spmm.py`` | ``models/baselines/ops.py:68-73`` and the per-head message sums of ``zoo.py:330-331,390-391,450-452`` (the baseline zoo), with their VJPs |
| S3 ``segment_softmax``, S4 ``segment_softmax_bwd`` | ``kernels/segment_softmax.py`` | ``models/baselines/ops.py:76-82`` per head (``zoo.py:327-328,447-448``) and its VJP |

A wrapper takes the plain PyTorch version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; it never falls back. Each wrapper counts
its kernel launches in a plain integer attribute, ``launches``.
"""
from .alias_walk import alias_walk, alias_walk_plain
from .cdf_walk import cdf_walk, cdf_walk_plain
from .khop_dists import (KhopTables, alias_walk_khop_dists, alias_walk_khop_dists_plain,
                         khop_dists, khop_dists_plain, walk_khop_dists, walk_khop_dists_plain)
from .lane_gather import lane_gather, lane_gather_plain
from .membership_dists import membership_dists, membership_dists_plain
from .pagg_encode import (encode_tile, encode_walks, encode_walks_plain,
                          pagg_encode_fwd, pagg_encode_fwd_plain, readout,
                          readout_plain)
from .pagg_encode_bwd import (attention_bwd, attention_bwd_plain, bptt, bptt_plain,
                              contract_route, contractions, contractions_plain,
                              encode_walks_streams,
                              encode_walks_streams_plain, pagg_contract, pagg_encode_bwd,
                              pagg_encode_bwd_plain, row_nodes)
from .row_gather import (row_gather, row_gather_bwd, row_gather_bwd_plain,
                         row_gather_plain)
from .segment_softmax import (segment_softmax, segment_softmax_bwd, segment_softmax_bwd_plain,
                              segment_softmax_plain)
from .segment_sum import segment_sum, segment_sum_plain
from .spmm import edge_dot, edge_dot_plain, spmm, spmm_plain
from .walk_dists import (alias_walk_dists, alias_walk_dists_plain, sorted_rows, walk_dists,
                         walk_dists_plain)

WRAPPERS = (cdf_walk, membership_dists, pagg_encode_fwd, pagg_encode_bwd,
            row_gather, row_gather_bwd, lane_gather, segment_sum, walk_dists, khop_dists,
            walk_khop_dists, alias_walk, alias_walk_dists, alias_walk_khop_dists, spmm, edge_dot,
            segment_softmax, segment_softmax_bwd, pagg_contract)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["cdf_walk", "cdf_walk_plain", "membership_dists",
           "membership_dists_plain", "pagg_encode_fwd", "pagg_encode_fwd_plain",
           "pagg_encode_bwd", "pagg_encode_bwd_plain", "row_gather",
           "row_gather_plain", "row_gather_bwd", "row_gather_bwd_plain",
           "lane_gather", "lane_gather_plain", "encode_walks", "encode_walks_plain",
           "readout", "readout_plain", "encode_tile", "encode_walks_streams",
           "encode_walks_streams_plain", "attention_bwd", "attention_bwd_plain",
           "bptt", "bptt_plain", "contract_route", "contractions", "contractions_plain",
           "pagg_contract",
           "row_nodes", "segment_sum",
           "segment_sum_plain", "walk_dists", "walk_dists_plain", "sorted_rows",
           "KhopTables", "khop_dists", "khop_dists_plain", "walk_khop_dists",
           "walk_khop_dists_plain", "alias_walk", "alias_walk_plain", "alias_walk_dists",
           "alias_walk_dists_plain", "alias_walk_khop_dists", "alias_walk_khop_dists_plain",
           "spmm", "spmm_plain", "edge_dot", "edge_dot_plain", "segment_softmax",
           "segment_softmax_plain", "segment_softmax_bwd", "segment_softmax_bwd_plain",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]
