"""Hand-written CUDA kernels of the serving, training and probe paths, each beside its plain version.

| kernel | module | replaces (JAX) |
|---|---|---|
| K1 ``cdf_walk`` | ``kernels/cdf_walk.py`` | ``sample/alias.py:142-147`` ``CdfSampler.step``, scanned by ``sample/walk.py:36-55`` |
| K2 ``membership_dists`` | ``kernels/membership_dists.py`` | ``sample/distance.py:77-139`` |
| K1 + K2 ``walk_dists`` | ``kernels/walk_dists.py`` | both above in one launch (the sampler's path); ``cdf_walk`` and ``membership_dists`` run its device code |
| K3 ``pagg_encode_fwd`` | ``kernels/pagg_encode.py`` | ``models/pagg.py:235-303`` encode + readout (serving, and training with a dropout mask); two launches (``encode_walks``, ``readout``) behind one wrapper |
| K4 ``pagg_encode_bwd`` | ``kernels/pagg_encode_bwd.py`` | the VJP of ``models/pagg.py:235-303`` with the gather VJP ``:83-93``; three launches (``encode_walks_streams``, ``attention_bwd``, ``bptt``) behind one wrapper, then the weight ``contractions`` |
| ``segment_sum`` | ``kernels/segment_sum.py`` | the scatter-add of the gather VJP, ``models/pagg.py:83-93``: K4's row gradients into ``dh`` in a fixed order |
| K5 ``row_gather``, ``row_gather_bwd`` | ``kernels/row_gather.py`` | ``scripts/pallas_gather_probe.py:68``, the ``gather_fn`` of ``models/pagg.py:209,309`` |
| K6 ``lane_gather`` | ``kernels/lane_gather.py`` | ``scripts/pallas_gather_probe.py:68``, body ``lane_gather_axis1`` ``:45-50`` (the gather probe only) |

A wrapper takes the plain PyTorch version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; it never falls back. Each wrapper counts
its kernel launches in a plain integer attribute, ``launches``.
"""
from .cdf_walk import cdf_walk, cdf_walk_plain
from .lane_gather import lane_gather, lane_gather_plain
from .membership_dists import membership_dists, membership_dists_plain
from .pagg_encode import (encode_tile, encode_walks, encode_walks_plain,
                          pagg_encode_fwd, pagg_encode_fwd_plain, readout,
                          readout_plain)
from .pagg_encode_bwd import (attention_bwd, attention_bwd_plain, bptt, bptt_plain,
                              contractions, encode_walks_streams,
                              encode_walks_streams_plain, pagg_encode_bwd,
                              pagg_encode_bwd_plain, row_nodes)
from .row_gather import (row_gather, row_gather_bwd, row_gather_bwd_plain,
                         row_gather_plain)
from .segment_sum import segment_sum, segment_sum_plain
from .walk_dists import sorted_rows, walk_dists, walk_dists_plain

WRAPPERS = (cdf_walk, membership_dists, pagg_encode_fwd, pagg_encode_bwd,
            row_gather, row_gather_bwd, lane_gather, segment_sum, walk_dists)


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
           "bptt", "bptt_plain", "contractions", "row_nodes", "segment_sum",
           "segment_sum_plain", "walk_dists", "walk_dists_plain", "sorted_rows",
           "WRAPPERS", "reset_launch_counts", "launch_counts"]
