from .convert import baseline_params_from_jax, baseline_params_to_jax, bn_state_to_jax
from .ops import BatchNorm, EdgeGraph, gather_edges, segment_softmax, spmm
from .zoo import (BASELINES, EXTRA_MODELS, Baseline, BaselineSpec, build_baseline_graphs,
                  skeleton)

__all__ = ["BASELINES", "EXTRA_MODELS", "Baseline", "BaselineSpec", "BatchNorm",
           "EdgeGraph", "baseline_params_from_jax", "baseline_params_to_jax",
           "bn_state_to_jax", "build_baseline_graphs", "gather_edges",
           "segment_softmax", "skeleton", "spmm"]
