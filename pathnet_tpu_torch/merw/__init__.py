"""MERW transition probabilities (port of ``pathnet_tpu/merw``)."""
from .merw import (
    principal_eigenpair,
    merw_record_probs,
    merw_padded_probs,
    merw_graph,
    merw_graph_per_component,
    stationary_distribution,
    recover_integer_weights,
)

__all__ = [
    "principal_eigenpair",
    "merw_record_probs",
    "merw_padded_probs",
    "merw_graph",
    "merw_graph_per_component",
    "stationary_distribution",
    "recover_integer_weights",
]
