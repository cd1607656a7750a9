from .graph import Graph, DeviceGraph
from .formats import (
    read_edge_input,
    write_edge_input,
    parse_path_file,
    write_path_file,
    load_npy_dataset,
    load_planetoid,
)
from .splits import get_whole_mask, get_order, planetoid_masks, ratio_masks
from .synthetic import synthetic_features, synthetic_graph, attach_synthetic_payload
from .registry import DATASETS, load_dataset
from .validate import (DataValidationError, validate_graph, validate_masks,
                       validate_path_tensor)

__all__ = [
    "Graph",
    "DeviceGraph",
    "read_edge_input",
    "write_edge_input",
    "parse_path_file",
    "write_path_file",
    "load_npy_dataset",
    "load_planetoid",
    "get_whole_mask",
    "get_order",
    "planetoid_masks",
    "ratio_masks",
    "synthetic_features",
    "synthetic_graph",
    "attach_synthetic_payload",
    "DATASETS",
    "load_dataset",
    "DataValidationError",
    "validate_graph",
    "validate_masks",
    "validate_path_tensor",
]
