from .alias import CdfSampler
from .distance import (KhopTables, bfs_distance_table, bfs_distance_table_host,
                       build_khop_tables, khop_dists, membership_dists)
from .walk import PathSampler, sample_paths

__all__ = ["CdfSampler", "membership_dists", "PathSampler", "sample_paths", "KhopTables",
           "build_khop_tables", "khop_dists", "bfs_distance_table", "bfs_distance_table_host"]
