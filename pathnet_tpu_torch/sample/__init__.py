from .alias import AliasSampler, CdfSampler, build_alias_tables
from .distance import (KhopTables, bfs_distance_table, bfs_distance_table_host,
                       build_khop_tables, khop_dists, membership_dists)
from .walk import PathSampler, sample_epoch, sample_paths

__all__ = ["CdfSampler", "AliasSampler", "build_alias_tables", "membership_dists",
           "PathSampler", "sample_paths", "sample_epoch", "KhopTables", "build_khop_tables",
           "khop_dists", "bfs_distance_table", "bfs_distance_table_host"]
