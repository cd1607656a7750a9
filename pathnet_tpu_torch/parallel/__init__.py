"""The multi-device layer (port of ``pathnet_tpu/parallel``): ranks and
collectives (``comm``), the ring and sparse feature exchanges (``ring``,
``sparse``), data- and model-parallel training over the rank grid
(``mesh``), and the dry run on CPU ranks (``dryrun``)."""
from .comm import Axis, Grid, init, spawn
from .mesh import (FeatureExchange, ParamShards, param_shardings, shard_rows,
                   shard_state_dict, sharded_train_step, unshard_state_dict)
from .ring import make_ring_gather, pad_rows
from .sparse import exchange_comm_words, make_sparse_gather, make_sparse_gather_sharded

__all__ = ["Axis", "Grid", "init", "spawn", "FeatureExchange", "ParamShards",
           "param_shardings", "shard_rows", "shard_state_dict", "unshard_state_dict",
           "sharded_train_step", "make_ring_gather", "pad_rows", "exchange_comm_words",
           "make_sparse_gather", "make_sparse_gather_sharded"]
