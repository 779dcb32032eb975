"""Tensor and data parallelism over a (data, model) mesh of
torch.distributed ranks (counterpart of easykv_tpu/parallel)."""
from .mesh import Mesh, init_distributed, make_mesh
from .sharding import (cache_pspecs, local_config, param_pspecs, param_pspecs_tree, shard_cache,
                       shard_params)

__all__ = [
    "Mesh",
    "cache_pspecs",
    "init_distributed",
    "local_config",
    "make_mesh",
    "param_pspecs",
    "param_pspecs_tree",
    "shard_cache",
    "shard_params",
]
