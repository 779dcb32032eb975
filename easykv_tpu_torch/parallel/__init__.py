"""Tensor and data parallelism over a (data, model) mesh of
torch.distributed ranks, and the 1-D sequence-parallel mesh of the ring
prefill (counterpart of easykv_tpu/parallel)."""
from .mesh import Mesh, SeqMesh, init_distributed, make_mesh, make_sp_mesh
from .sharding import (cache_pspecs, local_config, param_pspecs, param_pspecs_tree, shard_cache,
                       shard_params)

__all__ = [
    "Mesh",
    "SeqMesh",
    "cache_pspecs",
    "init_distributed",
    "local_config",
    "make_mesh",
    "make_sp_mesh",
    "param_pspecs",
    "param_pspecs_tree",
    "shard_cache",
    "shard_params",
]
