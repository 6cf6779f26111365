from mcpx_torch.parallel.mesh import (
    batch_axes,
    make_hybrid_mesh,
    make_mesh,
    param_pspecs,
    kv_cache_pspecs,
    shard_pytree,
    data_pspec,
    replicated,
)

__all__ = [
    "batch_axes",
    "make_hybrid_mesh",
    "make_mesh",
    "param_pspecs",
    "kv_cache_pspecs",
    "shard_pytree",
    "data_pspec",
    "replicated",
]
