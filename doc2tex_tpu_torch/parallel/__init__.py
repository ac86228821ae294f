"""The mesh of ranks: data-parallel batches, JAX's placement rules, and the
launchers (counterpart of ``doc2tex_tpu.parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    activation_mesh,
    batch_sharding,
    current_activation_mesh,
    lead,
    make_mesh,
    param_shardings,
    replicated_sharding,
    shard_activation,
    shard_batch,
    shard_params,
    spawn,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "activation_mesh",
    "batch_sharding",
    "current_activation_mesh",
    "lead",
    "make_mesh",
    "param_shardings",
    "replicated_sharding",
    "shard_activation",
    "shard_batch",
    "shard_params",
    "spawn",
]
