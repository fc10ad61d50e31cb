"""Parallelism of the port: device meshes over ``torch.distributed``,
sharding rules and the collectives a sharded forward issues, joining and
spawning ranks, the entry points' compute platforms (``launcher``), and
the ZMQ task fabric with its per-host worker (``fabric``, ``worker``). The counterpart of ``distllm_tpu.parallel``: a JAX mesh
is one program over many devices and XLA inserts the collectives; here a
rank is a process holding its slices, and the model code issues them
(``comm``)."""

from distllm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    MeshSpec,
    make_mesh,
)
from distllm_tpu_torch.parallel.sharding import (
    named_sharding,
    replicate,
    shard_pytree,
)

__all__ = [
    'DATA_AXIS',
    'MODEL_AXIS',
    'SEQ_AXIS',
    'EXPERT_AXIS',
    'MeshSpec',
    'make_mesh',
    'named_sharding',
    'replicate',
    'shard_pytree',
]
