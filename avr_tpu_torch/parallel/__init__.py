"""Parallelism (port of ``avr_tpu/parallel``): the ``(data, rays)`` mesh of
ranks, the sharded train steps and the multi-process runtime."""

from avr_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicated,
    batch_sharding,
    ray_sharding,
    shard_train_inputs,
)
from avr_tpu_torch.parallel.sharded_step import (  # noqa: F401
    make_sharded_train_step,
    make_shardmap_train_step,
)
