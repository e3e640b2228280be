"""The device mesh (``mesh.py``) and the trainer's ``model`` axis
(``tensor.py``): data parallelism over a (data, model) grid of devices,
the counterpart of the JAX package's ``parallel`` package."""

from video_desensitization_torch.parallel.mesh import (
    batch_sharding,
    data_parallel_program,
    distributed_init,
    make_mesh,
    replicated,
    shard_batch,
    shard_batch_multihost,
    shard_params,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "data_parallel_program",
    "distributed_init",
    "replicated",
    "shard_batch",
    "shard_batch_multihost",
    "shard_params",
]
