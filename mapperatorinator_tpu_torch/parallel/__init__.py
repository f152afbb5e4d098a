"""Multi-process training on ``torch.distributed``: the JAX package's
``parallel/`` (mesh, sharding, distributed) for the port. DDP on the data
axis, FSDP2 on the fsdp axis (HSDP beside a data axis); the tensor axis
raises."""

from .distributed import (  # noqa: F401
    make_global_batch,
    make_global_mesh,
    maybe_initialize,
    process_index,
    process_local_batch_size,
    shard_iterator_by_process,
    world_size,
)
from .mesh import make_mesh, replicate, shard_batch  # noqa: F401
from .sharding import describe_sharding, param_specs, shard_params  # noqa: F401
