"""Multi-process training on ``torch.distributed``: the JAX package's
``parallel/`` (mesh, sharding, distributed) for the port. DDP on the data
axis, FSDP2 on the fsdp axis (HSDP beside a data axis), Megatron column /
row parallelism on the tensor axis (:mod:`.tensor`)."""

from .distributed import (  # noqa: F401
    data_parallel_rank,
    make_global_batch,
    make_global_mesh,
    maybe_initialize,
    process_index,
    process_local_batch_size,
    shard_iterator_by_process,
    world_size,
)
from .mesh import data_parallel_group, make_mesh, replicate, shard_batch  # noqa: F401
from .sharding import describe_sharding, param_specs, shard_params, tensor_partial  # noqa: F401
