"""The device mesh and the data axis (the JAX ``parallel/mesh.py``).

The reference's multi-device strategy is DDP over NCCL (SURVEY.md §2.7);
the JAX package shards the batch on a mesh's ``data`` axis and replicates
the parameters, and XLA inserts the gradient psums. The port does what the
reference does: :func:`replicate` wraps the model in
``DistributedDataParallel``, whose hook sums the gradients over the ranks
(the loss already divides by the global count of labels,
:func:`..train.step.make_train_step`).

The JAX ``ensure_on_mesh`` has no counterpart: it places optimizer leaves
that optax created off the mesh, and here every optimizer buffer is made
beside its parameter (a local shard of it under FSDP), so none is ever off
its device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn


def make_mesh(parallel_args=None, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape ``parallel.mesh_shape`` with
    ``parallel.axis_names`` over the process group's ranks, one card (or
    CPU) a rank; all ranks on one ``data`` axis where no shape is given.
    The shape must hold exactly the group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if parallel_args is None or parallel_args.mesh_shape is None:
        shape, names = (world,), ("data",)
    else:
        shape, names = tuple(int(n) for n in parallel_args.mesh_shape), tuple(parallel_args.axis_names)
    if math.prod(shape) != world:
        raise ValueError(f"parallel.mesh_shape={list(shape)} holds {math.prod(shape)} devices, but the process "
                         f"group has {world} ranks (one device a rank)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def data_parallel_group(mesh, tensor_axis: Optional[str] = None):
    """The process group over which this rank's rows are spread: every
    rank with this rank's place on the tensor axis (the mesh's other axes
    flattened), or the whole group where there is no tensor axis. Every
    rank calls it: each of the subgroups is made by all of them."""
    if not tensor_axis:
        return dist.group.WORLD
    t_dim = tuple(mesh.mesh_dim_names).index(tensor_axis)
    ranks = mesh.mesh.movedim(t_dim, -1).reshape(-1, mesh.size(t_dim))
    group, _ = dist.new_subgroups_by_enumeration([ranks[:, c].tolist() for c in range(ranks.shape[1])])
    return group


def _sum_hook(group, bucket):
    """A DDP communication hook that sums each gradient bucket over the
    ranks, where DDP's own hook averages."""
    work = dist.all_reduce(bucket.buffer(), group=group, async_op=True)
    return work.get_future().then(lambda fut: fut.value()[0])


def replicate(model: nn.Module, device: torch.device) -> nn.Module:
    """``model`` wrapped in ``DistributedDataParallel`` on ``device`` (no
    device ids on the CPU), its gradients summed over the ranks. The wrapper
    runs the forward and backward; the model itself stays the one that is
    saved and optimised."""
    from torch.nn.parallel import DistributedDataParallel

    ddp = DistributedDataParallel(model, device_ids=[device] if device.type == "cuda" else None)
    ddp.register_comm_hook(None, _sum_hook)
    return ddp


def shard_batch(batch: dict, device) -> dict:
    """This process's rows on its device (each process already holds only
    its share of the batch: :func:`.distributed.make_global_batch`)."""
    from .distributed import make_global_batch

    return make_global_batch(batch, device)
