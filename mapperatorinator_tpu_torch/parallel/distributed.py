"""Multi-process training: ``torch.distributed`` in place of the JAX
package's ``jax.distributed`` (``mapperatorinator_tpu/parallel/distributed.py``).

The reference trains multi-node with torchrun and NCCL DDP (SURVEY.md §2.7);
the JAX package joins processes with ``jax.distributed`` and spans one mesh
over them. The port goes back to the reference's shape: one process a card,
joined by a process group.

* :func:`maybe_initialize` joins this process to the group that
  ``parallel.coordinator_address=host:port parallel.num_processes=N
  parallel.process_id=i`` name (a no-op without an address), with the
  backend :func:`choose_backend` picks;
* :func:`make_global_mesh` spans a ``DeviceMesh`` over the group's ranks;
* :func:`process_local_batch_size` and :func:`shard_iterator_by_process`
  feed each data-parallel group its share of every batch, round-robin
  (the ranks of one tensor group the same rows).

Outside a process group every helper is a no-op, so a single-process run is
unchanged.
"""

from __future__ import annotations

import itertools
import os
import socket

import torch
import torch.distributed as dist


def world_size() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def choose_backend(device_type: str, num_processes: int, parallel_args=None) -> tuple[str, str]:
    """(backend, why), the one rule, stated once:

    * ``gloo`` on the CPU (``parallel.cpu_collectives`` names it, as the JAX
      field does);
    * ``nccl`` on CUDA when every rank on the host has a card of its own
      (rank i takes ``cuda:{i % device_count}``; the host's ranks are
      torchrun's ``LOCAL_WORLD_SIZE`` where it is set, else all
      ``num_processes``);
    * ``gloo`` when ranks share a card: NCCL refuses two ranks on one device.

    The choice is made once, before the group exists; nothing switches
    backend after a failure."""
    if device_type != "cuda":
        return (getattr(parallel_args, "cpu_collectives", None) or "gloo"), "the CPU"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", f"each of the host's {local} rank(s) has a card of its own ({cards} visible)"
    return "gloo", f"the host's {local} ranks share {cards} card(s), and NCCL refuses two ranks on one device"


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}`` on CUDA, else
    ``device`` itself."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", process_index() % torch.cuda.device_count())


def maybe_initialize(parallel_args=None, device_type: str = "cuda") -> bool:
    """Join the process group that ``parallel_args`` names and return
    whether one exists.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``, it calls ``init_process_group(init_method=
    "tcp://host:port", world_size=N, rank=i)`` with :func:`choose_backend`'s
    backend, printing the rule's choice; where only the address is given,
    N and i come from torchrun's ``WORLD_SIZE`` and ``RANK`` (the
    counterpart of JAX's auto-detection on a pod). Without an address it
    does nothing, and a second call does nothing either."""
    addr = getattr(parallel_args, "coordinator_address", None) if parallel_args is not None else None
    if not addr or dist.is_initialized():
        return dist.is_initialized()
    num_processes = getattr(parallel_args, "num_processes", None)
    process_id = getattr(parallel_args, "process_id", None)
    num_processes = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    process_id = int(process_id if process_id is not None else os.environ["RANK"])
    backend, why = choose_backend(device_type, num_processes, parallel_args)
    if device_type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    print(f"process {process_id} of {num_processes}: backend {backend} ({why})", flush=True)
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=num_processes, rank=process_id)
    return True


def make_global_mesh(parallel_args=None, device_type: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the process group (None without
    one), :func:`.mesh.make_mesh`'s layout. The leading (data) axis must be
    a multiple of the number of hosts, so that the inner axes stay inside
    one host: the JAX check, whose process is a host there, while here a
    process is a card."""
    if not dist.is_initialized():
        return None
    from .mesh import make_mesh

    mesh = make_mesh(parallel_args, device_type)
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    n_hosts = len(set(hosts))
    leading = mesh.shape[0]
    if leading % n_hosts != 0:
        raise ValueError(f"mesh leading (data) axis {leading} must be a multiple of the host count {n_hosts} so "
                         f"the inner axes stay inside one host")
    return mesh


def make_global_batch(local_batch: dict, device) -> dict:
    """This process's rows of the global batch as tensors on its device.

    The JAX function assembles one global array from every process's rows
    (``jax.make_array_from_process_local_data``). In torch each process
    holds only its rows and the collectives combine the results, so this is
    the local batch moved to the rank's device."""
    from ..train.step import to_device

    return to_device(local_batch, device)


def data_parallel_rank(parallel_args=None) -> tuple[int, int]:
    """(index, size) of this process among the data-parallel groups: the
    process index and count, or, where ``parallel.tensor_axis`` names an axis
    of ``parallel.mesh_shape``, this rank's place on the mesh's other axes
    (``init_device_mesh`` lays the ranks out row-major), so that the ranks of
    one tensor group share an index. The JAX functions read
    ``jax.process_index()``: there the tensor axis lies inside one process
    (``make_global_mesh``), while a port process is one card and its tensor
    axis spans processes."""
    n, i = world_size(), process_index()
    tensor = getattr(parallel_args, "tensor_axis", None)
    shape = getattr(parallel_args, "mesh_shape", None)
    if not tensor or shape is None or tensor not in parallel_args.axis_names:
        return i, n
    shape = [int(s) for s in shape]
    coords, rest = [], i
    for size in reversed(shape):
        coords.append(rest % size)
        rest //= size
    coords.reverse()
    index, size = 0, 1
    for name, c, s in zip(parallel_args.axis_names, coords, shape):
        if name != tensor:
            index, size = index * s + c, size * s
    return index, size


def process_local_batch_size(global_batch_size: int, parallel_args=None) -> int:
    """Rows this process feeds a step: ``global_batch_size`` over the
    data-parallel groups (:func:`data_parallel_rank`; the process count
    without a tensor axis), which must divide it."""
    _, n = data_parallel_rank(parallel_args)
    if global_batch_size % n != 0:
        raise ValueError(f"optim.batch_size={global_batch_size} must be divisible by the process count {n} for "
                         f"per-process feeding")
    return global_batch_size // n


def shard_iterator_by_process(it, parallel_args=None):
    """Data-parallel group i keeps every n-th example starting at i
    (:func:`data_parallel_rank`; the ``DistributedSampler`` equivalent for a
    streamed dataset): the ranks of one tensor group read the same rows. A
    no-op with one group."""
    i, n = data_parallel_rank(parallel_args)
    if n <= 1:
        return it
    return itertools.islice(it, i, None, n)
