"""Parameter sharding on the fsdp axis (the JAX ``parallel/sharding.py``).

The JAX package places each parameter with a ``NamedSharding`` chosen from
its shape and lets GSPMD insert the collectives. The port keeps its rule
(:func:`param_specs`: shard the largest dimension that the fsdp axis
divides, replicate a leaf where none does) and applies it with FSDP2's
``fully_shard`` (:func:`shard_params`): each encoder and decoder block,
then the root, each parameter sharded on the dimension the rule names (in
the torch layout of the flax dimension), and the leaves the rule replicates
left out of FSDP: the train step sums their gradients over the ranks
itself. On a 2-D ``(data, fsdp)`` mesh this is HSDP, sharded on ``fsdp``
and replicated on ``data``. Every rank trains on rows of its own, so the
reductions, FSDP's and the step's, sum over every rank; the loss divides
by the global count of labels.

The tensor axis (the Megatron column / row rules) needs attention on a
rank's share of the heads in every backbone family: it raises.

The helpers below let the optimizers treat a sharded parameter through its
local shard: :func:`local`, :func:`gathered` and :func:`shard_of`, and a
norm summed over the shards, :func:`sharded_norm`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from ..models.params import flax_paths

TENSOR_AXIS_ITEM = "ROADMAP queue 1, item 15 (b): the tensor axis, next"


def refuse_tensor_axis(tensor_axis: Optional[str]) -> None:
    if tensor_axis:
        raise NotImplementedError(f"parallel.tensor_axis={tensor_axis!r}: not ported yet ({TENSOR_AXIS_ITEM})")


def flax_shape(shape: Sequence[int], flax_path: str) -> tuple[int, ...]:
    """A parameter's shape in the flax layout (:func:`..models.params.flax_layout`)."""
    return tuple(reversed(shape)) if flax_path.endswith("/kernel") and len(shape) in (2, 3) else tuple(shape)


def torch_dim(flax_dim: int, ndim: int, flax_path: str) -> int:
    """The torch dimension of a flax dimension: a kernel's layout reverses
    its dimensions (Dense (in, out) -> Linear (out, in), Conv (k, in, out) ->
    Conv1d (out, in, k))."""
    return ndim - 1 - flax_dim if flax_path.endswith("/kernel") and ndim in (2, 3) else flax_dim


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or a given dict)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def param_specs(model: nn.Module, *, tensor_axis: Optional[str] = None, fsdp_axis: Optional[str] = None,
                mesh=None) -> dict[str, tuple]:
    """{flax path: partition spec as a tuple over the flax dimensions} for
    every parameter of ``model``, the JAX ``param_specs``' rule: with
    ``fsdp_axis``, the largest dimension (the first of equals) that the
    axis's size divides names the axis; a leaf with none is replicated,
    ``()``. ``mesh`` is a ``DeviceMesh`` or {axis name: size}."""
    refuse_tensor_axis(tensor_axis)
    sizes = axis_sizes(mesh)
    paths = flax_paths(model)
    specs = {}
    for name, param in model.named_parameters():
        path = paths[name]
        shape = flax_shape(param.shape, path)
        spec = ()
        if fsdp_axis is not None and len(shape) >= 1:
            size = sizes.get(fsdp_axis, 1)
            for dim in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[dim] % size == 0 and shape[dim] >= size:
                    spec = tuple(fsdp_axis if i == dim else None for i in range(len(shape)))
                    break
        specs[path] = spec
    return specs


def describe_sharding(specs: dict[str, tuple]) -> dict[str, int]:
    """Counts by spec, keyed as the JAX ``describe_sharding`` keys them
    (``str(PartitionSpec(...))``)."""
    counts: dict[str, int] = {}
    for spec in specs.values():
        key = f"PartitionSpec{tuple(spec)!r}"
        counts[key] = counts.get(key, 0) + 1
    return counts


def fsdp_blocks(model: nn.Module) -> list[nn.Module]:
    """The encoder and decoder blocks, each its own FSDP unit."""
    from ..models.transformer import DecoderLayer, EncoderLayer

    return [m for m in model.modules() if isinstance(m, (EncoderLayer, DecoderLayer))]


def shard_params(model: nn.Module, mesh, *, tensor_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None) -> list[nn.Parameter]:
    """Shard ``model`` in place with ``fully_shard`` on ``mesh`` by
    :func:`param_specs` and return the parameters it leaves replicated (the
    ones whose gradients the step sums by hand). ``mesh`` is 1-D (the fsdp
    axis alone, ZeRO-3) or 2-D with the fsdp axis last (HSDP: replicated on
    the first). FSDP's own gradient reduction sums, as DDP's hook does
    (:func:`.mesh.replicate`)."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    refuse_tensor_axis(tensor_axis)
    names = tuple(mesh.mesh_dim_names)
    if fsdp_axis is None or names[-1] != fsdp_axis or len(names) > 2:
        raise ValueError(f"parallel.fsdp_axis={fsdp_axis!r} must name the last axis of a 1-D or 2-D mesh, "
                         f"got axes {names}")
    specs = param_specs(model, fsdp_axis=fsdp_axis, mesh=mesh)
    paths = flax_paths(model)
    placement, replicated = {}, []
    for name, param in model.named_parameters():
        path = paths[name]
        spec = specs[path]
        if fsdp_axis in spec:
            placement[param] = Shard(torch_dim(spec.index(fsdp_axis), param.dim(), path))
        else:
            replicated.append(param)
    ignored = set(replicated)
    kwargs = dict(mesh=mesh, shard_placement_fn=lambda p: placement[p], ignored_params=ignored)
    for block in fsdp_blocks(model):
        fully_shard(block, **kwargs)
    fully_shard(model, **kwargs)
    for module in model.modules():
        if isinstance(module, FSDPModule):
            # a plain sum (gloo takes no PREMUL_SUM), divided by 1
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
    return replicated


# ---------------------------------------------------------------------------
# sharded tensors seen through their local shards
# ---------------------------------------------------------------------------


def is_sharded(t) -> bool:
    return isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view that in-place updates reach), or the
    tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def gathered(t: torch.Tensor, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The full tensor: a DTensor's, or that of the local shard ``t`` of a
    tensor laid out as the DTensor ``like`` (an all-gather over each shard
    axis of its mesh); ``t`` itself otherwise. It calls c10d's
    ``all_gather_into_tensor``, not ``DTensor.full_tensor``, whose
    functional collectives end the process (SIGSEGV) over gloo on CUDA
    tensors (torch 2.11)."""
    ref = t if isinstance(t, DTensor) else like
    if not is_sharded(ref):
        return t
    out = local(t).contiguous()
    for mesh_dim, p in enumerate(ref.placements):
        if p.is_shard():
            n = ref.device_mesh.size(mesh_dim)
            stacked = out.new_empty((n * out.shape[0], *out.shape[1:]))
            dist.all_gather_into_tensor(stacked, out, group=ref.device_mesh.get_group(mesh_dim))
            out = torch.cat(stacked.chunk(n), dim=p.dim)
    return out


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` in the layout of the DTensor ``like``
    (no collective: every placement divides evenly by :func:`param_specs`);
    ``full`` where ``like`` is not a DTensor."""
    if not isinstance(like, DTensor):
        return full
    coords = like.device_mesh.get_coordinate()
    for mesh_dim, p in enumerate(like.placements):
        if p.is_shard():
            full = full.chunk(like.device_mesh.size(mesh_dim), dim=p.dim)[coords[mesh_dim]]
    return full


def sharded_norm(tensors: Sequence[torch.Tensor], like: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The global L2 norm of tensors some of which are shards: each
    sharded tensor's (a DTensor, or a local shard laid out as the DTensor at
    its place in ``like``) squares are summed over its mesh's shard axes,
    every other tensor's counted once."""
    whole = sharded = None
    reduce_over = None
    for i, t in enumerate(tensors):
        ref = t if isinstance(t, DTensor) else like[i] if like is not None else None
        sq = local(t).float().pow(2).sum()
        if is_sharded(ref):
            sharded = sq if sharded is None else sharded + sq
            reduce_over = [ref.device_mesh.get_group(d) for d, p in enumerate(ref.placements) if p.is_shard()]
        else:
            whole = sq if whole is None else whole + sq
    if sharded is not None:
        for group in reduce_over:
            dist.all_reduce(sharded, group=group)
        whole = sharded if whole is None else whole + sharded
    return torch.sqrt(whole)


def any_sharded(tensors) -> bool:
    return any(is_sharded(t) for t in tensors)
