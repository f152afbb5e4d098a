"""Parameter sharding on the tensor and fsdp axes (the JAX
``parallel/sharding.py``).

The JAX package places each parameter with a ``NamedSharding`` chosen from
its path and shape and lets GSPMD insert the collectives. The port keeps
its rule (:func:`param_specs`, leaf for leaf): on the tensor axis, a 2-D
``kernel`` of ``wq``, ``wk``, ``wv``, ``wqkv``, ``wkv``, ``fc1`` or
``fc1_gate`` is column-parallel (its flax output dimension sharded) and
one of ``wo`` or ``fc2`` row-parallel (its input dimension), where the
axis divides that dimension; every other leaf takes the fsdp rule (the
largest dimension that the fsdp axis divides), else stays replicated. So a
leaf lies on one axis at most, the tensor spec first.

:func:`shard_params` applies it. A tensor leaf becomes a DTensor
``Shard`` on the mesh's tensor dimension (a fused leaf in the rank order
of :mod:`.tensor`, its ``tensor_parts`` attribute naming the parts), and
each attention and feed-forward block that holds one gets its
:class:`.tensor.TensorGroup`: the model computes on the rank's shards
through ``to_local()`` and c10d's collectives (:mod:`.tensor`), never
through DTensor dispatch (whose functional collectives end the process
over gloo on CUDA tensors). The fsdp leaves go to FSDP2's ``fully_shard``
over the mesh's other axes: each encoder and decoder block, then the root,
each parameter sharded on the dimension the rule names (in the torch
layout of the flax dimension); on a ``(data, fsdp)`` mesh this is HSDP.
FSDP leaves out the tensor leaves and the ones the rule replicates: the
train step sums their gradients over the data-parallel ranks (every axis
but the tensor axis) itself. Every reduction sums; the loss divides by the
data-parallel ranks' count of labels.

A replicated leaf read inside a tensor region has a part of its gradient
on each tensor rank, which is summed over the tensor axis
(:func:`tensor_partial`): a sharded column projection's bias, read as the
rank's slice; and, where a block computes on its rank's heads, nGPT's
``qk_scale`` and T5's position-bias table, read at the rank's heads. Every
other replicated leaf (norms, embeddings, row-parallel biases, whatever a
block computes whole on every rank) has the same whole gradient on every
tensor rank, which is not summed.

The helpers below let the optimizers treat a sharded parameter through its
local shard: :func:`local`, :func:`gathered` and :func:`shard_of` (whole
tensors always in flax order), and a norm summed over the shards,
:func:`sharded_norm`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..models.params import flax_paths
from .tensor import TensorGroup, rank_parts, to_flax_order, to_rank_order

# kernel name -> its tensor-parallel role (the JAX _COLUMN_PARALLEL, _ROW_PARALLEL)
COLUMN_PARALLEL = ("wq", "wk", "wv", "wqkv", "wkv", "fc1", "fc1_gate")
ROW_PARALLEL = ("wo", "fc2")


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


def tensor_spec(flax_path: str, shape: Sequence[int], tensor_axis: str) -> Optional[tuple]:
    """The JAX ``_tensor_spec``: (None, axis) for a column-parallel 2-D
    kernel, (axis, None) for a row-parallel one, None for any other leaf."""
    parts = flax_path.split("/")
    if len(shape) != 2 or parts[-1] != "kernel" or len(parts) < 2:
        return None
    if parts[-2] in COLUMN_PARALLEL:
        return (None, tensor_axis)
    if parts[-2] in ROW_PARALLEL:
        return (tensor_axis, None)
    return None


def param_specs(model: nn.Module, *, tensor_axis: Optional[str] = None, fsdp_axis: Optional[str] = None,
                mesh=None) -> dict[str, tuple]:
    """{flax path: partition spec as a tuple over the flax dimensions} for
    every leaf of ``model`` that the flax tree holds (its parameters, and
    the int8 kernels and scales of a ``QDense``), the JAX ``param_specs``'
    rule: a tensor spec where :func:`tensor_spec` names one and the axis's
    size divides that dimension; else, with ``fsdp_axis``, the largest
    dimension (the first of equals) that the fsdp axis divides; else
    replicated, ``()``. ``mesh`` is a ``DeviceMesh`` or {axis name: size}."""
    sizes = axis_sizes(mesh)
    tensors = model.state_dict(keep_vars=True)
    specs = {}
    for name, path in flax_paths(model).items():
        shape = flax_shape(tensors[name].shape, path)
        spec = tensor_spec(path, shape, tensor_axis) if tensor_axis is not None else None
        if spec is not None and shape[spec.index(tensor_axis)] % sizes.get(tensor_axis, 1) != 0:
            spec = None
        if spec is None:
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


# the fused column projections and their parts, in flax order ([q | k | v], [k | v]; moonshine's decoder fc1 is
# [hidden | gate])
_FUSED = {"wqkv": 3, "wkv": 2}


def place_tensor_leaves(model: nn.Module, mesh, tensor_axis: str, specs: dict[str, tuple]) -> list[nn.Parameter]:
    """Replace each tensor-sharded leaf by a DTensor ``Shard`` of its torch
    dimension on the mesh's tensor dimension (a fused leaf in rank order,
    ``tensor_parts`` on the new parameter), give every attention and
    feed-forward block holding one its :class:`.tensor.TensorGroup`, and
    return the new parameters. A block computes on its rank's heads where
    every projection of it is split in rank order and the axis divides its
    heads; otherwise whole (:mod:`.tensor`)."""
    from ..models.transformer import Attention, FeedForward

    names = tuple(mesh.mesh_dim_names)
    t_dim = names.index(tensor_axis)
    size, rank = mesh.size(t_dim), mesh.get_local_rank(t_dim)
    group = mesh.get_group(t_dim)
    paths = flax_paths(model)
    placed = []
    for block_name, block in model.named_modules():
        if not isinstance(block, (Attention, FeedForward)):
            continue
        split = {}  # projection -> held in rank order
        for leaf_name, dense in block.named_children():
            path = paths.get(f"{block_name}.{leaf_name}.weight")
            if path is None or tensor_axis not in specs[path]:
                continue
            weight = dense.weight
            dim = torch_dim(specs[path].index(tensor_axis), weight.dim(), path)
            fused = _FUSED.get(leaf_name, 2 if leaf_name == "fc1" and getattr(block, "gated_concat", False) else 1)
            parts = rank_parts(fused, weight.shape[0], size) if dim == 0 else 1
            shard = to_rank_order(weight.detach(), dim, parts, size).chunk(size, dim=dim)[rank].contiguous()
            placements = [Shard(dim) if i == t_dim else Replicate() for i in range(len(names))]
            new = nn.Parameter(DTensor.from_local(shard, mesh, placements, run_check=False),
                               requires_grad=weight.requires_grad)
            new.tensor_parts = parts
            dense.weight = new
            placed.append(new)
            split[leaf_name] = parts == fused
        if not split:
            continue
        projections = [n for n, _ in block.named_children() if n in COLUMN_PARALLEL + ROW_PARALLEL]
        local = (sorted(split) == sorted(projections) and all(split.values())
                 and (not isinstance(block, Attention) or block.num_heads % size == 0))
        block.tp = TensorGroup(group, size, rank, local)
    return placed


def tensor_partial(model: nn.Module) -> list[nn.Parameter]:
    """The replicated leaves whose gradient is a tensor rank's part, to be
    summed over the tensor axis (see the module docstring)."""
    from ..models.transformer import Attention, Decoder, Encoder

    out = []
    for m in model.modules():
        tg = getattr(m, "tp", None)
        if tg is not None:
            for name, dense in m.named_children():
                if name in COLUMN_PARALLEL and is_sharded(getattr(dense, "weight", None)) \
                        and getattr(dense, "bias", None) is not None:
                    out.append(dense.bias)
            if tg.local and isinstance(m, Attention) and m.ngpt:
                out.append(m.qk_scale.weight)
        if isinstance(m, (Encoder, Decoder)) and hasattr(m, "rel_bias"):
            attn = m.layers[0].self_attn if len(m.layers) else None
            if attn is not None and attn.tp is not None and attn.tp.local:
                out.append(m.rel_bias.embedding.weight)
    return out


def shard_params(model: nn.Module, mesh, *, tensor_axis: Optional[str] = None,
                 fsdp_axis: Optional[str] = None) -> list[nn.Parameter]:
    """Shard ``model`` in place on ``mesh`` by :func:`param_specs` and return
    the parameters whose gradients the step sums over the data-parallel
    ranks by hand (every parameter FSDP does not hold).

    ``tensor_axis`` places the tensor leaves (:func:`place_tensor_leaves`).
    ``fsdp_axis`` names the last of the mesh's other axes: FSDP2 over them
    (1-D: ZeRO-3; 2-D: HSDP, replicated on the first). FSDP's own gradient
    reduction sums, as DDP's hook does (:func:`.mesh.replicate`)."""
    from torch.distributed.fsdp import FSDPModule, fully_shard

    names = tuple(mesh.mesh_dim_names)
    if tensor_axis is not None and tensor_axis not in names:
        raise ValueError(f"parallel.tensor_axis={tensor_axis!r} names no axis of the mesh {names}")
    specs = param_specs(model, tensor_axis=tensor_axis, fsdp_axis=fsdp_axis, mesh=mesh)
    if tensor_axis is not None:
        place_tensor_leaves(model, mesh, tensor_axis, specs)
    if fsdp_axis is None:
        return list(model.parameters())
    others = tuple(n for n in names if n != tensor_axis)
    if not others or others[-1] != fsdp_axis or len(others) > 2:
        raise ValueError(f"parallel.fsdp_axis={fsdp_axis!r} must name the last axis of a 1-D or 2-D mesh beside "
                         f"the tensor axis, got axes {names}")
    fsdp_mesh = mesh if others == names else mesh[others]
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
    kwargs = dict(mesh=fsdp_mesh, shard_placement_fn=lambda p: placement[p], ignored_params=ignored)
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
    """The full tensor, in flax order: a DTensor's, or that of the local
    shard ``t`` of a tensor laid out as the DTensor ``like`` (an all-gather
    over each shard axis of its mesh; a fused tensor leaf's rank order
    undone, which ``like``, the parameter, records as ``tensor_parts``);
    ``t`` itself otherwise. It calls c10d's ``all_gather_into_tensor``, not
    ``DTensor.full_tensor``, whose functional collectives end the process
    (SIGSEGV) over gloo on CUDA tensors (torch 2.11)."""
    ref = like if isinstance(like, DTensor) else t
    if not is_sharded(ref):
        return t
    out = local(t).contiguous()
    for mesh_dim, p in enumerate(ref.placements):
        if p.is_shard():
            n = ref.device_mesh.size(mesh_dim)
            stacked = out.new_empty((n * out.shape[0], *out.shape[1:]))
            dist.all_gather_into_tensor(stacked, out, group=ref.device_mesh.get_group(mesh_dim))
            out = to_flax_order(torch.cat(stacked.chunk(n), dim=p.dim), p.dim, getattr(ref, "tensor_parts", 1), n)
    return out


def shard_of(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``full`` (flax order) in the layout of the
    DTensor ``like`` (no collective: every placement divides evenly by
    :func:`param_specs`); ``full`` where ``like`` is not a DTensor."""
    if not isinstance(like, DTensor):
        return full
    coords = like.device_mesh.get_coordinate()
    for mesh_dim, p in enumerate(like.placements):
        if p.is_shard():
            n = like.device_mesh.size(mesh_dim)
            full = to_rank_order(full, p.dim, getattr(like, "tensor_parts", 1), n).chunk(n, dim=p.dim)[coords[mesh_dim]]
    return full


def sharded_norm(tensors: Sequence[torch.Tensor], like: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The global L2 norm of tensors some of which are shards: each
    sharded tensor's (a DTensor, or a local shard laid out as the DTensor at
    its place in ``like``) squares are summed over its mesh's shard axes,
    every other tensor's counted once."""
    whole = None
    sharded = {}  # the shard axes' groups -> the squares of the tensors sharded on them
    for i, t in enumerate(tensors):
        ref = t if isinstance(t, DTensor) else like[i] if like is not None else None
        sq = local(t).float().pow(2).sum()
        if is_sharded(ref):
            groups = tuple(ref.device_mesh.get_group(d) for d, p in enumerate(ref.placements) if p.is_shard())
            sharded[groups] = sq if groups not in sharded else sharded[groups] + sq
        else:
            whole = sq if whole is None else whole + sq
    for groups, sq in sharded.items():
        for group in groups:
            dist.all_reduce(sq, group=group)
        whole = sq if whole is None else whole + sq
    return torch.sqrt(whole)


def any_sharded(tensors) -> bool:
    return any(is_sharded(t) for t in tensors)
