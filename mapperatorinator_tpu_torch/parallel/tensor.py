"""The tensor axis: Megatron column / row parallelism over c10d.

The JAX package places ``wq``, ``wk``, ``wv``, ``wqkv``, ``wkv``, ``fc1`` and
``fc1_gate`` column-parallel and ``wo`` and ``fc2`` row-parallel on the
tensor axis (``parallel/sharding.py``) and lets GSPMD insert the
collectives. The port has no GSPMD: each :class:`..models.transformer.
Attention` and ``FeedForward`` whose projections
:func:`.sharding.shard_params` placed on the axis runs its block on the
rank's share itself, between two regions over the tensor group
(Megatron-LM's ``f`` and ``g``):

* :func:`copy_in` (into a region): identity forward, the input gradient
  all-reduced backward, since each rank's columns give a part of it;
* :func:`reduce_out` (out of a region): the row-parallel product's partial
  sums all-reduced forward, identity backward.

Where the axis divides the block's heads (``num_heads % size == 0``; the
feed-forward width for ``FeedForward``), a block computes on its rank's
heads alone (``TensorGroup`` at ``local`` True): kernels B and C then run at
H / size heads. Where it does not (a tensor axis of 3 on 8 heads), the JAX
``param_specs`` still shards every leaf whose own dimension the axis
divides, mid-head. The block then gathers the column outputs
(:func:`gather_columns`), computes the attention (or activation) on all
heads on every rank, and hands a row-parallel ``wo`` / ``fc2`` its rank's
slice of the input columns (:func:`scatter_columns`); a leaf the axis does
not divide stays whole and computes whole. The result is the same
function either way.

A fused projection (``wqkv``: [q | k | v], ``wkv``: [k | v], moonshine's
decoder ``fc1``: [hidden | gate]) is held in *rank order* on the tensor
axis: each part split into ``size`` chunks and rank r's shard the r-th
chunk of every part (:func:`to_rank_order`), so the local product is the
rank's q, k and v heads. A contiguous chunk of the flax order would not
be. Wherever the leaf is seen whole (checkpoints, the optimizers' gathers,
``param_specs``) it is in flax order again (:func:`to_flax_order`,
through :func:`.sharding.gathered` and :func:`.sharding.shard_of`). Where
a part is not a multiple of ``size`` the leaf is a contiguous chunk, as
JAX shards it, and only the gathered path reads it.

Every all-reduce here sums in fp32: a bf16 activation is cast up, summed
and cast back, on gloo and NCCL alike. For two ranks that is a bf16 sum's
result, and no backend refuses an fp32 sum of CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorGroup:
    """A block's place on the tensor axis: the axis's process group, its
    size, this rank's index on it, and whether the block computes on the
    rank's share of its heads alone (``local``: the axis divides them and
    every projection is sharded) or on all of them (see the module
    docstring)."""

    group: Any
    size: int
    rank: int
    local: bool

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in fp32, in ``x``'s dtype; ``x`` itself
    is left as it was."""
    y = x.float() if x.dtype != torch.float32 else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather_last(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the last dimension, in rank order."""
    moved = x.movedim(-1, 0).contiguous()
    out = moved.new_empty((tg.size * moved.shape[0], *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=tg.group)
    return out.movedim(0, -1)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.tg.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        return all_reduce_sum(x, tg.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return all_gather_last(x, tg)

    @staticmethod
    def backward(ctx, grad):
        tg = ctx.tg
        return grad.chunk(tg.size, dim=-1)[tg.rank].contiguous(), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tg):
        ctx.tg = tg
        return x.chunk(tg.size, dim=-1)[tg.rank].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_last(grad, ctx.tg), None


def copy_in(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    return _CopyIn.apply(x, tg)


def reduce_out(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    return _ReduceOut.apply(x, tg)


def gather_columns(x: torch.Tensor, tg: TensorGroup, parts: int = 1) -> torch.Tensor:
    """Every rank's column outputs, whole and in flax order (a fused
    projection's rank order undone); backward, this rank's columns of the
    gradient."""
    return to_flax_order(_Gather.apply(x, tg), x.dim() - 1, parts, tg.size)


def scatter_columns(x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """This rank's contiguous slice of ``x``'s last dimension (the input of
    a row-parallel product); backward, the ranks' slices gathered."""
    return _Scatter.apply(x, tg)


# ---------------------------------------------------------------------------
# the fused projections' rank order
# ---------------------------------------------------------------------------


def to_rank_order(full: torch.Tensor, dim: int, parts: int, size: int) -> torch.Tensor:
    """[p0 | p1 | ...] along ``dim`` -> [rank 0's chunk of every part |
    rank 1's | ...]; the identity for one part."""
    if parts <= 1 or size <= 1:
        return full
    dim = dim % full.dim()
    n = full.shape[dim] // (parts * size)
    return full.unflatten(dim, (parts, size, n)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def to_flax_order(full: torch.Tensor, dim: int, parts: int, size: int) -> torch.Tensor:
    """The inverse of :func:`to_rank_order`."""
    if parts <= 1 or size <= 1:
        return full
    dim = dim % full.dim()
    n = full.shape[dim] // (parts * size)
    return full.unflatten(dim, (size, parts, n)).transpose(dim, dim + 1).flatten(dim, dim + 2)


def rank_parts(parts: int, width: int, size: int) -> int:
    """The parts a fused leaf of ``width`` output columns is held in rank
    order by: ``parts`` where the axis divides each part, else 1 (a
    contiguous chunk, as the JAX rule shards it)."""
    return parts if parts > 1 and (width // parts) % size == 0 else 1


def rank_slice(full: torch.Tensor, tg: TensorGroup, parts: int = 1) -> torch.Tensor:
    """This rank's share of a whole vector in the rank order of a leaf of
    ``parts`` parts (a column-parallel bias, nGPT's ``qk_scale``)."""
    return to_rank_order(full, 0, parts, tg.size).chunk(tg.size)[tg.rank]


# ---------------------------------------------------------------------------
# a block's projections
# ---------------------------------------------------------------------------


def is_split(dense) -> bool:
    """Whether a projection's weight is sharded on the tensor axis."""
    from .sharding import is_sharded

    return is_sharded(dense.weight)


def column(dense, x: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """A column-parallel projection of ``x``: this rank's output columns
    (in rank order for a fused leaf), its slice of the bias added; ``x`` is
    copied into the region."""
    from .sharding import local

    bias = None if dense.bias is None else rank_slice(dense.bias, tg, getattr(dense.weight, "tensor_parts", 1))
    return dense.linear(copy_in(x, tg), local(dense.weight), bias)


def row(dense, y: torch.Tensor, tg: TensorGroup) -> torch.Tensor:
    """A row-parallel projection of this rank's input columns ``y``: the
    partial products all-reduced, then the bias added once."""
    from .sharding import local

    out = reduce_out(dense.linear(y, local(dense.weight), None), tg)
    return out if dense.bias is None else out + dense.bias.to(out.dtype)


def whole_columns(dense, x: torch.Tensor, tg: Optional[TensorGroup]) -> torch.Tensor:
    """A column projection's whole output on every rank: a sharded leaf's
    columns gathered (flax order), a whole one computed whole."""
    if tg is None or not is_split(dense):
        return dense(x)
    return gather_columns(column(dense, x, tg), tg, getattr(dense.weight, "tensor_parts", 1))


def whole_rows(dense, y: torch.Tensor, tg: Optional[TensorGroup]) -> torch.Tensor:
    """A row projection of the whole input ``y`` on every rank: a sharded
    leaf reads its rank's slice of the columns, a whole one all of them."""
    if tg is None or not is_split(dense):
        return dense(y)
    return row(dense, scatter_columns(y, tg), tg)


def tensor_group_of(model) -> Optional[TensorGroup]:
    """The tensor group of the first block of ``model`` placed on the
    tensor axis (None: the model is whole)."""
    for m in model.modules():
        tg = getattr(m, "tp", None)
        if tg is not None:
            return tg
    return None
