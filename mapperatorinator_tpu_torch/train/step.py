"""The training step: the JAX ``train/step.py`` in PyTorch.

Forward with the rhythm-weighted loss (``deterministic=True``: no dropout),
backward, the optimizer update (gradient accumulation, when configured, is
inside the optimizer, :class:`..optim.MultiSteps`), and the ``loss`` /
``grad_l2`` / ``weights_l2`` metrics. The step counter advances on every
micro-step, as the JAX ``TrainState.step`` does. Parameters are updated in
place; the JAX step returns a new state instead.

Under LoRA (:func:`make_lora_train_step`) the state's model is the adapter
(:class:`..models.lora.LoraAdapter`), the counterpart of the JAX state's
factor tree: the frozen base runs with the merged weights through
``torch.func.functional_call``, so the gradient reaches the factors alone.

Across processes (``TrainState.group``) each rank holds its own rows of the
global batch, and the step gives the JAX global-batch step: the loss divides
each rank's sum by the valid labels of every rank (an all-reduced count, the
JAX ``sum / max(valid.sum(), 1)`` over the global batch), the gradients are
summed over the ranks (DDP's hook, FSDP's reduce-scatter, or by hand for the
parameters neither holds), and the ``loss`` metric is the sum of the ranks'
parts. :func:`make_global_eval_step` and :func:`eval_model_global` are the
multi-process eval. Under a tensor axis the group is the data-parallel one
(the ranks of one tensor group hold the same rows and reduce nothing over
it), and the gradients of ``TrainState.tensor_partial`` are also summed
over the tensor group (:func:`..parallel.sharding.tensor_partial`).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from ..models.lora import merge_lora
from ..models.mapperatorinator import LABEL_IGNORE_ID
from ..models.params import flax_paths
from ..parallel.sharding import local
from .optim import global_norm

BATCH_KEYS = ("frames", "decoder_input_ids", "decoder_attention_mask", "labels", "sample_weights")
_INTEGER_KEYS = ("decoder_input_ids", "decoder_attention_mask", "labels", "input_ids")


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer built
    over them (:func:`..optim.build_optimizer` on :func:`named_flax_params`).

    Across processes: ``group`` is the process group the rows are spread
    over, ``replica`` the ``DistributedDataParallel`` wrapper that runs the
    forward (None: the model runs it, as an FSDP model does), and
    ``hand_reduced`` the parameters whose gradients the step sums over the
    group itself (LoRA's factors, the leaves FSDP leaves replicated, every
    leaf under a tensor axis without FSDP). ``tensor_partial`` are the
    parameters whose gradients it sums over ``tensor_group`` too."""

    step: int
    model: nn.Module
    optimizer: Any
    replica: Optional[nn.Module] = None
    hand_reduced: Sequence[nn.Parameter] = ()
    group: Optional[Any] = None
    tensor_partial: Sequence[nn.Parameter] = ()
    tensor_group: Optional[Any] = None

    @property
    def params(self) -> list[nn.Parameter]:
        """The parameters in the optimizer's order."""
        return list(self.model.parameters())


def named_flax_params(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """The model's parameters with their flax paths, in the model's order:
    what :func:`..optim.build_optimizer` takes."""
    paths = flax_paths(model)
    return [(paths[name], p) for name, p in model.named_parameters()]


def to_device(batch: dict, device, keys: Iterable[str] = BATCH_KEYS) -> dict:
    """The inputs ``keys`` of a collated numpy batch (the generation model's
    by default) as tensors on ``device``: token ids, masks and labels as
    int64, the rest as fp32."""
    return {key: torch.as_tensor(np.asarray(batch[key])).to(device, torch.long if key in _INTEGER_KEYS
                                                             else torch.float32)
            for key in keys if key in batch}


def _inputs(batch: dict) -> dict:
    return dict(
        frames=batch["frames"],
        decoder_input_ids=batch["decoder_input_ids"],
        decoder_attention_mask=batch.get("decoder_attention_mask"),
        labels=batch["labels"],
        sample_weights=batch.get("sample_weights"),
        label_count=batch.get("label_count"),
    )


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group in place (unchanged without a process group)."""
    if dist.is_initialized():
        dist.all_reduce(t, op=op, group=group)
    return t


def global_label_count(labels: torch.Tensor, group) -> torch.Tensor:
    """The valid labels of every rank's rows: what the loss divides by."""
    return _all_reduce((labels != LABEL_IGNORE_ID).sum(), group)


def sum_grads(params: Sequence[nn.Parameter], group) -> None:
    """Sum the gradients of ``params`` over the group in one all-reduce (a
    parameter the loss did not reach counts as a zero gradient; a sharded
    parameter's local shard is summed); nothing over a group of one."""
    if not params or dist.get_world_size(group) == 1:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [local(p.grad) for p in params]
    flat = _flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=group)
    for g, summed in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(summed)


def _forward(model, batch: dict):
    return model(**_inputs(batch))


def _merged_forward(model, adapter, batch: dict, *, alpha: float):
    """The model's forward, in the adapter's mode, with the adapter merged
    into its target weights."""
    model.train(adapter.training)
    merged = merge_lora(dict(model.named_parameters()), adapter, alpha)
    return torch.func.functional_call(model, merged, (), _inputs(batch))


def make_train_step(forward: Callable = _forward, weights_l2: bool = True):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a
    collated numpy batch; ``forward(state.model, batch)`` gives (logits,
    loss). The metrics are tensors on the device: reading them waits for
    the step."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        runner = model if state.replica is None else state.replica
        batch = to_device(batch, next(model.parameters()).device)
        if state.group is not None:
            batch["label_count"] = global_label_count(batch["labels"], state.group)
        params = state.params
        for p in params:
            p.grad = None
        runner.train()
        _logits, loss = forward(runner, batch)
        loss.backward()
        loss = loss.detach()
        if state.group is not None:
            if state.tensor_partial:
                sum_grads(state.tensor_partial, state.tensor_group)
            if state.hand_reduced:
                sum_grads(state.hand_reduced, state.group)
            dist.all_reduce(loss, group=state.group)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = {"loss": loss, "grad_l2": global_norm(grads)}
        state.optimizer.step(grads)
        for p in params:
            p.grad = None
        if weights_l2:
            metrics["weights_l2"] = global_norm([p.detach() for p in params])
        state.step += 1
        return state, metrics

    return train_step


def make_lora_train_step(model: nn.Module, alpha: float = 128.0):
    """The train step of a LoRA fine-tune of ``model`` (the JAX
    ``make_lora_train_step``): ``state.model`` is the adapter, and its
    factors alone are trained. ``model``'s parameters stop requiring
    gradients here: the backward computes the input gradients through the
    base, and the gradient of each merged weight, which reaches the factors
    through the merge. The metrics are ``loss`` and ``grad_l2`` over the
    factors, as in JAX."""
    model.requires_grad_(False)
    return make_train_step(functools.partial(_merged_forward, model, alpha=alpha), weights_l2=False)


def make_eval_step(forward: Callable = _forward):
    """Returns ``eval_step(model, batch) -> (loss, logits)``, without
    gradients; the host computes the per-context metrics from the logits."""

    @torch.no_grad()
    def eval_step(model, batch: dict):
        model.eval()
        batch = to_device(batch, next(model.parameters()).device)
        logits, loss = forward(model, batch)
        return loss, logits

    return eval_step


def make_lora_eval_step(model: nn.Module, alpha: float = 128.0):
    """Returns ``eval_step(adapter, batch) -> (loss, logits)``: the eval step
    of ``model`` with the adapter merged (the JAX ``train.py`` wraps its eval
    step in ``merge_lora`` likewise)."""
    return make_eval_step(functools.partial(_merged_forward, model, alpha=alpha))


def make_global_eval_step(forward: Callable = _forward, group=None):
    """Returns ``eval_step(model, batch) -> tensor [loss, correct, total]``
    over every rank's rows of the batch (the JAX ``make_global_eval_step``):
    each rank evaluates its own rows, the loss divides by the all-reduced
    count of valid labels, and the three sums are all-reduced. Under LoRA
    ``forward`` merges the factors (``functools.partial(_merged_forward,
    base, alpha=...)``), where the JAX multi-host eval takes the bare
    factors. Build it once and call it for every batch."""

    @torch.no_grad()
    def eval_step(model, batch: dict) -> torch.Tensor:
        model.eval()
        batch = to_device(batch, next(model.parameters()).device)
        labels = batch["labels"]
        valid = labels != LABEL_IGNORE_ID
        batch["label_count"] = global_label_count(labels, group)
        logits, loss = forward(model, batch)
        correct = ((logits.argmax(-1) == labels) & valid).sum()
        return _all_reduce(torch.stack([loss.double(), correct.double(), valid.sum().double()]), group)

    return eval_step


def eval_model_global(eval_step: Callable, model, local_batches: Iterable[dict], max_steps: Optional[int] = None,
                      group=None) -> dict:
    """The multi-process eval (the JAX ``eval_model_global``): every rank
    steps through its own eval rows in lockstep and the loss is the mean of
    the global batches' losses, the accuracy the global share of correct
    labels, ``{"test/loss", "test/acc"}``. Every rank stops at the first
    batch that some rank lacks, so none waits in a collective that the
    others never reach."""
    device = next(model.parameters()).device
    sums, n = torch.zeros(3, dtype=torch.float64), 0
    batches = iter(local_batches)
    for i in itertools.count(1):
        if max_steps is not None and i > max_steps:
            break
        batch = next(batches, None)
        present = _all_reduce(torch.tensor(int(batch is not None), device=device), group, dist.ReduceOp.MIN)
        if not present.item():
            break
        sums += eval_step(model, batch).cpu()
        n += 1
    if n == 0:
        return {}
    loss, correct, total = sums.tolist()
    return {"test/loss": loss / n, "test/acc": correct / total if total else 0.0}
