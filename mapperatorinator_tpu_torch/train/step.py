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
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from ..models.lora import merge_lora
from ..models.params import flax_paths
from .optim import global_norm

BATCH_KEYS = ("frames", "decoder_input_ids", "decoder_attention_mask", "labels", "sample_weights")
_INTEGER_KEYS = ("decoder_input_ids", "decoder_attention_mask", "labels", "input_ids")


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters) and the optimizer built
    over them (:func:`..optim.build_optimizer` on :func:`named_flax_params`)."""

    step: int
    model: nn.Module
    optimizer: Any

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
    )


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
        batch = to_device(batch, next(model.parameters()).device)
        params = state.params
        for p in params:
            p.grad = None
        model.train()
        _logits, loss = forward(model, batch)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = {"loss": loss.detach(), "grad_l2": global_norm(grads)}
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
