"""The training step: the JAX ``train/step.py`` in PyTorch.

Forward with the rhythm-weighted loss (``deterministic=True``: no dropout),
backward, the optimizer update (gradient accumulation, when configured, is
inside the optimizer, :class:`..optim.MultiSteps`), and the ``loss`` /
``grad_l2`` / ``weights_l2`` metrics. The step counter advances on every
micro-step, as the JAX ``TrainState.step`` does. Parameters are updated in
place; the JAX step returns a new state instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..models.params import flax_paths
from .optim import global_norm

BATCH_KEYS = ("frames", "decoder_input_ids", "decoder_attention_mask", "labels", "sample_weights")
_INTEGER_KEYS = ("decoder_input_ids", "decoder_attention_mask", "labels")


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


def to_device(batch: dict, device) -> dict:
    """The model's inputs of a collated numpy batch as tensors on ``device``."""
    return {key: torch.as_tensor(np.asarray(batch[key])).to(device, torch.long if key in _INTEGER_KEYS
                                                             else torch.float32)
            for key in BATCH_KEYS if key in batch}


def _forward(model, batch: dict):
    return model(
        frames=batch["frames"],
        decoder_input_ids=batch["decoder_input_ids"],
        decoder_attention_mask=batch.get("decoder_attention_mask"),
        labels=batch["labels"],
        sample_weights=batch.get("sample_weights"),
    )


def make_train_step():
    """Returns ``train_step(state, batch) -> (state, metrics)`` for a
    collated numpy batch. The metrics are tensors on the device: reading
    them waits for the step."""

    def train_step(state: TrainState, batch: dict):
        model = state.model
        device = next(model.parameters()).device
        batch = to_device(batch, device)
        params = state.params
        for p in params:
            p.grad = None
        model.train()
        _logits, loss = _forward(model, batch)
        loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = {"loss": loss.detach(), "grad_l2": global_norm(grads)}
        state.optimizer.step(grads)
        for p in params:
            p.grad = None
        metrics["weights_l2"] = global_norm([p.detach() for p in params])
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step():
    """Returns ``eval_step(model, batch) -> (loss, logits)``, without
    gradients; the host computes the per-context metrics from the logits."""

    @torch.no_grad()
    def eval_step(model, batch: dict):
        model.eval()
        batch = to_device(batch, next(model.parameters()).device)
        logits, loss = _forward(model, batch)
        return loss, logits

    return eval_step
