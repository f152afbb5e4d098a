"""Diffusion timestep schedule samplers: the JAX ``diffusion/schedule_sampler.py``
in PyTorch (reference: ``osu_diffusion/utils/diffusion/timestep_sampler.py:27-120``):
uniform sampling and loss-second-moment importance resampling.

The state is a dict of two tensors on the training device, ``history``
(num_timesteps, history_per_term) fp32 and ``counts`` (num_timesteps,)
int64, and ``sample`` / ``update`` are functions of it, as in JAX.

:meth:`ScheduleSampler.update` keeps the JAX ring semantics exactly (while a
timestep's history is not full, append at its fill index; once full, shift
the oldest loss out; duplicate timesteps of a batch apply in batch order).
JAX runs it as a ``fori_loop`` over the batch; a Python loop of scalar
updates would launch several kernels per sample on a card. Here it is one
vectorised pass: a sample's slot is its timestep's count plus its rank among
the batch's samples of that timestep, less the overflow its row sheds; the
row's kept old losses move left by that overflow (a gather) and the batch's
losses are scattered in. It is about 20 small kernels a step whatever the
batch, with no read back to the host.

Draws. ``sample`` takes its timesteps from a ``torch.Generator`` (a
categorical draw by ``torch.multinomial``) or from a callable
``source(p, batch_size) -> t``, which lets a caller replay JAX's draws from
the same distribution ``p``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

TimestepSource = Union[torch.Generator, Callable[[torch.Tensor, int], torch.Tensor]]


def draw_timesteps(source: TimestepSource, p: torch.Tensor, batch_size: int) -> torch.Tensor:
    """``batch_size`` timesteps drawn with probabilities ``p``, as int64 on
    ``p``'s device."""
    if isinstance(source, torch.Generator):
        return torch.multinomial(p, batch_size, replacement=True, generator=source)
    return torch.as_tensor(source(p, batch_size)).to(device=p.device, dtype=torch.int64)


@dataclasses.dataclass(frozen=True)
class ScheduleSampler:
    """A distribution over diffusion timesteps with optional loss-aware
    importance resampling:

      state = sampler.init(device)
      t, weights = sampler.sample(state, batch_size, source)
      state = sampler.update(state, t, per_sample_losses)

    ``weights`` are the unbiased importance weights ``1 / (S * p[t])`` (S the
    support size), multiplied into the per-sample losses so that the
    objective's mean is unchanged (reference timestep_sampler.py:44-58)."""

    name: str
    num_timesteps: int
    max_timestep: Optional[int] = None  # exclusive cap (refine models)
    history_per_term: int = 10
    uniform_prob: float = 0.001

    @property
    def support_size(self) -> int:
        if self.max_timestep is None:
            return self.num_timesteps
        return min(self.max_timestep, self.num_timesteps)

    def _support_mask(self, device) -> torch.Tensor:
        return (torch.arange(self.num_timesteps, device=device) < self.support_size).float()

    def init(self, device=None) -> dict:
        if self.name == "uniform":
            return {}
        return {
            "history": torch.zeros((self.num_timesteps, self.history_per_term), dtype=torch.float32, device=device),
            "counts": torch.zeros((self.num_timesteps,), dtype=torch.int64, device=device),
        }

    def weights(self, state: dict, device=None) -> torch.Tensor:
        """Per-timestep unnormalised sampling weights over the support:
        sqrt(E[loss^2]) per timestep once every reachable timestep has a full
        history, mixed with ``uniform_prob`` of uniform mass; uniform until
        then (reference timestep_sampler.py:126-134)."""
        if self.name == "uniform":
            return self._support_mask(device)
        mask = self._support_mask(state["counts"].device)
        warmed = torch.where(mask > 0, state["counts"] >= self.history_per_term, True).all()
        w = torch.sqrt(torch.mean(torch.square(state["history"]), dim=-1)) * mask
        w = w / torch.clamp(w.sum(), min=1e-20)
        w = w * (1.0 - self.uniform_prob) + self.uniform_prob / self.support_size * mask
        return torch.where(warmed, w, mask)

    def sample(self, state: dict, batch_size: int, source: TimestepSource, device=None):
        """``batch_size`` timesteps and their importance weights (ones for
        the uniform sampler)."""
        w = self.weights(state, device)
        p = w / w.sum()
        t = draw_timesteps(source, p, batch_size)
        if self.name == "uniform":
            return t, torch.ones((batch_size,), dtype=torch.float32, device=p.device)
        return t, 1.0 / (self.support_size * p[t])

    def update(self, state: dict, t: torch.Tensor, losses: torch.Tensor) -> dict:
        """Push per-sample losses into each timestep's ring history (reference
        timestep_sampler.py:136-144), duplicates in batch order: the state the
        JAX ``fori_loop`` leaves, computed in one vectorised pass."""
        if self.name == "uniform":
            return state
        h = self.history_per_term
        hist, counts = state["history"], state["counts"]
        t = t.to(device=counts.device, dtype=torch.int64)
        n = t.shape[0]
        # each sample's rank among the batch's samples of its timestep, in batch order
        order = torch.argsort(t, stable=True)
        sorted_t = t[order]
        rank = torch.empty_like(t)
        rank[order] = torch.arange(n, device=t.device) - torch.searchsorted(sorted_t, sorted_t)
        added = torch.bincount(t, minlength=self.num_timesteps)
        total = counts + added
        shed = torch.clamp(total - h, min=0)  # the oldest losses each row pushes out
        # the kept old losses move left by what the row sheds; the rest stay
        src = torch.arange(h, device=t.device)[None] + shed[:, None]
        moved = torch.gather(hist, 1, torch.clamp(src, max=h - 1))
        new = torch.where(src < counts[:, None], moved, hist)
        # the batch's losses land after the kept ones; a loss shed within the
        # batch goes to a spare column that is dropped
        slot = counts[t] + rank - shed[t]
        slot = torch.where(slot >= 0, slot, h)
        new = torch.cat([new, new.new_zeros((self.num_timesteps, 1))], dim=1)
        new = new.index_put((t, slot), losses.detach().to(new.dtype))[:, :h]
        return {"history": new, "counts": torch.clamp(total, max=h)}


def make_schedule_sampler(name: str, num_timesteps: int, max_timestep: Optional[int] = None,
                          history_per_term: int = 10, uniform_prob: float = 0.001) -> ScheduleSampler:
    """Create a named schedule sampler (reference timestep_sampler.py:13-24)."""
    if name not in ("uniform", "loss-second-moment"):
        raise NotImplementedError(f"unknown schedule sampler: {name}")
    return ScheduleSampler(name=name, num_timesteps=num_timesteps, max_timestep=max_timestep,
                           history_per_term=history_per_term, uniform_prob=uniform_prob)
