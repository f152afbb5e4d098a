"""Optimizers and LR schedules: the JAX ``train/optim.py`` in PyTorch.

* ``muon`` (v32): Newton-Schulz-5 orthogonalised momentum for the internal
  matrices, AdamW for embeddings, heads and vectors;
* ``adamwscale`` (the default config): AdamW with the step scaled by
  max(1e-3, rms(param));
* ``adamw``: optax's ``adamw``;
* warmup (0.5 start factor) -> constant sustain -> cosine or linear decay;
* clipping by global norm, and gradient accumulation with
  ``optax.MultiSteps`` semantics (:class:`MultiSteps`).

Each optimizer updates its parameters in place from a list of gradients, in
the order of the ``(flax path, parameter)`` list it was built with. The
masks (``decay_mask``, ``muon_branch_mask``) match substrings of the flax
path of each tensor, as the JAX masks do, not of its torch name: a torch
``RMSNorm.weight`` is flax ``.../RMSNorm_0/scale``. Muon orthogonalises each
matrix in its flax layout (a Dense kernel is (in, out), a conv kernel
(k, in, out) reshaped to (k, in * out)), so the update is the JAX one, and
it runs ``newton_schulz5`` in bf16 with plain matmuls, as the JAX does.
``adafactor`` raises.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from ..models.params import flax_layout

Schedule = Callable[[int], float]
NamedParams = Sequence[tuple[str, torch.Tensor]]  # (flax path, parameter)

_NO_DECAY_SUBSTRINGS = ("bias", "layernorm", "layer_norm", "ln", "norm", "scale")
_ADAMW_BRANCH_SUBSTRINGS = ("embed", "proj_out")


def decay_mask(path: str) -> bool:
    """True where weight decay applies (the JAX ``decay_mask``)."""
    return not any(s in path.lower() for s in _NO_DECAY_SUBSTRINGS)


def muon_branch_mask(path: str, param: torch.Tensor) -> bool:
    """True where the Muon branch applies: >= 2-D internal matrices, not the
    embeds or the output head (the JAX ``muon_branch_mask``)."""
    return param.dim() >= 2 and not any(s in path.lower() for s in _ADAMW_BRANCH_SUBSTRINGS)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


# ---------------------------------------------------------------------------
# schedules (optax's, as plain functions of the step count)
# ---------------------------------------------------------------------------


def linear_schedule(init: float, end: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def cosine_decay_schedule(init: float, steps: int, alpha: float) -> Schedule:
    if steps <= 0:
        raise ValueError(f"cosine decay needs a positive number of steps, got {steps}")
    return lambda count: init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps)) + alpha)


def build_schedule(optim_args, base_lr: Optional[float] = None) -> Schedule:
    """warmup (0.5 -> 1) -> sustain -> cosine or linear decay, joined at
    their boundaries as ``optax.join_schedules`` does (one process: the JAX
    ``num_processes`` factor is 1)."""
    base = base_lr if base_lr is not None else optim_args.base_lr
    segments, boundaries, step = [], [], 0
    if optim_args.warmup_steps > 0:
        segments.append(linear_schedule(base * 0.5, base, optim_args.warmup_steps))
        step += optim_args.warmup_steps
        boundaries.append(step)
    if optim_args.sustain_steps > 0:
        segments.append(lambda count: base)
        step += optim_args.sustain_steps
        boundaries.append(step)
    remaining = optim_args.total_steps - step
    if optim_args.lr_scheduler == "cosine":
        segments.append(cosine_decay_schedule(base, remaining, optim_args.final_cosine / base))
    else:
        segments.append(linear_schedule(base, optim_args.final_cosine, remaining))

    def schedule(count: int) -> float:
        value = segments[0](count)
        for boundary, segment in zip(boundaries, segments[1:]):
            if count >= boundary:
                value = segment(count - boundary)
        return value

    return schedule


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


class Optimizer:
    """Parameters updated in place from gradients given in their order.
    ``count`` is the number of updates made, as in the optax states."""

    def __init__(self, params: NamedParams):
        self.paths = [path for path, _ in params]
        self.params = [p for _, p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        for param, update in zip(self.params, self.updates(grads)):
            param.add_(update.to(param.dtype))

    def updates(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        raise NotImplementedError

    def buffers(self) -> dict[str, list[torch.Tensor]]:
        return {}

    def state_dict(self) -> dict:
        """The count and the live buffers (not copies: save before the next step)."""
        return {"count": self.count, **{k: list(v) for k, v in self.buffers().items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key, tensors in self.buffers().items():
            for t, saved in zip(tensors, state[key], strict=True):
                t.copy_(saved)


def _zeros_like(params) -> list[torch.Tensor]:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


class AdamWScale(Optimizer):
    """AdamW with the update scaled by max(1e-3, rms(param)) (the JAX
    ``adamw_scale`` at its defaults; its schedule reads the count after the
    increment)."""

    b1, b2, eps = 0.9, 0.999, 1e-6

    def __init__(self, params: NamedParams, learning_rate: Schedule, weight_decay: float):
        super().__init__(params)
        self.lr, self.weight_decay = learning_rate, weight_decay
        self.decay = [decay_mask(path) for path in self.paths]
        self.mu, self.nu = _zeros_like(self.params), _zeros_like(self.params)

    def buffers(self):
        return {"mu": self.mu, "nu": self.nu}

    def updates(self, grads):
        count, b1, b2 = self.count, self.b1, self.b2
        lr = self.lr(count)
        step_size = lr * math.sqrt(1 - b2**count) / (1 - b1**count)
        out = []
        for p, g, m, v, decayed in zip(self.params, grads, self.mu, self.nu, self.decay):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            rms = torch.linalg.norm(p.float()) / math.sqrt(p.numel())
            upd = -(step_size * torch.clamp(rms, min=1e-3)) * m / (v.sqrt() + self.eps)
            if decayed and self.weight_decay > 0:
                upd = upd - lr * self.weight_decay * p.float()
            out.append(upd)
        return out


class AdamW(Optimizer):
    """``optax.adamw`` at its defaults: Adam with bias correction, decoupled
    weight decay on the ``decay_mask`` leaves, scaled by the schedule at the
    count before the increment."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: NamedParams, learning_rate: Schedule, weight_decay: float):
        super().__init__(params)
        self.lr, self.weight_decay = learning_rate, weight_decay
        self.decay = [decay_mask(path) for path in self.paths]
        self.mu, self.nu = _zeros_like(self.params), _zeros_like(self.params)

    def buffers(self):
        return {"mu": self.mu, "nu": self.nu}

    def updates(self, grads):
        count, b1, b2 = self.count, self.b1, self.b2
        lr = self.lr(count - 1)
        out = []
        for p, g, m, v, decayed in zip(self.params, grads, self.mu, self.nu, self.decay):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            upd = (m / (1 - b1**count)) / ((v / (1 - b2**count)).sqrt() + self.eps)
            if decayed:
                upd = upd + self.weight_decay * p.float()
            out.append(-lr * upd)
        return out


def newton_schulz5(g: torch.Tensor, steps: int = 6, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalisation of a 2-D matrix in bf16 (the
    JAX ``newton_schulz5``; plain matmuls, as the JAX leaves them to XLA).

    Every value is bf16 as in the JAX trace: the coefficients are rounded to
    bf16 (3.4375, -4.78125, 2.03125), and the norm squares in bf16, sums in
    fp32 and takes its root in bf16. The iteration magnifies any difference
    in these roundings (on the CPU this is bit-equal to the JAX function)."""
    if g.dim() != 2:
        raise ValueError(f"newton_schulz5 takes a matrix, got shape {tuple(g.shape)}")
    bf16 = torch.bfloat16
    a, b, c = (torch.tensor(v, dtype=bf16, device=g.device) for v in (3.4445, -4.7750, 2.0315))
    x = g.to(bf16)
    x = x / ((x * x).float().sum().to(bf16).sqrt() + torch.tensor(eps, dtype=bf16, device=g.device))
    transpose = g.shape[0] > g.shape[1]
    if transpose:
        x = x.T
    for _ in range(steps):
        A = x @ x.T
        B = b * A + c * (A @ A)
        x = a * x + B @ x
    return x.T if transpose else x


class Muon(Optimizer):
    """Muon with an internal AdamW (the JAX ``muon`` at its defaults:
    Nesterov momentum 0.95, 6 Newton-Schulz steps, AdamW betas (0.9, 0.95)
    and eps 1e-8). Every parameter keeps all three buffers, as the JAX state
    does. The AdamW branch keeps the reference quirk: it steps with the Muon
    learning rate and decays with the AdamW one."""

    momentum, ns_steps, betas, eps = 0.95, 6, (0.90, 0.95), 1e-8

    def __init__(self, params: NamedParams, learning_rate: Schedule, adamw_learning_rate: Schedule,
                 adamw_wd: float):
        super().__init__(params)
        self.lr, self.adamw_lr, self.wd = learning_rate, adamw_learning_rate, adamw_wd
        self.use_muon = [muon_branch_mask(path, p) for path, p in zip(self.paths, self.params)]
        self.buf, self.m1, self.m2 = (_zeros_like(self.params) for _ in range(3))

    def buffers(self):
        return {"momentum": self.buf, "moment1": self.m1, "moment2": self.m2}

    def updates(self, grads):
        count = self.count
        lr, adamw_lr = self.lr(count), self.adamw_lr(count)
        b1, b2 = self.betas
        adamw_scale = (1 - b1**count) / math.sqrt(1 - b2**count)
        out = []
        for path, p, g, buf, m1, m2, is_muon in zip(self.paths, self.params, grads, self.buf, self.m1, self.m2,
                                                    self.use_muon):
            g = g.float()
            buf.mul_(self.momentum).add_(g)
            m1.add_((g - m1) * (1 - b1))
            m2.add_((g * g - m2) * (1 - b2))
            if is_muon:
                eff = flax_layout(g + buf * self.momentum, path)  # Nesterov
                mat = eff.reshape(eff.shape[0], -1)
                ortho = newton_schulz5(mat, self.ns_steps) * max(1.0, mat.shape[0] / mat.shape[1]) ** 0.5
                out.append(flax_layout((-lr * ortho.float()).reshape(eff.shape), path))
            else:
                out.append(-adamw_lr * self.wd * p.float() - (lr / adamw_scale) * (m1 / (self.eps + m2.sqrt())))
        return out


# ---------------------------------------------------------------------------
# clipping, accumulation and construction
# ---------------------------------------------------------------------------


class ClipByGlobalNorm:
    """``optax.clip_by_global_norm`` in front of an optimizer."""

    def __init__(self, inner, max_norm: float):
        self.inner, self.max_norm = inner, max_norm

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        norm = global_norm(grads)
        if norm >= self.max_norm:
            grads = [g / norm.to(g.dtype) * self.max_norm for g in grads]
        self.inner.step(grads)

    @property
    def count(self) -> int:
        return self.inner.count

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state)


class MultiSteps:
    """``optax.MultiSteps(inner, every_k_schedule=k)``: gradients are
    averaged over k micro-steps (a running mean), the inner optimizer (with
    its clipping) runs on the k-th with the average, and only then does its
    count advance; the parameters do not move in between."""

    def __init__(self, inner, every_k: int, params: Sequence[torch.Tensor]):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc = _zeros_like(params)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        n = self.mini_step
        for acc, g in zip(self.acc, grads):
            acc.copy_((g.float() + n * acc) / (n + 1))
        if n == self.every_k - 1:
            self.inner.step(self.acc)
            self.mini_step = 0
            for acc in self.acc:
                acc.zero_()
        else:
            self.mini_step += 1

    @property
    def count(self) -> int:
        return self.inner.count

    def state_dict(self) -> dict:
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step, "acc": list(self.acc)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for t, saved in zip(self.acc, state["acc"], strict=True):
            t.copy_(saved)


def build_optimizer(args, params: NamedParams):
    """The configured optimizer, schedule, clipping and gradient
    accumulation over ``params`` (``(flax path, parameter)`` pairs)."""
    optim = args.optim
    schedule = build_schedule(optim)
    if optim.name == "adamw":
        tx = AdamW(params, schedule, weight_decay=optim.weight_decay)
    elif optim.name == "adamwscale":
        tx = AdamWScale(params, schedule, weight_decay=optim.weight_decay)
    elif optim.name == "muon":
        tx = Muon(params, schedule, build_schedule(optim, base_lr=optim.base_lr_2),
                  adamw_wd=optim.weight_decay)
    elif optim.name == "adafactor":
        raise NotImplementedError("optim.name=adafactor: not ported yet (ROADMAP queue 1, item 15)")
    else:
        raise NotImplementedError(optim.name)
    if optim.grad_clip and optim.grad_clip > 0:
        tx = ClipByGlobalNorm(tx, optim.grad_clip)
    if optim.grad_acc > 1:
        tx = MultiSteps(tx, optim.grad_acc, [p for _, p in params])
    return tx
