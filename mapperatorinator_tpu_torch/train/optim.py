"""Optimizers and LR schedules: the JAX ``train/optim.py`` in PyTorch.

* ``muon`` (v32): Newton-Schulz-5 orthogonalised momentum for the internal
  matrices, AdamW for embeddings, heads and vectors;
* ``adamwscale`` (the default config): AdamW with the step scaled by
  max(1e-3, rms(param));
* ``adamw``: optax's ``adamw``;
* ``adafactor``: ``optax.adafactor`` at its defaults (:class:`Adafactor`);
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

Under FSDP or the tensor axis a parameter is a DTensor sharded over the
ranks (:func:`..parallel.sharding.shard_params`). Each optimizer then keeps
its buffers as local shards and updates the local shard in place; what
needs the whole of a parameter reads it whole: the global norm of clipping
and of ``adamwscale``'s rms sums the squares over the shards, and Muon
orthogonalises the full gradient matrix (gathered in flax order, as GSPMD
computes it in JAX) and keeps its own shard of the update; Adafactor
computes its factored statistics, block RMS and update from the gathered
gradient likewise. The state dicts hold full tensors in flax order (a fused
tensor leaf's rank order undone), so a checkpoint is the same whatever the
layout that wrote it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.params import flax_layout
from ..parallel.sharding import any_sharded, flax_shape, gathered, is_sharded, local, shard_of, sharded_norm

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


def global_norm(tensors: Sequence[torch.Tensor], like: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """The L2 norm of all ``tensors`` together; where some are shards (DTensors,
    or local shards laid out as the DTensors of ``like``), their squares are
    summed over the ranks (:func:`..parallel.sharding.sharded_norm`)."""
    if any_sharded(tensors) or (like is not None and any_sharded(like)):
        return sharded_norm(tensors, like)
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


def build_schedule(optim_args, num_processes: int = 1, base_lr: Optional[float] = None) -> Schedule:
    """warmup (0.5 -> 1) -> sustain -> cosine or linear decay, joined at
    their boundaries as ``optax.join_schedules`` does, each length
    stretched by ``num_processes``: the JAX ``train.py`` passes its device
    count, the port its process count, one card a process."""
    base = base_lr if base_lr is not None else optim_args.base_lr
    segments, boundaries, step = [], [], 0
    if optim_args.warmup_steps > 0:
        n = optim_args.warmup_steps * num_processes
        segments.append(linear_schedule(base * 0.5, base, n))
        step += n
        boundaries.append(step)
    if optim_args.sustain_steps > 0:
        segments.append(lambda count: base)
        step += optim_args.sustain_steps * num_processes
        boundaries.append(step)
    remaining = optim_args.total_steps * num_processes - step
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
    ``count`` is the number of updates made, as in the optax states. A
    sharded parameter is updated through its local shard, from a gradient
    given as a DTensor or as its local shard."""

    def __init__(self, params: NamedParams):
        self.paths = [path for path, _ in params]
        self.params = [p for _, p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        for param, update in zip(self.params, self.updates([local(g) for g in grads])):
            local(param).add_(update.to(param.dtype))

    def updates(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        raise NotImplementedError

    def buffers(self) -> dict[str, list[torch.Tensor]]:
        return {}

    def state_dict(self) -> dict:
        """The count and the buffers: the live ones (not copies: save before
        the next step), or the full tensors gathered from a sharded
        parameter's shards (a collective: every rank calls it)."""
        return {"count": self.count, **{k: [gathered(t, like=p) for t, p in zip(v, self.params)]
                                        for k, v in self.buffers().items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key, tensors in self.buffers().items():
            for t, saved, p in zip(tensors, state[key], self.params, strict=True):
                t.copy_(shard_of(saved, p))


def _zeros_like(params) -> list[torch.Tensor]:
    return [torch.zeros_like(local(p), dtype=torch.float32) for p in params]


def _norm(p: torch.Tensor) -> torch.Tensor:
    """A parameter's L2 norm, whole where it is sharded."""
    return sharded_norm([p]) if is_sharded(p) else torch.linalg.norm(p.float())


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
            rms = _norm(p) / math.sqrt(p.numel())
            p = local(p)
            upd = -(step_size * torch.clamp(rms, min=1e-3)) * m / (v.sqrt() + self.eps)
            if decayed and self.weight_decay > 0:
                upd = upd - lr * self.weight_decay * p.float()
            out.append(upd)
        return out


class AdamW(Optimizer):
    """``optax.adamw`` at its defaults: Adam with bias correction, decoupled
    weight decay on the leaves whose flax path ``mask`` admits (the JAX
    train step's ``decay_mask`` by default; None decays every leaf, as
    ``optax.adamw`` does without a mask, which the diffusion, classifier and
    rhythm-complexion trainers build), scaled by the schedule at the count
    before the increment."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: NamedParams, learning_rate: Schedule, weight_decay: float,
                 mask: Optional[Callable[[str], bool]] = decay_mask):
        super().__init__(params)
        self.lr, self.weight_decay = learning_rate, weight_decay
        self.decay = [mask is None or mask(path) for path in self.paths]
        self.mu, self.nu = _zeros_like(self.params), _zeros_like(self.params)

    def buffers(self):
        return {"mu": self.mu, "nu": self.nu}

    def updates(self, grads):
        count, b1, b2 = self.count, self.b1, self.b2
        lr = self.lr(count - 1)
        out = []
        for p, g, m, v, decayed in zip(self.params, grads, self.mu, self.nu, self.decay):
            g, p = g.float(), local(p)
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
    bf16 (3.4375, -4.78125, 2.03125), and the norm sums in fp32 and takes its
    root in bf16. Its squares are exact, in fp32: the trace squares in bf16
    and then converts to fp32, and XLA on the CPU folds the pair into one
    fp32 product, so a bf16 rounding of the squares moves the norm by an ulp
    now and then (15 of 1400 random matrices). The iteration magnifies any
    difference in these roundings, by far along the near-null directions of
    an ill-conditioned gradient such as a LoRA factor's (on the CPU this is
    bit-equal to the JAX function)."""
    if g.dim() != 2:
        raise ValueError(f"newton_schulz5 takes a matrix, got shape {tuple(g.shape)}")
    bf16 = torch.bfloat16
    a, b, c = (torch.tensor(v, dtype=bf16, device=g.device) for v in (3.4445, -4.7750, 2.0315))
    x = g.to(bf16)
    x = x / (x.float().square().sum().to(bf16).sqrt() + torch.tensor(eps, dtype=bf16, device=g.device))
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
                # Nesterov; the whole matrix where the parameter is sharded, this rank's shard of the update
                eff = flax_layout(gathered(g + buf * self.momentum, like=p), path)
                mat = eff.reshape(eff.shape[0], -1)
                ortho = newton_schulz5(mat, self.ns_steps) * max(1.0, mat.shape[0] / mat.shape[1]) ** 0.5
                out.append(shard_of(flax_layout((-lr * ortho.float()).reshape(eff.shape), path), p))
            else:
                out.append(-adamw_lr * self.wd * local(p).float() - (lr / adamw_scale) * (m1 / (self.eps + m2.sqrt())))
        return out


def factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128) -> Optional[tuple[int, int]]:
    """optax's ``_factored_dims``: (the second largest, the largest) dims of
    a flax shape (``np.argsort``'s order among equals), or None where the
    second largest is below ``min_dim_size_to_factor`` or the leaf has fewer
    than two dims."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(Optimizer):
    """``optax.adafactor(schedule)`` at its defaults: factored second moments
    (``scale_by_factored_rms``: a leaf whose two largest flax dims are both
    at least 128 keeps row and column means of the squared gradient, any
    other leaf the whole square; decay ``1 - (count + 1)^-0.8``, eps 1e-30),
    then ``clip_by_block_rms(1.0)``, the schedule at the count before the
    increment, ``scale_by_param_block_rms`` (times max(rms(param), 1e-3))
    and the sign flipped.

    Every statistic is computed in the flax layout, where optax's axes are
    named, on the whole gradient (gathered where the parameter is sharded);
    the buffers ``v_row``, ``v_col`` and ``v`` are optax's leaves in that
    layout, (1,) where unused, whole on every rank, so the state dict is
    optax's state and any layout restores it."""

    decay_rate, eps, min_dim_size_to_factor, clipping_threshold, min_scale = 0.8, 1e-30, 128, 1.0, 1e-3

    def __init__(self, params: NamedParams, learning_rate: Schedule):
        super().__init__(params)
        self.lr = learning_rate
        self.shapes = [flax_shape(p.shape, path) for path, p in zip(self.paths, self.params)]
        self.dims = [factored_dims(shape, self.min_dim_size_to_factor) for shape in self.shapes]
        self.v_row, self.v_col, self.v = [], [], []
        for p, shape, dims in zip(self.params, self.shapes, self.dims):
            zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=local(p).device)  # noqa: E731
            if dims is None:
                self.v_row.append(zeros(1))
                self.v_col.append(zeros(1))
                self.v.append(zeros(*shape))
            else:
                d1, d0 = dims
                self.v_row.append(zeros(*np.delete(shape, d0)))
                self.v_col.append(zeros(*np.delete(shape, d1)))
                self.v.append(zeros(1))

    def buffers(self):
        return {"v_row": self.v_row, "v_col": self.v_col, "v": self.v}

    def state_dict(self) -> dict:
        return {"count": self.count, **self.buffers()}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for key, tensors in self.buffers().items():
            for t, saved in zip(tensors, state[key], strict=True):
                t.copy_(saved)

    def updates(self, grads):
        count = self.count - 1  # optax's count before this update
        t = torch.tensor(count + 1, dtype=torch.float32)
        decay = (1.0 - t ** (-self.decay_rate)).item()
        lr = self.lr(count)
        out = []
        for path, p, g, dims, v_row, v_col, v in zip(self.paths, self.params, grads, self.dims, self.v_row,
                                                    self.v_col, self.v):
            g = flax_layout(gathered(g.float(), like=p), path)
            grad_sqr = g * g + self.eps
            if dims is not None:
                d1, d0 = dims
                v_row.copy_(decay * v_row + (1.0 - decay) * grad_sqr.mean(d0))
                v_col.copy_(decay * v_col + (1.0 - decay) * grad_sqr.mean(d1))
                row_col_mean = v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                update = g * (v_row / row_col_mean).pow(-0.5).unsqueeze(d0) * v_col.pow(-0.5).unsqueeze(d1)
            else:
                v.copy_(decay * v + (1.0 - decay) * grad_sqr)
                update = g * v.pow(-0.5)
            update = update / torch.clamp(update.pow(2).mean().sqrt() / self.clipping_threshold, min=1.0)
            rms = torch.clamp(_norm(p) / math.sqrt(p.numel()), min=self.min_scale)
            out.append(shard_of(flax_layout(-(lr * update) * rms, path), p))
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
        norm = global_norm(grads, like=self.params)
        if norm >= self.max_norm:
            grads = [local(g) / norm.to(g.dtype) * self.max_norm for g in grads]
        self.inner.step(grads)

    @property
    def params(self) -> list[torch.Tensor]:
        return self.inner.params

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
        self.params = list(params)
        self.mini_step = 0
        self.acc = _zeros_like(params)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        n = self.mini_step
        for acc, g in zip(self.acc, grads):
            acc.copy_((local(g).float() + n * acc) / (n + 1))
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
        return {"inner": self.inner.state_dict(), "mini_step": self.mini_step,
                "acc": [gathered(t, like=p) for t, p in zip(self.acc, self.params)]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.inner.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for t, saved, p in zip(self.acc, state["acc"], self.params, strict=True):
            t.copy_(shard_of(saved, p))


def build_optimizer(args, params: NamedParams, num_processes: int = 1):
    """The configured optimizer, schedule, clipping and gradient
    accumulation over ``params`` (``(flax path, parameter)`` pairs), the
    schedule stretched by ``num_processes`` (:func:`build_schedule`)."""
    optim = args.optim
    schedule = build_schedule(optim, num_processes)
    if optim.name == "adamw":
        tx = AdamW(params, schedule, weight_decay=optim.weight_decay)
    elif optim.name == "adamwscale":
        tx = AdamWScale(params, schedule, weight_decay=optim.weight_decay)
    elif optim.name == "muon":
        tx = Muon(params, schedule, build_schedule(optim, num_processes, base_lr=optim.base_lr_2),
                  adamw_wd=optim.weight_decay)
    elif optim.name == "adafactor":
        tx = Adafactor(params, schedule)
    else:
        raise NotImplementedError(optim.name)
    if optim.grad_clip and optim.grad_clip > 0:
        tx = ClipByGlobalNorm(tx, optim.grad_clip)
    if optim.grad_acc > 1:
        tx = MultiSteps(tx, optim.grad_acc, [p for _, p in params])
    return tx


def build_adamw_chain(optim, model: torch.nn.Module, grad_acc: int = 1):
    """The chain the diffusion, classifier and rhythm-complexion trainers
    build: ``optax.clip_by_global_norm(grad_clip)`` then ``optax.adamw``
    on the schedule with ``weight_decay`` on every leaf (no mask), under
    ``optax.MultiSteps(grad_acc)`` where ``grad_acc`` > 1. The diffusion
    trainer builds no ``MultiSteps`` whatever its config's ``grad_acc``, as
    the JAX one does, so each caller passes its own. With no mask the
    parameters' names are not read."""
    params = list(model.named_parameters())
    tx = ClipByGlobalNorm(AdamW(params, build_schedule(optim), optim.weight_decay, mask=None), optim.grad_clip)
    if grad_acc > 1:
        tx = MultiSteps(tx, grad_acc, [p for _, p in params])
    return tx
