"""Train the DiT coordinate model on the port (``diffusion_train.py``;
reference: ``osu_diffusion/train.py:90-255``).

    python -m mapperatorinator_tpu_torch.diffusion_train -cn v1 [key=value ...] [device=cpu]

The config is ``configs/diffusion/<name>.yaml``, composed as the JAX loader
composes it (``config.load_diffusion_config``). The DiT starts from flax's
initialisation (``models/params.init_dit_flax``), timesteps come from a
capped-uniform draw (``randint(0, max_diffusion_step)``) or the
loss-second-moment sampler (``model.schedule_sampler``), and each step
clips, runs AdamW with weight decay on every leaf (the JAX trainer builds
no ``MultiSteps``: ``optim.grad_acc`` is not read, nor is ``precision``),
then updates the EMA copy at 0.9999 and the sampler. The last step's EMA
weights are exported as a DiT bundle under ``<checkpoint_path>/final``,
which ``inference`` (``generate_positions``) and the JAX pipeline read.

On a CUDA tensor every attention call of the DiT runs kernel B's fp32 route
forward and kernel C's backward (no band and no key mask in training).
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import torch
from torch import nn

from .config import load_diffusion_config, parse_argv, select_device
from .diffusion import create_diffusion
from .diffusion.data import DiffusionDataset
from .diffusion.gaussian import Source
from .diffusion.schedule_sampler import TimestepSource, draw_timesteps, make_schedule_sampler
from .diffusion.vocab import DiffusionVocab
from .models.dit import DiT, DiTConfig
from .models.io import save_dit_bundle
from .models.params import init_dit_flax
from .train.data.batching import batch_iterator
from .train.loop import CheckpointManager, MetricsLogger, run_steps
from .train.optim import build_adamw_chain
from .train.step import to_device

BATCH_KEYS = ("x", "c", "y")  # positions, context, the multi-hot class vector


def make_diffusion_train_step(model: DiT, ema: DiT, diffusion, tx, ema_decay: float = 0.9999, max_t: int = 1000,
                              sampler=None):
    """The DiT train step (the JAX ``make_diffusion_train_step``):
    ``step(batch, sampler_state, t_source, noise_source) -> (loss,
    sampler_state)``, updating ``model``, ``ema`` and ``tx`` in place.

    Without a loss-aware sampler (None or ``uniform``) the timesteps are a
    uniform draw over [0, ``max_t``) and the losses enter unweighted;
    ``loss-second-moment`` draws them from the sampler, weights each
    sample's loss by its importance weight, and pushes the per-sample
    losses into the sampler's history after the EMA update. ``t_source``
    draws the timesteps (``schedule_sampler.draw_timesteps``), and
    ``noise_source`` the noise (``gaussian.Source``)."""
    loss_aware = sampler is not None and sampler.name != "uniform"
    params = list(model.parameters())
    ema_params = list(ema.parameters())

    def step(batch: dict, sampler_state: dict, t_source: TimestepSource, noise_source: Source):
        x = batch["x"]
        n = x.shape[0]
        if loss_aware:
            t, iw = sampler.sample(sampler_state, n, t_source)
        else:
            t = draw_timesteps(t_source, torch.full((max_t,), 1.0 / max_t, device=x.device), n)
            iw = None

        def model_fn(xt, tt):
            return model(xt, tt, batch["c"], batch["y"])

        per_sample = diffusion.training_losses(model_fn, x, t, noise_source)["loss"]
        loss = (per_sample * iw).mean() if loss_aware else per_sample.mean()
        tx.step(torch.autograd.grad(loss, params))
        with torch.no_grad():
            torch._foreach_mul_(ema_params, ema_decay)
            torch._foreach_add_(ema_params, torch._foreach_mul(params, 1 - ema_decay))
        if loss_aware:
            sampler_state = sampler.update(sampler_state, t, per_sample.detach())
        return loss.detach(), sampler_state

    return step


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "v1", {})
    args = load_diffusion_config(config_name, overrides)
    device = select_device(args)

    diffusion = create_diffusion(
        timestep_respacing="",
        noise_schedule=args.model.noise_schedule,
        diffusion_steps=args.model.diffusion_steps,
        use_l1=args.model.l1_loss,
    )
    vocab = DiffusionVocab.from_args(args)
    cfg = DiTConfig.from_name(args.model.model, context_size=args.model.context_size, class_size=vocab.num_tokens)
    model = DiT(cfg).to(device)
    init_dit_flax(model, args.seed)
    ema = copy.deepcopy(model).requires_grad_(False)
    tx = build_adamw_chain(args.optim, model)

    sampler = make_schedule_sampler(
        getattr(args.model, "schedule_sampler", "uniform") or "uniform",
        num_timesteps=args.model.diffusion_steps,
        max_timestep=args.model.max_diffusion_step,
    )
    step_fn = make_diffusion_train_step(model, ema, diffusion, tx, max_t=args.model.max_diffusion_step,
                                        sampler=sampler)
    ckpt_dir = Path(args.checkpoint_path or "diffusion_checkpoints")
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    sampler_state = sampler.init(device)

    def train_step(batch: dict) -> torch.Tensor:
        nonlocal sampler_state
        loss, sampler_state = step_fn(to_device(batch, device, BATCH_KEYS), sampler_state, gen, gen)
        return loss

    logger = MetricsLogger("logs/diffusion", log_with=args.logging.log_with)
    run_steps(args, lambda: batch_iterator(DiffusionDataset(args.data, vocab), args.optim.batch_size,
                                           drop_last=True), train_step,
              held=SimpleNamespace(step=0, model=nn.ModuleDict({"model": model, "ema": ema}), optimizer=tx),
              checkpoints=CheckpointManager(ckpt_dir), logger=logger)
    final_dir = ckpt_dir / "final"
    save_dit_bundle(final_dir, ema)  # the EMA weights, for sampling
    print(f"Saved final diffusion model to {final_dir}")
    logger.close()
    return model, ema


if __name__ == "__main__":
    main()
