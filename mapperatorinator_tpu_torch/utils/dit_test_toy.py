"""DiT toy-pattern probe on the port (the repo's ``utils/dit_test_toy.py``):
in-paint the LAST hit-object position of a toy map and compare it with the
ground truth. Every position but the final step is held to the truth by the
in-paint ``denoised_fn`` at each DDPM step (``p_sample_loop``), under the
null class, with the band |q - k| <= 128 above 128 positions.

    python -m mapperatorinator_tpu_torch.utils.dit_test_toy --ckpt diffusion_checkpoints/final \\
        [--toy PATH.osu | --toy-dir utils/toy_datasets] [--num-predictions 16] \\
        [--num-sampling-steps 100] [--seed 0] [--device cpu]

``--ckpt`` is a DiT bundle (``dit_config.json`` + ``params.msgpack``, read
with :func:`..inference.load_diffusion_model`). Without it a random 2-layer
DiT, initialised as flax initialises it, is used (smoke mode: it proves the
harness end to end; the error statistic is meaningless there). The noise
comes from a ``torch.Generator`` seeded with ``--seed``. The model runs on
the card unless ``--device cpu`` is given; on the card each DiT forward runs
kernel B at every block, at batch ``--num-predictions``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import select_device
from ..diffusion import create_diffusion
from ..diffusion.data import PLAYFIELD, beatmap_to_sequence, split_and_process_sequence
from ..diffusion.gaussian import Source, normal
from ..models.dit import DiT, DiTConfig
from ..models.params import init_dit_flax
from ..osu.beatmap import Beatmap

REPO_ROOT = Path(__file__).resolve().parents[2]
BAND = 128  # the reference's banded attention above this many positions


def predict_last_position(model, beatmap, *, num_predictions=16, num_sampling_steps=100, cfg_scale=1.0,
                          seed=0, source: Source = None):
    """Returns (predictions (N, 2) in playfield px, actual (2,) px). The
    draws come from ``source`` (a ``torch.Generator`` on the model's device
    seeded with ``seed`` where none is given): the first is the starting
    noise, then one a sampling step."""
    device = next(model.parameters()).device
    seq = beatmap_to_sequence(beatmap)
    if seq.shape[1] < 2:
        raise ValueError("toy beatmap needs at least 2 objects")
    actual = seq[0:2, -1].copy()

    seq_rel = seq.copy()
    seq_rel[2] = seq_rel[2] - seq_rel[2][0]
    (seq_x, seq_c), seq_len = split_and_process_sequence(seq_rel, augment=False)

    diffusion = create_diffusion(timestep_respacing=[num_sampling_steps], noise_schedule="squaredcos_cap_v2")

    n = num_predictions
    x_true = torch.as_tensor(np.repeat(seq_x.T[None], n, axis=0), dtype=torch.float32, device=device)  # (N, T, 2)
    c = torch.as_tensor(np.repeat(seq_c.T[None], n, axis=0), dtype=torch.float32, device=device)
    y = torch.zeros((n, model.cfg.class_size), dtype=torch.float32, device=device)  # null class
    band = BAND if seq_len > BAND else None

    # in-paint mask: every position is ground truth except the final step
    mask = torch.zeros((n, seq_len, 2), dtype=torch.bool, device=device)
    mask[:, -1, :] = True

    def in_paint(x):
        return torch.where(mask, x, x_true)

    def model_fn(x, t):
        return model(x, t, c, y, band=band)

    if source is None:
        source = torch.Generator(device=device).manual_seed(seed)
    z = in_paint(normal(source, (n, seq_len, 2), x_true))
    with torch.inference_mode():
        samples = diffusion.p_sample_loop(model_fn, noise=z, source=source, clip_denoised=True,
                                          denoised_fn=in_paint)
    preds = (samples[:, -1, :].cpu().numpy() + 1) / 2 * np.asarray(PLAYFIELD)
    return preds, actual


def smoke_model(hidden: int, seed: int = 0) -> DiT:
    """The random 2-layer DiT of smoke mode, initialised as flax does."""
    model = DiT(DiTConfig(hidden_size=hidden, depth=2, num_heads=2, class_size=8))
    init_dit_flax(model, seed)
    return model


def run(args) -> list:
    from ..inference import load_diffusion_model

    device = select_device(args)
    if args.ckpt:
        model = load_diffusion_model(args.ckpt, device)
        if model is None:
            raise FileNotFoundError(f"no DiT bundle at {args.ckpt!r}")
    else:
        print("no --ckpt: random DiT (smoke mode, errors are meaningless)")
        model = smoke_model(args.smoke_hidden).to(device).eval()

    paths = [Path(args.toy)] if args.toy else sorted(Path(args.toy_dir).glob("*.osu"))
    if not paths:
        raise FileNotFoundError(f"no .osu toys under {args.toy_dir}")

    results = []
    for path in paths:
        beatmap = Beatmap.from_path(path)
        preds, actual = predict_last_position(
            model, beatmap,
            num_predictions=args.num_predictions,
            num_sampling_steps=args.num_sampling_steps,
            seed=args.seed,
        )
        err = np.linalg.norm(preds - actual[None], axis=-1)
        results.append({
            "toy": path.name,
            "actual": [round(float(v), 1) for v in actual],
            "mean_pred": [round(float(v), 1) for v in preds.mean(0)],
            "mean_err_px": round(float(err.mean()), 1),
            "median_err_px": round(float(np.median(err)), 1),
        })
        print(results[-1])
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, default=None, help="DiT bundle dir (dit_config.json + params.msgpack)")
    p.add_argument("--toy", type=str, default=None, help="one toy .osu (overrides --toy-dir)")
    p.add_argument("--toy-dir", type=str, default=str(REPO_ROOT / "utils" / "toy_datasets"))
    p.add_argument("--num-predictions", type=int, default=16)
    p.add_argument("--num-sampling-steps", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke-hidden", type=int, default=64, help="hidden size of the random smoke-mode DiT")
    p.add_argument("--device", type=str, default="auto", help="cpu, or the first CUDA card (auto, the default)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
