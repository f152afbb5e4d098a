"""DiT sampling of an existing beatmap on the PyTorch port: the counterpart of
the repo's ``diffusion_sample.py`` (reference: ``osu_diffusion/sample.py``),
with its flags and output names, on the card unless ``--device cpu``:

    python -m mapperatorinator_tpu_torch.diffusion_sample --beatmap map.osu \\
        --ckpt diffusion_checkpoints/final [--style-id 2592760] [--cfg-scale 1.5] \\
        [--num-sampling-steps 250] [--num-variants 3] [--refine-ckpt ...] \\
        [--plot-time 20000] [--device cpu]

Samples fresh hit-object coordinates from pure noise with a DiT bundle
(``dit_config.json`` + ``params.msgpack``) and writes each variant, and each
refined variant, as a new ``.osu`` difficulty. Banded attention over the
(optionally time-trimmed) sequence, a CFG dual batch against the null class,
an optional refine model's ``p_sample`` steps at t = 0, and a scatter plot
of a time window where matplotlib is installed (a message where it is not).
The class vocabulary is ``DiffusionVocab.from_args`` of the diffusion config
the model was trained with (``--config-name``, ``configs/diffusion/<name>.yaml``),
or a serialized one (``--vocab``).

Noise comes from a ``torch.Generator`` seeded with ``--seed`` on the device,
or, through :func:`main`'s ``noise``, a keyed callable ``noise(shape,
where)``: ``where`` is ``("init", 0)`` for the starting noise, ``("sample",
k)`` for the k-th DDPM step and ``("refine", r)`` for the r-th refine step,
so that the JAX script's draws can be replayed.
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np
import torch

from .config import load_diffusion_config, select_device
from .diffusion import create_diffusion
from .diffusion.data import PLAYFIELD, beatmap_to_sequence, get_class_vector, split_and_process_sequence
from .diffusion.export import sequence_to_beatmap
from .diffusion.gaussian import normal, scoped
from .diffusion.vocab import DiffusionVocab
from .inference import load_diffusion_model
from .osu.beatmap import Beatmap

CLEAN_FILENAME_RX = re.compile(r"[/\\?%*:|\"<>\x7F\x00-\x1F]")


def load_bundle(ckpt_path, device):
    """The DiT of a bundle directory, on ``device``."""
    model = load_diffusion_model(ckpt_path, device)
    if model is None:
        raise FileNotFoundError(f"no DiT bundle at {ckpt_path!r} (need dit_config.json + params.msgpack)")
    return model


@torch.no_grad()
def main(args, noise=None) -> list:
    torch.backends.cuda.matmul.allow_tf32 = False
    device = select_device(args)
    beatmap = Beatmap.from_path(args.beatmap)
    filename = CLEAN_FILENAME_RX.sub("-", f"{beatmap.beatmap_id} {beatmap.artist} - {beatmap.title}")
    result_dir = Path(args.output_dir) / filename
    result_dir.mkdir(parents=True, exist_ok=True)

    seq = beatmap_to_sequence(beatmap)  # (19, T) absolute times
    if seq.shape[1] == 0:
        raise ValueError(f"{args.beatmap} has no supported hit objects")
    if args.plot_time is not None:
        start = int(np.argmax(seq[2] >= args.plot_time))
        seq = seq[:, start : start + args.seq_len]
        print(f"Sequence trimmed to length {seq.shape[1]}")

    # context from window-relative times (reference: sample.py:61), export
    # keeps the absolute times
    seq_rel = seq.copy()
    seq_rel[2] = seq_rel[2] - seq_rel[2][0]
    (seq_x, seq_c), seq_len = split_and_process_sequence(seq_rel, augment=False)
    print(f"seq len {seq_len}")

    model = load_bundle(args.ckpt, device)
    dcfg = load_diffusion_config(args.config_name)
    if args.vocab and Path(args.vocab).exists():
        vocab = DiffusionVocab.from_pretrained(args.vocab)
    else:
        vocab = DiffusionVocab.from_args(dcfg)
    class_size = model.cfg.class_size
    if vocab.num_tokens != class_size:
        raise ValueError(f"vocab {vocab.num_tokens} classes != checkpoint class_size {class_size} "
                         f"(compose the config the model was trained with via --config-name)")

    diffusion = create_diffusion(
        timestep_respacing=[args.num_sampling_steps],
        noise_schedule="squaredcos_cap_v2",
    )

    n = args.num_variants
    cond_vec = get_class_vector(
        vocab, args.style_id, args.difficulty, None, None, beatmap.circle_size)
    null_vec = get_class_vector(vocab, None, None, None, None, None)

    if noise is None:
        noise = torch.Generator(device=device).manual_seed(args.seed)
    like = torch.empty(0, device=device)
    z = normal(scoped(noise, "init"), (n, seq_len, 2), like)

    # CFG dual batch: [cond; null] rows sharing the same noise half
    z2 = torch.cat([z, z])
    c = torch.as_tensor(np.repeat(seq_c.T[None], 2 * n, axis=0)).to(device, torch.float32)
    y = torch.as_tensor(np.stack([cond_vec] * n + [null_vec] * n, axis=0)).to(device, torch.float32)

    def model_fn(x, t):
        return model.forward_with_cfg(x, t, c, y, args.cfg_scale, band=args.seq_len)

    def to_sequences(x) -> list:
        """Sampled (2n, T, 2) -> n full (19, T) sequences with absolute times."""
        positions = x.cpu().numpy()[:n]  # cond half
        out = []
        for i in range(n):
            s = seq.copy()
            s[0:2] = ((positions[i].T + 1) / 2) * PLAYFIELD[:, None]
            out.append(s)
        return out

    def save_sequences(seqs, suffix="") -> list:
        paths = []
        for idx, s in enumerate(seqs):
            version = f"Diffusion {args.style_id} {idx}{suffix}"
            new_beatmap = sequence_to_beatmap(s, beatmap, version)
            out_path = result_dir / f"{beatmap.beatmap_id} result {args.style_id} {idx}{suffix}.osu"
            out_path.write_text(new_beatmap.to_string(), encoding="utf-8")
            paths.append(out_path)
            print(f"wrote {out_path}")
            if args.plot_time is not None:
                _plot(new_beatmap, result_dir / f"plot {idx}{suffix}.png",
                      args.plot_time, args.plot_width)
        return paths

    print(f"Sampling {n} variant(s), {args.num_sampling_steps} steps, cfg={args.cfg_scale}")
    samples = diffusion.p_sample_loop(model_fn, source=scoped(noise, "sample"), noise=z2, clip_denoised=True)
    paths = save_sequences(to_sequences(samples))

    if args.refine_ckpt:
        refine_model = load_bundle(args.refine_ckpt, device)

        def refine_fn(x, t):
            return refine_model.forward_with_cfg(x, t, c, y, args.cfg_scale, band=args.seq_len)

        img = samples
        source = scoped(noise, "refine")
        t = torch.zeros((img.shape[0],), dtype=torch.int64, device=device)
        for _ in range(args.refine_iters):
            img = diffusion.p_sample(refine_fn, img, t, source, clip_denoised=True)["sample"]
        paths += save_sequences(to_sequences(img), suffix=f" refined{args.refine_iters}")

    return paths


def _plot(beatmap, out_path, plot_time: float, plot_width: float) -> None:
    """Scatter the objects within [plot_time, plot_time + plot_width] ms."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    fig, ax = plt.subplots()
    for ho in beatmap.hit_objects():
        if plot_time <= ho.time <= plot_time + plot_width:
            ax.plot(ho.x, ho.y, "o")
    ax.axis("equal")
    ax.set_xlim([0, 512])
    ax.set_ylim([384, 0])
    fig.savefig(out_path)
    plt.close(fig)
    print(f"wrote {out_path}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--beatmap", type=str, required=True)
    parser.add_argument("--ckpt", type=str, required=True,
                        help="diffusion_train.py bundle dir (dit_config.json + params.msgpack)")
    parser.add_argument("--config-name", type=str, default="v1",
                        help="configs/diffusion/<name>.yaml the model was trained with")
    parser.add_argument("--vocab", type=str, default="",
                        help="optional serialized DiffusionVocab (style/mapper lookup tables)")
    parser.add_argument("--cfg-scale", type=float, default=1.0)
    parser.add_argument("--num-sampling-steps", type=int, default=250)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--seq-len", type=int, default=128, help="banded attention width")
    parser.add_argument("--style-id", type=int, default=None)
    parser.add_argument("--difficulty", type=float, default=None)
    parser.add_argument("--plot-time", type=float, default=None)
    parser.add_argument("--plot-width", type=float, default=2000)
    parser.add_argument("--num-variants", type=int, default=1)
    parser.add_argument("--refine-ckpt", type=str, default=None)
    parser.add_argument("--refine-iters", type=int, default=10)
    parser.add_argument("--output-dir", type=str, default="results")
    parser.add_argument("--device", type=str, default="auto", help="cpu, or the first CUDA device (auto, cuda)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
