"""Rhythm-complexity scoring over a dataset on the port
(``rcomplexion_inference.py``): for each beatmap, the entropy of OsuR's
next-note-timing prediction with an OD-scaled leniency window, normalised
by the drain time (seconds of active play). Writes
``rhythm_complexities.csv`` in the working directory.

    python -m mapperatorinator_tpu_torch.rcomplexion_inference -cn inference_v1 model_path=DIR \
        data.train_dataset_path=... [device=cpu]

``model_path`` holds OsuR's ``params.msgpack`` (the flax tree). Progress is
printed every ``PROGRESS_EVERY`` maps.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from .config import load_rcomplexion_config, parse_argv, select_device
from .models.classifier import OsuR, OsuRConfig
from .models.io import load_params
from .osu.beatmap import Beatmap
from .rcomplexion import RParser, RTokenizer

PROGRESS_EVERY = 100


def od_to_ms_300(od: float) -> float:
    """Hit window for a 300 in ms (public osu! formula)."""
    return 79.5 - 6.0 * od


def calc_rhythm_complexity(beatmap, apply_fn, tokenizer, parser, args) -> float:
    import numpy as np

    from .osu.beatmap import Slider
    from .rcomplexion import create_sequences, tokenize_events

    leniency = int(od_to_ms_300(beatmap.overall_difficulty) * args.data.time_resolution)
    tokens = tokenize_events(parser.parse(beatmap), tokenizer)
    sequences, labels = create_sequences(tokens, args.data.src_seq_len, tokenizer)
    if len(sequences) == 0:
        return 0.0

    # pad the batch dim to the next power of two, as the JAX function does
    # (its compiles are reused across beatmaps), so the logits are the same
    input_ids = np.stack(sequences, 0)
    n = len(input_ids)
    bucket = 1 << (n - 1).bit_length()
    if bucket > n:
        input_ids = np.concatenate([input_ids, np.zeros((bucket - n,) + input_ids.shape[1:], input_ids.dtype)])
    logits = apply_fn(input_ids)[:n]
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()

    total_loss = 0.0
    for i, label in enumerate(labels):
        aggregate = probs[i, max(0, label - leniency) : label + leniency].sum()
        total_loss += -float(np.log(np.clip(aggregate, 1e-4, 1)))

    # normalize by drain time (gaps > 5 s are breaks)
    break_threshold = 5000.0
    drain_ms = 0.0
    last_time = None
    for ho in beatmap.hit_objects(stacking=False):
        if last_time is not None and ho.time - last_time < break_threshold:
            drain_ms += ho.time - last_time
        last_time = ho.end_time if isinstance(ho, Slider) else ho.time
    if drain_ms == 0:
        return total_loss
    return total_loss / (drain_ms / 1000.0)


def load_osur(args, tokenizer: RTokenizer, device: torch.device) -> OsuR:
    """OsuR at the config's widths with the weights of
    ``<model_path>/params.msgpack``, in eval mode on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = OsuRConfig(vocab_size_in=tokenizer.vocab_size_in, vocab_size_out=tokenizer.vocab_size_out,
                     src_seq_len=args.data.src_seq_len, hidden_size=args.model.hidden_size)
    return load_params(Path(args.model_path) / "params.msgpack", OsuR(cfg)).to(device).eval()


def osur_logits(model: OsuR, device: torch.device):
    """``input_ids`` (numpy) -> OsuR's logits, a tensor on ``device``."""
    def apply_fn(input_ids):
        with torch.inference_mode():
            return model(torch.as_tensor(input_ids, device=device))["logits"]
    return apply_fn


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "inference_v1", {})
    args = load_rcomplexion_config(config_name, overrides)
    device = select_device(args)
    tokenizer = RTokenizer(args)
    parser = RParser(args.data)
    apply_fn = osur_logits(load_osur(args, tokenizer, device), device)

    beatmap_files = []
    root = Path(args.data.train_dataset_path)
    for i in range(args.data.train_dataset_start, args.data.train_dataset_end):
        beatmaps_dir = root / f"Track{i:05d}" / "beatmaps"
        if beatmaps_dir.is_dir():
            beatmap_files.extend(sorted(beatmaps_dir.glob("*.osu")))

    complexities = {}
    for n, beatmap_file in enumerate(beatmap_files, 1):
        beatmap = Beatmap.from_path(beatmap_file)
        complexities[beatmap.beatmap_id] = calc_rhythm_complexity(beatmap, apply_fn, tokenizer, parser, args)
        if n % PROGRESS_EVERY == 0 or n == len(beatmap_files):
            print(f"{n}/{len(beatmap_files)} beatmaps scored")

    out_path = Path("rhythm_complexities.csv")
    with open(out_path, "w") as f:
        for beatmap_id, value in complexities.items():
            f.write(f"{beatmap_id},{value}\n")
    print(f"Wrote {len(complexities)} rhythm complexities to {out_path}")
    return complexities


if __name__ == "__main__":
    main()
