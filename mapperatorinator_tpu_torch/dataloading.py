"""Dataset debug/audition tool on the port (the repo's ``dataloading.py``).

    python -m mapperatorinator_tpu_torch.dataloading -cn v32 [overrides...] [--mode stats|audition] [--limit N]

``stats``: iterate the training dataset and print token-length and context
statistics. ``audition``: write a WAV per inspected sample (at most 5, under
``audition/`` in the working directory) with a click at every TIME_SHIFT
token. The dataset is the port's :func:`.train.data.build_dataset`, of the
recipe's ``data.dataset_type``: ``web`` shards in a local directory, an
``mmrs`` root or ``ors`` track folders. It runs on the host: no model, no
card.
"""

from __future__ import annotations

import sys
import wave
from pathlib import Path

import numpy as np

from .config import load_train_config, parse_argv
from .osu import BeatmapParser, build_vocabulary
from .osu.events import EventType
from .train.data import build_dataset

STEPS_PER_MILLISECOND = 0.1


def add_hitsounds(audio: np.ndarray, tokens, vocab, sr: int) -> np.ndarray:
    """Overlay a 2 kHz click at every time event (reference: dataloading.py:19-48)."""

    start = vocab.event_start[EventType.TIME_SHIFT]
    end = vocab.event_end[EventType.TIME_SHIFT]
    out = audio.astype(np.float32).copy()
    dur = int(0.03 * sr)
    t = np.linspace(0, 0.03, dur, endpoint=False)
    click = 0.2 * np.sin(2 * np.pi * 2000 * t)
    for tok in np.asarray(tokens):
        if start <= tok < end:
            value = vocab.decode(int(tok)).value
            x = int(value / STEPS_PER_MILLISECOND / 1000 * sr)
            if 0 <= x < len(out):
                n = min(dur, len(out) - x)
                out[x : x + n] += click[:n]
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, flags = parse_argv(argv, "v32", {"--mode": "stats", "--limit": 200})
    mode, limit = flags["--mode"], flags["--limit"]

    args = load_train_config(config_name, overrides)
    vocab = build_vocabulary(args)
    parser = BeatmapParser(args, vocab)
    dataset = build_dataset(args.data, parser, vocab)

    if mode == "stats":
        lengths = []
        for i, sample in enumerate(dataset):
            if i >= limit:
                break
            mask = sample.get("decoder_attention_mask")
            lengths.append(int(np.asarray(mask).sum()) if mask is not None
                           else int((np.asarray(sample["decoder_input_ids"]) != vocab.pad_id).sum()))
        if not lengths:
            print("no samples produced")
            return
        lengths.sort()
        pct = lambda p: lengths[min(len(lengths) - 1, len(lengths) * p // 100)]  # noqa: E731
        print(f"sequences: {len(lengths)}  tokens: {sum(lengths)}")
        print(f"min/median/mean/max: {lengths[0]} / {pct(50)} / {sum(lengths)/len(lengths):.1f} / {lengths[-1]}")
        for p in (75, 90, 95, 99):
            print(f"p{p}: {pct(p)}")
        return lengths

    if mode == "audition":
        sr = args.model.spectrogram.sample_rate
        out_dir = Path("audition")
        out_dir.mkdir(exist_ok=True)
        written = []
        for i, sample in enumerate(dataset):
            if i >= min(limit, 5):
                break
            audio = np.asarray(sample["frames"], np.float32)
            mixed = add_hitsounds(audio, sample["decoder_input_ids"], vocab, sr)
            path = out_dir / f"sample{i}.wav"
            with wave.open(str(path), "wb") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes((np.clip(mixed, -1, 1) * 32767).astype("<i2").tobytes())
            print(f"wrote {path}")
            written.append(path)
        return written

    raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    main()
