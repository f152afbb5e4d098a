"""Classify a beatmap's mapper style on the port (``classifier_classify.py``):
one window at ``time`` seconds (default 0) through the classifier, the top
mappers printed with their confidences.

    python -m mapperatorinator_tpu_torch.classifier_classify -cn train_v1 model_path=DIR \
        beatmap_path=map.osu [audio_path=song.wav] [time=S] [mappers_path=...] [device=cpu]

``model_path`` holds the classifier's ``params.msgpack`` (the flax tree);
the model is built from the config (``configs/classifier/<name>.yaml``) and
runs on the card unless ``device=cpu`` is given.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from .audio.io import load_audio_file
from .config import load_classifier_config, parse_argv, select_device
from .models.classifier import build_classifier
from .models.io import load_params
from .osu import BeatmapParser, build_vocabulary
from .osu.beatmap import Beatmap

STEPS_PER_MILLISECOND = 0.1


def create_example(events, event_times, audio, time_s: float, args, vocab):
    """One (frames, tokens) window at ``time_s`` seconds
    (reference: classify.py:57-100)."""
    import numpy as np

    from .osu.events import Event, EventType

    frame_seq_len = args.data.src_seq_len - 1
    frame_size = args.model.spectrogram.hop_length
    sample_rate = args.model.spectrogram.sample_rate
    samples_per_sequence = frame_seq_len * frame_size
    sequence_duration = samples_per_sequence / sample_rate

    frame_start = int(time_s * sample_rate)
    frames = np.zeros(samples_per_sequence, np.float32)
    chunk = audio[frame_start : frame_start + samples_per_sequence]
    frames[: len(chunk)] = chunk

    window = [
        e for e, t in zip(events, event_times) if time_s <= t / 1000 < time_s + sequence_duration
    ]
    ts_range = vocab.event_range[EventType.TIME_SHIFT]
    tokens = np.full((args.data.tgt_seq_len,), vocab.pad_id, np.int64)
    for i, event in enumerate(window[: args.data.tgt_seq_len]):
        if event.type == EventType.TIME_SHIFT:
            value = int((event.value - time_s * 1000) * STEPS_PER_MILLISECOND)
            event = Event(EventType.TIME_SHIFT, int(np.clip(value, ts_range.min_value, ts_range.max_value)))
        tokens[i] = vocab.encode(event)

    return {
        "frames": frames[None],
        "decoder_input_ids": tokens[None],
        "decoder_attention_mask": (tokens != vocab.pad_id)[None],
    }


def get_mapper_names(path) -> dict[int, str]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    names = {}
    for item in data:
        names[item["user_id"]] = item["username"][0] if item.get("username") else "Unknown"
    return names


def load_model(args, vocab, device: torch.device):
    """The classifier of ``args`` with the weights of
    ``<model_path>/params.msgpack``, in eval mode on ``device`` (fp32, TF32
    off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = load_params(Path(args.model_path) / "params.msgpack", build_classifier(args, vocab))
    return model.to(device).eval()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, flags = parse_argv(argv, "train_v1", {"time=": 0.0})
    time_s = flags["time="]
    args = load_classifier_config(config_name, overrides)
    device = select_device(args)

    vocab = build_vocabulary(args)
    parser = BeatmapParser(args, vocab)
    model = load_model(args, vocab, device)

    beatmap_path = Path(args.beatmap_path)
    beatmap = Beatmap.from_path(beatmap_path)
    audio_path = args.audio_path or beatmap_path.parent / beatmap.audio_filename
    audio = load_audio_file(audio_path, args.model.spectrogram.sample_rate)
    events, event_times = parser.parse(beatmap, 1.0, None, (False, False))

    example = create_example(events, event_times, audio, time_s, args, vocab)
    with torch.inference_mode():
        out = model(*(torch.as_tensor(example[k], device=device)
                      for k in ("frames", "decoder_input_ids", "decoder_attention_mask")))
    logits = out["logits"][0].float().cpu().numpy()

    top_k = min(100, logits.shape[-1])
    order = np.argsort(logits)[::-1][:top_k]
    mapper_idx_id = {idx: uid for uid, idx in vocab.mapper_idx.items()}
    names = {}
    mappers_path = Path(args.mappers_path) if args.mappers_path else None
    if mappers_path is not None and mappers_path.exists():
        names = get_mapper_names(mappers_path)
    results = []
    for idx in order:
        mapper_id = mapper_idx_id.get(int(idx), -1)
        name = names.get(mapper_id, "Unknown")
        results.append((name, mapper_id, float(logits[idx])))
        print(f"Mapper: {name} ({mapper_id}) with confidence: {logits[idx]}")
    return results


if __name__ == "__main__":
    main()
