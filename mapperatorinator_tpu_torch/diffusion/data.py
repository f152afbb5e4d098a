"""Diffusion data: beatmap -> 19-dim coordinate feature sequences. A copy of
the JAX ``diffusion/data.py`` (``tests/test_torch_nojax.py`` holds it to its
source); ``diffusion_sample`` uses its sequence and class-vector helpers,
and ``diffusion_train`` its dataset.

Port of the reference's data loading (reference:
``osu_diffusion/utils/data_loading.py:29-230, 467-521``): per-hit-object
datapoints (x, y, time, 16 one-hot types incl. new-combo and repeat classes),
slider control-point expansion, window split with stride, random flips,
distance-noise augmentation, relative-time sin/cos + distance embedding
context, and one-hot class vectors.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Generator, Optional

import numpy as np

from ..osu.beatmap import Beatmap, Circle, HitObject, HoldNote, Slider, Spinner
from .vocab import DiffusionVocab

PLAYFIELD = np.array([512.0, 384.0])
FEATURE_SIZE = 19


def repeat_type(repeat: int) -> int:
    if repeat < 4:
        return repeat - 1
    elif repeat % 2 == 0:
        return 3
    else:
        return 4


def create_datapoint(time: float, pos, datatype: int) -> np.ndarray:
    features = np.zeros(FEATURE_SIZE, np.float32)
    features[0] = max(-256, min(768, pos[0]))
    features[1] = max(-256, min(640, pos[1]))
    features[2] = time
    features[datatype + 3] = 1
    return features


def get_data(hitobj: HitObject) -> Optional[np.ndarray]:
    """(n, 19) datapoints for one hit object (reference: data_loading.py:66-130)."""
    if isinstance(hitobj, Slider) and len(hitobj.anchors) < max(16, min(128, int(hitobj.length * 0.5))):
        anchors = hitobj.anchors
        datapoints = [create_datapoint(hitobj.time, hitobj.position, 5 if hitobj.new_combo else 4)]
        duration = (hitobj.end_time - hitobj.time) / hitobj.repeat
        n = len(anchors)

        kind = {"L": 9, "C": 8, "P": 7, "B": 6}[hitobj.curve_type]
        if kind == 6:  # multi-bezier: red anchors for duplicated points
            for i in range(1, n - 1):
                time = hitobj.time + i / (n - 1) * duration
                pos = anchors[i]
                if pos == anchors[i + 1]:
                    datapoints.append(create_datapoint(time, pos, 9))
                elif pos != anchors[i - 1]:
                    datapoints.append(create_datapoint(time, pos, 6))
        else:
            for i in range(1, n - 1):
                time = hitobj.time + i / (n - 1) * duration
                datapoints.append(create_datapoint(time, anchors[i], kind))

        datapoints.append(create_datapoint(hitobj.time + duration, anchors[-1], 10))
        datapoints.append(
            create_datapoint(hitobj.end_time, hitobj.position_at_progress(1), 11 + repeat_type(hitobj.repeat))
        )
        return np.stack(datapoints, 0)

    if isinstance(hitobj, Spinner):
        return np.stack(
            [
                create_datapoint(hitobj.time, hitobj.position, 2),
                create_datapoint(hitobj.end_time, hitobj.position, 3),
            ],
            0,
        )

    if isinstance(hitobj, Circle):
        return create_datapoint(hitobj.time, hitobj.position, 1 if hitobj.new_combo else 0)[None]

    return None


def beatmap_to_sequence(beatmap: Beatmap) -> np.ndarray:
    """(19, T) feature sequence for the whole beatmap."""
    chunks = []
    for ho in beatmap.hit_objects(stacking=False):
        data = get_data(ho)
        if data is not None:
            chunks.append(data)
    if not chunks:
        return np.zeros((FEATURE_SIZE, 0), np.float32)
    seq = np.concatenate(chunks, axis=0)
    return np.ascontiguousarray(seq.T)


def calc_distances(seq: np.ndarray) -> np.ndarray:
    """Distance from each point to its predecessor, first vs playfield center."""
    offset = np.concatenate([np.array([[256.0], [192.0]]), seq[:2, :-1]], axis=1)
    return np.linalg.norm(seq[:2] - offset, axis=0)


def random_flip(seq_x: np.ndarray) -> np.ndarray:
    seq_x = seq_x.copy()
    if random.random() < 0.5:
        seq_x[0] = 512 - seq_x[0]
    if random.random() < 0.5:
        seq_x[1] = 384 - seq_x[1]
    return seq_x


def _timestep_embedding_np(t: np.ndarray, dim: int, max_period: float = 10000.0) -> np.ndarray:
    half = dim // 2
    freqs = np.exp(-np.log(max_period) * np.arange(half, dtype=np.float32) / half)
    args = t[:, None].astype(np.float32) * freqs[None]
    return np.concatenate([np.cos(args), np.sin(args)], axis=-1)


def split_and_process_sequence(
    seq: np.ndarray,
    double_time: bool = False,
    distance_std: float = 0.0,
    augment: bool = True,
) -> tuple[tuple[np.ndarray, np.ndarray], int]:
    """(19, T) -> ((2, T) normalized positions, (272, T) context), T."""
    seq_d = calc_distances(seq)
    if augment and distance_std > 0:
        seq_d = seq_d * np.power(2, np.random.normal(0, distance_std, seq_d.shape))

    positions = random_flip(seq[:2]) if augment else seq[:2]
    seq_x = positions / PLAYFIELD[:, None] * 2 - 1

    seq_o = seq[2].copy()
    if double_time:
        seq_o = seq_o / 1.5
    if augment:
        seq_o = seq_o - seq_o[0] + random.random() * 1000000

    seq_c = np.concatenate(
        [
            _timestep_embedding_np(seq_o * 0.1, 128).T,
            _timestep_embedding_np(seq_d, 128).T,
            seq[3:],
        ],
        axis=0,
    )
    return (seq_x, seq_c), seq.shape[1]


def get_class_vector(vocab: DiffusionVocab, beatmap_id, difficulty, mapper_id, descriptors, circle_size,
                     dropout: dict = None) -> np.ndarray:
    """One-hot class vector with optional per-signal dropout."""
    dropout = dropout or {}
    vec = np.zeros(vocab.num_tokens, np.float32)
    r = random.random
    if vocab.num_classes > 0:
        vec[vocab.style_unk if beatmap_id is None or r() < dropout.get("class", 0) else vocab.encode_style(beatmap_id)] = 1
    if vocab.num_diff_classes > 0:
        vec[vocab.diff_unk if difficulty is None or r() < dropout.get("diff", 0) else vocab.encode_diff(difficulty)] = 1
    if vocab.num_mapper_classes > 0:
        vec[vocab.mapper_unk if mapper_id is None or r() < dropout.get("mapper", 0) else vocab.encode_mapper(mapper_id)] = 1
    if vocab.num_descriptor_classes > 0:
        if descriptors and r() >= dropout.get("descriptor", 0):
            for d in descriptors:
                vec[vocab.encode_descriptor_name(d)] = 1
        else:
            vec[vocab.descriptor_unk] = 1
    if vocab.num_cs_classes > 0:
        vec[vocab.cs_unk if circle_size is None or r() < dropout.get("cs", 0) else vocab.encode_cs(circle_size)] = 1
    return vec


class DiffusionDataset:
    """Streams (x, c, y) windows from an ORS-layout dataset
    (reference: data_loading.py:330-521)."""

    def __init__(self, args, vocab: DiffusionVocab, test: bool = False):
        self.args = args
        self.vocab = vocab
        self.test = test
        self.path = Path(args.train_dataset_path)
        self.start = args.start
        self.end = args.end
        self.seq_len = args.seq_len
        self.stride = args.stride

    def __iter__(self) -> Generator[dict, None, None]:
        tracks = [self.path / f"Track{i:05d}" for i in range(self.start, self.end)]
        if not self.test and self.args.shuffle:
            random.shuffle(tracks)
        for track in tracks:
            metadata_file = track / "metadata.json"
            if not metadata_file.exists():
                continue
            with open(metadata_file) as f:
                metadata = json.load(f)
            for beatmap_name in metadata["Beatmaps"]:
                beatmap_path = (track / "beatmaps" / beatmap_name).with_suffix(".osu")
                if not beatmap_path.exists():
                    continue
                beatmap = Beatmap.from_path(beatmap_path)
                seq_full = beatmap_to_sequence(beatmap)
                if seq_full.shape[1] < self.seq_len:
                    continue
                double_time = not self.test and random.random() < self.args.double_time_prob
                (seq_x, seq_c), seq_len = split_and_process_sequence(
                    seq_full,
                    double_time=double_time,
                    distance_std=self.args.distance_std if not self.test else 0,
                    augment=not self.test,
                )
                bm_meta = metadata["Beatmaps"][beatmap_name]
                difficulty = bm_meta.get("StandardStarRating", {}).get("64" if double_time else "0")
                y = get_class_vector(
                    self.vocab,
                    bm_meta.get("BeatmapId"),
                    difficulty,
                    None,
                    None,
                    beatmap.circle_size,
                    dropout={
                        "class": self.args.class_dropout_prob,
                        "diff": self.args.diff_dropout_prob,
                        "mapper": self.args.mapper_dropout_prob,
                        "descriptor": self.args.descriptor_dropout_prob,
                        "cs": self.args.cs_dropout_prob,
                    }
                    if not self.test
                    else {},
                )
                for s in range(0, seq_len - self.seq_len + 1, self.stride):
                    yield {
                        "x": np.ascontiguousarray(seq_x[:, s : s + self.seq_len].T),
                        "c": np.ascontiguousarray(seq_c[:, s : s + self.seq_len].T),
                        "y": y,
                    }
