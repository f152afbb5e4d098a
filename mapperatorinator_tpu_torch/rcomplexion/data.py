"""Rhythm-complexion training data: sliding token windows predicting the
time-shift token that precedes each timed event
(reference: ``rcomplexion/libs/dataset/data_utils.py:6-43``,
``rcomplexion/libs/dataset/ors_dataset.py``)."""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Generator

import numpy as np

from ..osu.beatmap import Beatmap
from ..osu.events import Event, EventType
from .parser import RParser
from .vocab import RTokenizer


def tokenize_events(events: list[Event], tokenizer: RTokenizer) -> np.ndarray:
    return np.array([tokenizer.encode(e) for e in events], np.int64)


def create_sequences(tokens: np.ndarray, src_seq_len: int, tokenizer: RTokenizer):
    """For each timed event at i, the window tokens[i-1-L : i-1] predicts
    tokens[i-1] (the TIME_SHIFT right before it). Returns (sequences, labels)."""
    timed = {
        tokenizer.encode(Event(EventType.CIRCLE)),
        tokenizer.encode(Event(EventType.SLIDER_HEAD)),
    }
    sequences, labels = [], []
    for i in range(src_seq_len + 1, len(tokens)):
        if int(tokens[i]) not in timed:
            continue
        sequences.append(tokens[i - 1 - src_seq_len : i - 1])
        labels.append(int(tokens[i - 1]))
    return sequences, labels


class RcomplexionDataset:
    """Streams (input_ids, labels) windows from an ORS-layout dataset."""

    def __init__(self, args, tokenizer: RTokenizer, test: bool = False):
        self.args = args.data
        self.tokenizer = tokenizer
        self.parser = RParser(args.data)
        self.test = test
        self.path = Path(self.args.test_dataset_path if test else self.args.train_dataset_path)
        self.start = self.args.test_dataset_start if test else self.args.train_dataset_start
        self.end = self.args.test_dataset_end if test else self.args.train_dataset_end

    def __iter__(self) -> Generator[dict, None, None]:
        tracks = [self.path / f"Track{i:05d}" for i in range(self.start, self.end)]
        if not self.test:
            random.shuffle(tracks)
        for track in tracks:
            metadata_file = track / "metadata.json"
            if not metadata_file.exists():
                continue
            with open(metadata_file) as f:
                metadata = json.load(f)
            for beatmap_name in metadata["Beatmaps"]:
                if self.args.min_difficulty > 0:
                    ratings = metadata["Beatmaps"][beatmap_name].get("StandardStarRating", {})
                    if float(ratings.get("0", 0.0)) < self.args.min_difficulty:
                        continue
                beatmap_path = (track / "beatmaps" / beatmap_name).with_suffix(".osu")
                if not beatmap_path.exists():
                    continue
                beatmap = Beatmap.from_path(beatmap_path)
                tokens = tokenize_events(self.parser.parse(beatmap), self.tokenizer)
                sequences, labels = create_sequences(tokens, self.args.src_seq_len, self.tokenizer)
                for seq, label in zip(sequences, labels):
                    yield {"input_ids": seq, "labels": np.int64(label)}
