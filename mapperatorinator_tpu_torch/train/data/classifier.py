"""Classifier dataset: (audio window, tokenized map events) -> mapper label
(reference: ``classifier/libs/dataset/ors_dataset.py:159-540``).

Windows the audio with a random offset per beatmap, slices the parsed event
stream to each window, normalizes time shifts to window-relative steps,
tokenizes with the main vocabulary, and labels each window with the mapper's
class index. Beatmaps without a known mapper are skipped.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Generator, Optional

import numpy as np

from ...audio.io import load_audio_file
from ...osu.beatmap import Beatmap
from ...osu.events import Event, EventType
from ...osu.parsing import BeatmapParser
from ...osu.vocab import Vocabulary

MILLISECONDS_PER_SECOND = 1000
STEPS_PER_MILLISECOND = 0.1


class ClassifierDataset:
    def __init__(
        self,
        args,  # ClassifierConfig
        parser: BeatmapParser,
        vocab: Vocabulary,
        test: bool = False,
    ):
        self.args = args.data
        self.hop_length = args.model.spectrogram.hop_length
        self.sample_rate = args.model.spectrogram.sample_rate
        self.parser = parser
        self.vocab = vocab
        self.test = test
        self.path = Path(self.args.test_dataset_path if test else self.args.train_dataset_path)
        self.start = self.args.test_dataset_start if test else self.args.train_dataset_start
        self.end = self.args.test_dataset_end if test else self.args.train_dataset_end
        self.frame_seq_len = self.args.src_seq_len - 1

    def _get_frames(self, samples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        samples = np.pad(samples, [0, self.hop_length - len(samples) % self.hop_length])
        frames = samples.reshape(-1, self.hop_length)
        frames_per_ms = self.sample_rate / self.hop_length / MILLISECONDS_PER_SECOND
        return frames, np.arange(len(frames)) / frames_per_ms

    def _get_speed(self) -> float:
        if self.test or random.random() >= self.args.dt_augment_prob:
            return 1.0
        mi, ma = self.args.dt_augment_range
        return mi + random.random() * (ma - mi)

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

            speed = self._get_speed()
            audio_candidates = list(track.glob("audio.*"))
            if not audio_candidates:
                continue
            try:
                audio_samples = load_audio_file(audio_candidates[0], self.sample_rate, speed)
            except Exception as e:
                print(f"Failed to load audio file: {audio_candidates[0]}: {e}")
                continue

            for beatmap_name in metadata["Beatmaps"]:
                if self.args.min_difficulty > 0:
                    ratings = metadata["Beatmaps"][beatmap_name].get("StandardStarRating", {})
                    if float(ratings.get("0", 0.0)) < self.args.min_difficulty:
                        continue
                beatmap_path = (track / "beatmaps" / beatmap_name).with_suffix(".osu")
                if not beatmap_path.exists():
                    continue
                yield from self._iter_beatmap(audio_samples, beatmap_path, speed)

    def _iter_beatmap(self, audio_samples, beatmap_path: Path, speed: float):
        beatmap = Beatmap.from_path(beatmap_path)
        mapper_id = self.vocab.beatmap_mapper.get(beatmap.beatmap_id)
        if mapper_id is None or mapper_id not in self.vocab.mapper_idx:
            return
        label = self.vocab.mapper_idx[mapper_id]

        flip = (False, False)
        if self.args.augment_flip and not self.test:
            flip = (random.random() < 0.5, random.random() < 0.5)

        events, event_times = self.parser.parse(beatmap, speed, None, flip)
        frames, frame_times = self._get_frames(audio_samples)

        # start/end event index per frame (reference: ors_dataset.py:223-240)
        start_indices = []
        event_index = 0
        for t in frame_times:
            while event_index < len(events) and event_times[event_index] < t:
                event_index += 1
            start_indices.append(event_index)
        end_indices = start_indices[1:] + [len(events)]

        offset = random.randint(0, self.frame_seq_len) if not self.test else 0
        ts_start = self.vocab.event_start[EventType.TIME_SHIFT]
        ts_end = self.vocab.event_end[EventType.TIME_SHIFT]
        ts_range = self.vocab.event_range[EventType.TIME_SHIFT]

        for frame_start in range(offset, len(frames), self.frame_seq_len):
            frame_end = min(frame_start + self.frame_seq_len, len(frames))
            if events:
                ev = events[start_indices[frame_start] : end_indices[frame_end - 1]]
            else:
                ev = []

            start_time = frame_times[frame_start]
            tokens = np.full((self.args.tgt_seq_len,), self.vocab.pad_id, np.int64)
            n = 0
            for event in ev:
                if n >= self.args.tgt_seq_len:
                    break
                if event.type == EventType.TIME_SHIFT:
                    value = int((event.value - start_time) * STEPS_PER_MILLISECOND)
                    value = int(np.clip(value, ts_range.min_value, ts_range.max_value))
                    event = Event(EventType.TIME_SHIFT, value)
                tokens[n] = self.vocab.encode(event)
                n += 1

            if self.args.timing_random_offset > 0 and not self.test:
                shift = np.random.randint(
                    -self.args.timing_random_offset, self.args.timing_random_offset + 1, tokens.shape
                )
                is_ts = (tokens >= ts_start) & (tokens < ts_end)
                tokens = np.where(is_ts, np.clip(tokens + shift, ts_start, ts_end - 1), tokens)

            frame_chunk = frames[frame_start:frame_end]
            padded = np.zeros((self.frame_seq_len, frames.shape[-1]), np.float32)
            padded[: len(frame_chunk)] = frame_chunk

            yield {
                "frames": padded.reshape(-1),
                "decoder_input_ids": tokens,
                "decoder_attention_mask": (tokens != self.vocab.pad_id),
                "labels": np.int64(label),
            }
