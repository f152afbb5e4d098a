"""Local-folder streaming dataset ("ORS" layout: ``TrackNNNNN/beatmaps/*.osu``
+ ``metadata.json`` + ``audio.*``), unified onto the shared
:class:`SequenceProcessor` (the reference keeps a divergent pre-mixin copy
for ORS — reference: ``osuT5/osuT5/dataset/ors_dataset.py:28-769``; context
assembly follows the mixin-based ``mmrs_dataset.py:239-367``)."""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Any, Generator, Optional

import numpy as np

from ...audio.io import load_audio_file
from ...osu.beatmap import Beatmap
from ...osu.events import ContextType, EventType
from ...osu.parsing import BeatmapParser
from ...osu.streams import (
    get_hitsounded_status,
    get_hold_note_ratio,
    get_scroll_speed_ratio,
    get_song_length,
    remove_events_of_type,
)
from ...osu.vocab import Vocabulary
from .sequence import SequenceProcessor


def get_speed_augment(test, dt_augment_prob, dt_augment_range, dt_augment_sqrt=False) -> float:
    if test or random.random() >= dt_augment_prob:
        return 1.0
    mi, ma = dt_augment_range
    base = random.random()
    if dt_augment_sqrt:
        base = base**0.5
    return mi + (ma - mi) * base


def get_flip_augment(test, flip_horizontal_prob, flip_vertical_prob) -> tuple[bool, bool]:
    if test:
        return False, False
    return random.random() < flip_horizontal_prob, random.random() < flip_vertical_prob


class OrsDataset:
    """Iterable over training sequences from a local track-folder dataset."""

    def __init__(
        self,
        args,  # DataConfig
        parser: BeatmapParser,
        vocab: Vocabulary,
        beatmap_files: Optional[list[Path]] = None,
        test: bool = False,
        shared: Any = None,
    ):
        self.path = args.test_dataset_path if test else args.train_dataset_path
        self.start = args.test_dataset_start if test else args.train_dataset_start
        self.end = args.test_dataset_end if test else args.train_dataset_end
        self.args = args
        self.parser = parser
        self.vocab = vocab
        self.beatmap_files = beatmap_files
        self.test = test
        self.processor = SequenceProcessor(args, vocab, test=test, shared=shared)
        self.sample_weights = self._get_sample_weights(args.sample_weights_path)

    @staticmethod
    def _get_sample_weights(sample_weights_path):
        path = Path(sample_weights_path) if sample_weights_path else None
        if path is None or not path.exists():
            return None
        with open(path) as f:
            weights = {
                int(line.split(",")[0]): float(np.clip(float(line.split(",")[1]), 0.1, 10))
                for line in f.readlines()
            }
        mean = sum(weights.values()) / len(weights)
        return {k: v / mean for k, v in weights.items()}

    def _track_paths(self) -> list[Path]:
        return [Path(self.path) / f"Track{i:05d}" for i in range(self.start, self.end)]

    def __iter__(self) -> Generator[dict, None, None]:
        tracks = self._track_paths()
        if not self.test:
            random.shuffle(tracks)
        for track_path in tracks:
            yield from self._iter_track(track_path)

    def _iter_track(self, track_path: Path) -> Generator[dict, None, None]:
        metadata_file = track_path / "metadata.json"
        if not metadata_file.exists():
            return
        with open(metadata_file) as f:
            metadata = json.load(f)

        if self.args.add_gd_context and len(metadata["Beatmaps"]) <= 1:
            return

        speed = get_speed_augment(
            self.test, self.args.dt_augment_prob, self.args.dt_augment_range, self.args.dt_augment_sqrt
        )
        flip = get_flip_augment(self.test, self.args.flip_horizontal_prob, self.args.flip_vertical_prob)

        audio_candidates = list(track_path.glob("audio.*"))
        if not audio_candidates:
            return
        try:
            audio_samples = load_audio_file(
                audio_candidates[0], self.args.sample_rate, speed, self.args.normalize_audio
            )
        except Exception as e:
            print(f"Failed to load audio file: {audio_candidates[0]}: {e}")
            return

        beatmaps = (
            [list(metadata["Beatmaps"])[-1]] if self.args.only_last_beatmap else list(metadata["Beatmaps"])
        )
        for beatmap_name in beatmaps:
            beatmap_path = (track_path / "beatmaps" / beatmap_name).with_suffix(".osu")
            if not beatmap_path.exists():
                continue
            yield from self._iter_beatmap(audio_samples, beatmap_path, beatmap_name, metadata, speed, flip)

    def _get_difficulty(self, metadata: dict, beatmap_name: str, speed: float = 1.0) -> float:
        ratings = metadata["Beatmaps"][beatmap_name].get("StandardStarRating", {})
        key = "64" if speed == 1.5 else "0"
        return float(ratings.get(key, ratings.get("0", 0.0)))

    def _iter_beatmap(
        self, audio_samples, beatmap_path: Path, beatmap_name: str, metadata: dict, speed: float, flip
    ) -> Generator[dict, None, None]:
        context_info = None
        if len(self.args.context_types) > 0:
            context_info = random.choices(self.args.context_types, weights=self.args.context_weights)[0]
            if isinstance(context_info, (str, ContextType)):
                context_info = {"out": [ContextType.MAP], "in": [ContextType(context_info)]}
            else:
                context_info = {k: list(v) for k, v in context_info.items()}
            if ContextType.GD in context_info["in"] and len(metadata["Beatmaps"]) <= 1:
                context_info["in"].remove(ContextType.GD)
                if len(context_info["in"]) == 0:
                    context_info["in"].append(ContextType.NONE)

        frames, frame_times = self.processor.get_frames(audio_samples)
        osu_beatmap = Beatmap.from_path(beatmap_path)
        bm_meta = metadata["Beatmaps"][beatmap_name]

        def add_special_data(data: dict, beatmap: Beatmap, name: str) -> None:
            gamemode = int(beatmap.mode)
            data["gamemode"] = gamemode
            data["beatmap_id"] = beatmap.beatmap_id
            data["beatmap_idx"] = metadata["Beatmaps"][name]["Index"]
            data["difficulty"] = self._get_difficulty(metadata, name, speed)
            data["year"] = metadata["Beatmaps"][name].get("RankedYear", 2014)
            data["hitsounded"] = get_hitsounded_status(beatmap)
            data["song_length"] = get_song_length(audio_samples, self.args.sample_rate)
            if gamemode in (0, 2):
                data["global_sv"] = beatmap.slider_multiplier
                data["circle_size"] = beatmap.circle_size
            if gamemode == 3:
                data["keycount"] = int(beatmap.circle_size)
                data["hold_note_ratio"] = get_hold_note_ratio(beatmap)
            if gamemode in (1, 3):
                data["scroll_speed_ratio"] = get_scroll_speed_ratio(
                    beatmap, self.args.mania_bpm_normalized_scroll_speed
                )

        def get_context(context: ContextType, identifier: str, add_type: bool = True) -> dict:
            data = {"extra": {"context_type": context, "add_type": add_type, "id": f"{identifier}_{context.value}"}}
            if context == ContextType.NONE:
                data["events"], data["event_times"] = [], []
            elif context == ContextType.TIMING:
                data["events"], data["event_times"] = self.parser.parse_timing(osu_beatmap, speed)
            elif context == ContextType.NO_HS:
                hs_events, hs_times = self.parser.parse(osu_beatmap, speed, None, flip)
                data["events"], data["event_times"] = remove_events_of_type(
                    hs_events, hs_times, [EventType.HITSOUND, EventType.VOLUME]
                )
            elif context == ContextType.GD:
                others = [k for k in metadata["Beatmaps"] if k != beatmap_name]
                other_name = random.choice(others)
                other_beatmap = Beatmap.from_path((beatmap_path.parent / other_name).with_suffix(".osu"))
                data["events"], data["event_times"] = self.parser.parse(other_beatmap, speed, None, flip)
                add_special_data(data["extra"], other_beatmap, other_name)
            elif context == ContextType.MAP:
                data["events"], data["event_times"] = self.parser.parse(osu_beatmap, speed, None, flip)
            elif context == ContextType.KIAI:
                data["events"], data["event_times"] = self.parser.parse_kiai(osu_beatmap, speed)
            elif context == ContextType.SV:
                if int(osu_beatmap.mode) == 3:
                    data["events"], data["event_times"] = self.parser.parse_scroll_speeds(osu_beatmap, speed)
                else:
                    data["events"], data["event_times"] = [], []
            return data

        extra_data = {
            "beatmap_idx": np.int64(
                bm_meta["Index"]
                if self.test or random.random() >= self.args.class_dropout_prob
                else self.vocab.num_classes
            ),
            "difficulty": np.float32(self._get_difficulty(metadata, beatmap_name, speed)),
            "special": {},
        }
        add_special_data(extra_data["special"], osu_beatmap, beatmap_name)

        if self.sample_weights is not None:
            extra_data["sample_weights"] = np.float32(self.sample_weights.get(osu_beatmap.beatmap_id, 1.0))

        out_context = [
            get_context(c, "out", add_type=self.args.add_out_context_types) for c in context_info["out"]
        ]
        in_context = [get_context(c, "in") for c in context_info["in"]]
        if self.args.add_gd_context:
            in_context.append(get_context(ContextType.GD, "extra_gd", False))

        sequences = self.processor.create_sequences(frames, frame_times, out_context, in_context, extra_data)
        yield from self.processor.process_sequences(sequences, beatmap_path)
