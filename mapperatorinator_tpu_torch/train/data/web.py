"""Web-scrape dataset backend: parquet shards of beatmapsets with embedded
.osu text and audio, read through the port's own parquet reader
(:mod:`.parquet`), without pandas.

Row schema: ``{"json": {"beatmaps": [{...osu!web metadata..., "content":
"<.osu text>"}]}, "opus": <audio>}``. Shards come from a local directory of
``*.parquet`` files (under ``dataset_subset`` where one is set). The JAX
package can also stream them from a HuggingFace dataset repo with
``datasets``, over the network: the port does not, and a source that is not
a directory raises. Difficulty under DT augmentation is recomputed with the
native star-rating calculator. Outside ``_list_files`` and ``_rows`` the
code is the JAX module's (``tests/test_torch_nojax.py`` holds it to it).
"""

from __future__ import annotations

import random
from datetime import datetime
from pathlib import Path
from typing import Any, Generator, Iterable, Optional

import numpy as np

from ...audio.io import decode_audio_bytes, resample_and_speed
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
from .ors import get_flip_augment, get_speed_augment
from .parquet import read_table, table_row
from .sequence import SequenceProcessor


def parse_web_datetime(value: Any) -> Optional[datetime]:
    """(reference: data_utils.py:297-310)"""
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return None
    if isinstance(value, datetime):
        return value
    value = str(value).strip()
    if not value:
        return None
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return datetime.strptime(value, fmt)
        except ValueError:
            continue
    return None


def get_web_ranked_date(beatmap_metadata: dict) -> Optional[datetime]:
    return parse_web_datetime(beatmap_metadata.get("approved_date")) or parse_web_datetime(
        beatmap_metadata.get("submit_date")
    )


def get_web_submitted_date(beatmap_metadata: dict) -> Optional[datetime]:
    return parse_web_datetime(beatmap_metadata.get("submit_date")) or get_web_ranked_date(beatmap_metadata)


def filter_web_beatmaps(
    beatmaps: Iterable[dict],
    *,
    subset_ids: Optional[list[int]] = None,
    gamemodes: Optional[list[int]] = None,
    ranked_statuses: Optional[list[int]] = None,
    min_year: Optional[int] = None,
    max_year: Optional[int] = None,
    min_difficulty: Optional[float] = None,
    max_difficulty: Optional[float] = None,
) -> list[dict]:
    """Per-beatmap metadata filters (reference: data_utils.py:322-360)."""
    out = []
    for bm in beatmaps:
        if subset_ids is not None and int(bm.get("beatmap_id", -1)) not in subset_ids:
            continue
        if gamemodes is not None and int(bm.get("mode", -1)) not in gamemodes:
            continue
        if ranked_statuses is not None and int(bm.get("approved", -99)) not in ranked_statuses:
            continue
        if min_year is not None or max_year is not None:
            ranked_date = get_web_ranked_date(bm)
            if ranked_date is None:
                continue
            if min_year is not None and ranked_date.year < min_year:
                continue
            if max_year is not None and ranked_date.year > max_year:
                continue
        if min_difficulty is not None or max_difficulty is not None:
            rating = bm.get("difficultyrating")
            if rating is None:
                continue
            if min_difficulty is not None and float(rating) < min_difficulty:
                continue
            if max_difficulty is not None and float(rating) > max_difficulty:
                continue
        out.append(bm)
    return out


def load_web_audio(audio_obj, sample_rate: int, speed: float = 1.0, normalize: bool = False) -> np.ndarray:
    """Decode a web-dataset audio cell: a datasets-cast ``{"array",
    "sampling_rate"}`` dict, a raw-bytes dict, or raw bytes."""
    if isinstance(audio_obj, dict) and "array" in audio_obj:
        samples = np.asarray(audio_obj["array"], np.float32)
        if samples.ndim > 1:
            samples = samples.mean(axis=-1)
        samples = resample_and_speed(samples, int(audio_obj["sampling_rate"]), sample_rate, speed)
    else:
        raw = audio_obj.get("bytes") if isinstance(audio_obj, dict) else audio_obj
        samples = decode_audio_bytes(raw, sample_rate, speed)
    if normalize and samples.size:
        peak = np.abs(samples).max()
        if peak > 0:
            samples = samples / peak
    return samples


class WebDataset:
    """Iterable over training sequences from web-scrape parquet shards."""

    def __init__(
        self,
        args,  # DataConfig
        parser: BeatmapParser,
        vocab: Vocabulary,
        subset_ids: Optional[list[int]] = None,
        test: bool = False,
        shared: Any = None,
    ):
        if not args.per_track:
            raise ValueError("Web dataset requires per_track to be True")
        if args.only_last_beatmap:
            raise ValueError("Web dataset does not support only_last_beatmap")
        self.args = args
        self.parser = parser
        self.vocab = vocab
        self.subset_ids = subset_ids
        self.test = test
        self.shared = shared
        self.source = args.test_dataset_path if test else args.train_dataset_path
        start = args.test_dataset_start if test else args.train_dataset_start
        end = args.test_dataset_end if test else args.train_dataset_end
        self.files_split = self._list_files()[start:end]
        self.processor = SequenceProcessor(args, vocab, test=test, shared=shared)

    def _list_files(self) -> list:
        source = Path(self.source)
        if source.is_dir():
            pattern = f"{self.args.dataset_subset}/*.parquet" if self.args.dataset_subset else "**/*.parquet"
            return sorted(source.glob(pattern))
        raise NotImplementedError(
            f"web dataset source {self.source!r} is not a local directory: a HuggingFace dataset repo is listed and "
            "streamed over the network (huggingface_hub, datasets), which the port does not use; give a directory "
            "of *.parquet shards")

    def _rows(self) -> Generator[dict, None, None]:
        """Each shard's rows as the JAX ``df.iloc[i].to_dict()`` gives them, in
        the same order: the shards shuffled by ``random``, each shard's rows
        permuted by ``np.random``."""
        files = list(self.files_split)
        if not self.test:
            random.shuffle(files)
        for shard in files:
            columns, labels = read_table(shard)
            index = np.random.permutation(len(labels)) if not self.test else range(len(labels))
            for i in index:
                yield table_row(columns, int(i))

    def __iter__(self) -> Generator[dict, None, None]:
        for row in self._rows():
            yield from self._iter_row(row)

    def _get_difficulty(self, beatmap_metadata: dict, speed: float = 1.0) -> float:
        if speed != 1.0:
            content = beatmap_metadata.get("content")
            if content:
                from ...native import calculate_difficulty

                difficulty = calculate_difficulty(content=content, speed=speed)
                if difficulty is not None:
                    return difficulty
        rating = beatmap_metadata.get("difficultyrating")
        return float(rating) if rating is not None else 0.0

    def _iter_row(self, row: dict) -> Generator[dict, None, None]:
        meta = row.get("json") or {}
        if isinstance(meta, (str, bytes)):
            import json as _json

            meta = _json.loads(meta)
        beatmaps = filter_web_beatmaps(
            meta.get("beatmaps") or [],
            subset_ids=self.subset_ids,
            gamemodes=self.args.gamemodes,
            ranked_statuses=self.args.ranked_statuses,
            min_year=self.args.min_year,
            max_year=self.args.max_year,
            min_difficulty=self.args.min_difficulty,
            max_difficulty=self.args.max_difficulty,
        )
        if not beatmaps:
            return

        entries = []
        for bm_meta in beatmaps:
            content = bm_meta.get("content")
            if not content:
                continue
            try:
                entries.append({"metadata": bm_meta, "beatmap": Beatmap.from_string(content)})
            except Exception as e:
                print(f"Failed to parse web beatmap {bm_meta.get('beatmap_id', 'unknown')}: {e}")
        if not entries:
            return
        if self.args.add_gd_context and len(entries) <= 1:
            return

        speed = get_speed_augment(
            self.test, self.args.dt_augment_prob, self.args.dt_augment_range, self.args.dt_augment_sqrt
        )
        flip = get_flip_augment(self.test, self.args.flip_horizontal_prob, self.args.flip_vertical_prob)

        try:
            audio_samples = load_web_audio(row["opus"], self.args.sample_rate, speed, self.args.normalize_audio)
        except Exception as e:
            print(f"Failed to decode web audio for sample {row.get('__key__', 'unknown')}: {e}")
            return

        frames, frame_times = self.processor.get_frames(audio_samples)
        for i, entry in enumerate(entries):
            yield from self._iter_beatmap(audio_samples, frames, frame_times, entries, i, entry, speed, flip)

    def _iter_beatmap(self, audio_samples, frames, frame_times, entries, i, entry, speed, flip):
        bm_meta, osu_beatmap = entry["metadata"], entry["beatmap"]

        context_info = random.choices(self.args.context_types, weights=self.args.context_weights)[0]
        if isinstance(context_info, (str, ContextType)):
            context_info = {"out": [ContextType.MAP], "in": [ContextType(context_info)]}
        else:
            context_info = {k: list(v) for k, v in context_info.items()}
        if ContextType.GD in context_info["in"] and len(entries) <= 1:
            context_info["in"].remove(ContextType.GD)
            if len(context_info["in"]) == 0:
                context_info["in"].append(ContextType.NONE)

        def add_special_data(data: dict, meta: dict, beatmap: Beatmap) -> None:
            gamemode = int(meta["mode"])
            data["gamemode"] = gamemode
            data["beatmap_id"] = int(meta["beatmap_id"])
            data["beatmap_idx"] = self.vocab.beatmap_idx.get(int(meta["beatmap_id"]), int(meta["beatmap_id"]))
            data["difficulty"] = self._get_difficulty(meta, speed)
            submitted = get_web_submitted_date(meta)
            if submitted is not None:
                data["year"] = submitted.year
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
                other = random.choice([e for j, e in enumerate(entries) if j != i])
                data["events"], data["event_times"] = self.parser.parse(other["beatmap"], speed, None, flip)
                add_special_data(data["extra"], other["metadata"], other["beatmap"])
            elif context == ContextType.MAP:
                data["events"], data["event_times"] = self.parser.parse(osu_beatmap, speed, None, flip)
            elif context == ContextType.KIAI:
                data["events"], data["event_times"] = self.parser.parse_kiai(osu_beatmap, speed)
            elif context == ContextType.SV:
                if int(bm_meta["mode"]) == 3:
                    data["events"], data["event_times"] = self.parser.parse_scroll_speeds(osu_beatmap, speed)
                else:
                    data["events"], data["event_times"] = [], []
            return data

        beatmap_id = int(bm_meta["beatmap_id"])
        extra_data = {
            "beatmap_idx": np.int64(
                self.vocab.beatmap_idx.get(beatmap_id, self.vocab.num_classes)
                if self.test or random.random() >= self.args.class_dropout_prob
                else self.vocab.num_classes
            ),
            "mapper_idx": np.int64(
                self.vocab.get_mapper_idx(int(bm_meta.get("user_id", -1)))
                if self.test or random.random() >= self.args.mapper_dropout_prob
                else self.vocab.num_mapper_classes
            ),
            "difficulty": np.float32(self._get_difficulty(bm_meta, speed)),
            "special": {},
        }
        add_special_data(extra_data["special"], bm_meta, osu_beatmap)

        out_context = [
            get_context(c, "out", add_type=self.args.add_out_context_types) for c in context_info["out"]
        ]
        in_context = [get_context(c, "in") for c in context_info["in"]]
        if self.args.add_gd_context:
            in_context.append(get_context(ContextType.GD, "extra_gd", False))

        sequences = self.processor.create_sequences(frames, frame_times, out_context, in_context, extra_data)
        yield from self.processor.process_sequences(sequences, f"web:{beatmap_id}")
