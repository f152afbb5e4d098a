"""MMRS dataset backend: parquet-indexed beatmapset folders, read through
the port's own parquet reader (:mod:`.parquet`), without pandas.

Layout: ``<root>/metadata.parquet`` (one row per beatmap) +
``<root>/data/<BeatmapSetFolder>/`` holding the audio and ``.osu`` files.
Star ratings come pre-computed per speed; filtering by
gamemode/ranked-status/year/difficulty happens on the table before
iteration. The JAX package holds the metadata in a DataFrame multi-indexed
by ``(BeatmapSetId, Id)``; the port holds it in :class:`MmrsTable`, which
keeps the same rows in the same order, and its filters and draws are the
JAX module's (``tests/test_torch_nojax.py`` holds the rest of the code to
it).
"""

from __future__ import annotations

import random
from datetime import datetime
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
from .ors import OrsDataset, get_flip_augment, get_speed_augment
from .parquet import read_table, table_row
from .sequence import SequenceProcessor

# StarRating arrays are indexed by these clock rates (reference:
# mmrs_dataset.py:236-241)
SPEED_RATIOS = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]


class MmrsTable:
    """The metadata's columns with its two index levels, ``set_ids``
    (``BeatmapSetId``) and ``ids`` (``Id``), apart, as a DataFrame indexed
    by them holds them: a row (:meth:`row`) has every other column."""

    def __init__(self, set_ids: np.ndarray, ids: np.ndarray, columns: dict[str, np.ndarray]):
        self.set_ids, self.ids, self.columns = set_ids, ids, columns

    def __len__(self) -> int:
        return len(self.ids)

    def take(self, positions) -> "MmrsTable":
        positions = np.asarray(positions, np.int64)
        return MmrsTable(self.set_ids[positions], self.ids[positions],
                         {name: col[positions] for name, col in self.columns.items()})

    def row(self, k: int) -> dict:
        """Row ``k`` as ``df.iloc[k]`` gives it."""
        return table_row(self.columns, k)

    def iterrows(self):
        """``(Id, row)`` of each row in order, as ``iterrows`` gives them on
        one set's rows (``df.loc[set_id]``)."""
        for k in range(len(self)):
            yield self.ids[k].item(), self.row(k)

    def unique_set_ids(self) -> np.ndarray:
        """The set ids in order of appearance (``Index.unique``)."""
        _, first = np.unique(self.set_ids, return_index=True)
        return self.set_ids[np.sort(first)]

    def loc(self, set_id) -> "MmrsTable":
        """The rows of one set (``df.loc[set_id]``)."""
        return self.take(np.flatnonzero(self.set_ids == set_id))

    def drop(self, beatmap_id) -> "MmrsTable":
        """Without the rows whose ``Id`` is ``beatmap_id`` (``drop`` on one
        set's rows)."""
        return self.take(np.flatnonzero(self.ids != beatmap_id))

    def sample(self) -> dict:
        """One row drawn as ``df.sample().iloc[0]`` draws it, from
        ``np.random``."""
        return self.row(int(np.random.choice(len(self), size=1, replace=False)[0]))


def load_mmrs_metadata(path) -> MmrsTable:
    """metadata.parquet -> the table sorted by (BeatmapSetId, Id), stably as
    ``sort_index`` sorts, with the file's pandas index as ``BeatmapIdx``
    (reference: data_utils.py:229-235)."""
    columns, index = read_table(Path(path) / "metadata.parquet")
    columns["BeatmapIdx"] = index
    set_ids, ids = columns.pop("BeatmapSetId"), columns.pop("Id")
    order = np.lexsort((ids, set_ids))
    return MmrsTable(set_ids, ids, columns).take(order)


def filter_mmrs_metadata(
    df: MmrsTable,
    *,
    start: Optional[int] = None,
    end: Optional[int] = None,
    subset_ids: Optional[list[int]] = None,
    gamemodes: Optional[list[int]] = None,
    ranked_statuses: Optional[list[int]] = None,
    min_year: Optional[int] = None,
    max_year: Optional[int] = None,
    min_difficulty: Optional[float] = None,
    max_difficulty: Optional[float] = None,
) -> MmrsTable:
    """Row filters applied before iteration (reference: data_utils.py:238-296),
    as the JAX function applies them to its DataFrame: ``start:end`` is the
    label slice ``first_level[start]`` .. ``first_level[end - 1]`` of the
    sorted set ids, ``subset_ids`` their rows in the list's order (a missing
    id raises ``KeyError``), a null fails every comparison."""
    if start is not None and end is not None:
        first_level = df.unique_set_ids()
        lo, hi = first_level[start], first_level[end - 1]
        df = df.take(np.flatnonzero((df.set_ids >= lo) & (df.set_ids <= hi)))
    if subset_ids is not None:
        missing = [i for i in subset_ids if not (df.set_ids == i).any()]
        if missing:
            raise KeyError(f"{missing} not in index")
        positions = [np.flatnonzero(df.set_ids == i) for i in subset_ids]
        df = df.take(np.concatenate(positions) if positions else [])
    if gamemodes is not None:
        df = df.take(np.flatnonzero(np.isin(df.columns["ModeInt"], gamemodes)))
    if ranked_statuses is not None:
        df = df.take(np.flatnonzero(np.isin(df.columns["Ranked"], ranked_statuses)))
    if min_year is not None:
        df = df.take(np.flatnonzero(df.columns["RankedDate"] >= np.datetime64(datetime(min_year, 1, 1))))
    if max_year is not None:
        df = df.take(np.flatnonzero(df.columns["RankedDate"] < np.datetime64(datetime(max_year + 1, 1, 1))))
    if min_difficulty is not None:
        df = df.take(np.flatnonzero(df.columns["DifficultyRating"] >= min_difficulty))
    if max_difficulty is not None:
        df = df.take(np.flatnonzero(df.columns["DifficultyRating"] <= max_difficulty))
    return df


class MmrsDataset:
    """Iterable over training sequences from an MMRS-layout dataset."""

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
            raise ValueError("MMRS dataset requires per_track to be True")
        if args.only_last_beatmap:
            raise ValueError("MMRS dataset does not support only_last_beatmap")
        self.args = args
        self.parser = parser
        self.vocab = vocab
        self.test = test
        self.path = Path(args.test_dataset_path if test else args.train_dataset_path)
        self.start = args.test_dataset_start if test else args.train_dataset_start
        self.end = args.test_dataset_end if test else args.train_dataset_end
        self.metadata = load_mmrs_metadata(self.path)
        self.subset_ids = subset_ids
        self.processor = SequenceProcessor(args, vocab, test=test, shared=shared)
        self.sample_weights = OrsDataset._get_sample_weights(args.sample_weights_path)

    def _get_filtered_metadata(self):
        return filter_mmrs_metadata(
            self.metadata,
            start=self.start,
            end=self.end,
            subset_ids=self.subset_ids,
            gamemodes=self.args.gamemodes,
            ranked_statuses=self.args.ranked_statuses,
            min_year=self.args.min_year,
            max_year=self.args.max_year,
            min_difficulty=self.args.min_difficulty,
            max_difficulty=self.args.max_difficulty,
        )

    @staticmethod
    def _get_difficulty(beatmap_metadata, speed: float = 1.0) -> float:
        return float(np.interp(speed, SPEED_RATIOS, beatmap_metadata["StarRating"]))

    def __iter__(self) -> Generator[dict, None, None]:
        metadata = self._get_filtered_metadata()
        set_ids = metadata.unique_set_ids()
        if not self.test:
            set_ids = np.random.permutation(set_ids)
        for set_id in set_ids:
            yield from self._iter_set(metadata.loc(set_id))

    def _iter_set(self, set_metadata) -> Generator[dict, None, None]:
        if self.args.add_gd_context and len(set_metadata) <= 1:
            return
        speed = get_speed_augment(
            self.test, self.args.dt_augment_prob, self.args.dt_augment_range, self.args.dt_augment_sqrt
        )
        flip = get_flip_augment(self.test, self.args.flip_horizontal_prob, self.args.flip_vertical_prob)
        track_path = self.path / "data" / set_metadata.row(0)["BeatmapSetFolder"]
        audio_path = track_path / set_metadata.row(0)["AudioFile"]
        try:
            audio_samples = load_audio_file(audio_path, self.args.sample_rate, speed, self.args.normalize_audio)
        except Exception as e:
            print(f"Failed to load audio file: {audio_path}: {e}")
            return
        for i, beatmap_metadata in set_metadata.iterrows():
            yield from self._iter_beatmap(audio_samples, i, beatmap_metadata, set_metadata, speed, flip)

    def _iter_beatmap(self, audio_samples, i, beatmap_metadata, set_metadata, speed, flip):
        context_info = None
        if len(self.args.context_types) > 0:
            context_info = random.choices(self.args.context_types, weights=self.args.context_weights)[0]
            if isinstance(context_info, (str, ContextType)):
                context_info = {"out": [ContextType.MAP], "in": [ContextType(context_info)]}
            else:
                context_info = {k: list(v) for k, v in context_info.items()}
            if ContextType.GD in context_info["in"] and len(set_metadata) <= 1:
                context_info["in"].remove(ContextType.GD)
                if len(context_info["in"]) == 0:
                    context_info["in"].append(ContextType.NONE)

        track_path = self.path / "data" / beatmap_metadata["BeatmapSetFolder"]
        beatmap_path = track_path / beatmap_metadata["BeatmapFile"]
        frames, frame_times = self.processor.get_frames(audio_samples)
        osu_beatmap = Beatmap.from_path(beatmap_path)

        def add_special_data(data: dict, bm_meta, beatmap: Beatmap) -> None:
            gamemode = int(bm_meta["ModeInt"])
            data["gamemode"] = gamemode
            data["beatmap_id"] = beatmap.beatmap_id
            data["beatmap_idx"] = bm_meta["BeatmapIdx"]
            data["difficulty"] = self._get_difficulty(bm_meta, speed)
            data["year"] = bm_meta["SubmittedDate"].year
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
                other_metadata = set_metadata.drop(i).sample()
                other_beatmap = Beatmap.from_path(track_path / other_metadata["BeatmapFile"])
                data["events"], data["event_times"] = self.parser.parse(other_beatmap, speed, None, flip)
                add_special_data(data["extra"], other_metadata, other_beatmap)
            elif context == ContextType.MAP:
                data["events"], data["event_times"] = self.parser.parse(osu_beatmap, speed, None, flip)
            elif context == ContextType.KIAI:
                data["events"], data["event_times"] = self.parser.parse_kiai(osu_beatmap, speed)
            elif context == ContextType.SV:
                if int(beatmap_metadata["ModeInt"]) == 3:
                    data["events"], data["event_times"] = self.parser.parse_scroll_speeds(osu_beatmap, speed)
                else:
                    data["events"], data["event_times"] = [], []
            return data

        extra_data = {
            "beatmap_idx": np.int64(
                beatmap_metadata["BeatmapIdx"]
                if self.test or random.random() >= self.args.class_dropout_prob
                else self.vocab.num_classes
            ),
            "mapper_idx": np.int64(
                self.vocab.get_mapper_idx(beatmap_metadata["UserId"])
                if self.test or random.random() >= self.args.mapper_dropout_prob
                else self.vocab.num_mapper_classes
            ),
            "difficulty": np.float32(self._get_difficulty(beatmap_metadata, speed)),
            "special": {},
        }
        add_special_data(extra_data["special"], beatmap_metadata, osu_beatmap)

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
