"""Fixed-vocabulary event tokenizer.

Token-id layout is identical to the reference tokenizer (reference:
``osuT5/osuT5/tokenizer.py:21-245``) so published checkpoints and their
``tokenizer.json`` files load unchanged:

    [0]=PAD  [1]=SOS  [2]=EOS
    [3 .. offset)            per-ContextType SOS/EOS pairs (declaration order)
    [offset .. vocab_out)    output event ranges, in declaration order
    [vocab_out .. vocab_in)  input-only conditioning event ranges

Unlike the reference's per-call linear scan over ranges, this implementation
precomputes flat numpy lookup tables (id -> type, id -> value) at build time,
giving O(1) ``decode`` and vectorized ``decode_ids``/``encode_ids`` — the
decode loop post-processing on full songs touches hundreds of thousands of
tokens, so this matters on the host side of the TPU pipeline.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from .events import ContextType, Event, EventRange, EventType

MILLISECONDS_PER_SECOND = 1000
MILLISECONDS_PER_STEP = 10

# Special token ids (fixed, reference tokenizer.py:247-260).
PAD_ID = 0
SOS_ID = 1
EOS_ID = 2


class Vocabulary:
    """Bidirectional Event <-> token-id mapping with conditioning encoders."""

    def __init__(
        self,
        event_ranges: Sequence[EventRange] = (),
        input_event_ranges: Sequence[EventRange] = (),
        context_sos: Optional[dict[ContextType, int]] = None,
        context_eos: Optional[dict[ContextType, int]] = None,
        offset: Optional[int] = None,
        num_classes: int = 0,
        num_diff_classes: int = 0,
        max_difficulty: int = 0,
        num_cs_classes: int = 0,
        num_mapper_classes: int = 0,
        num_descriptor_classes: int = 0,
        beatmap_idx: Optional[dict[int, int]] = None,
        beatmap_mapper: Optional[dict[int, int]] = None,
        mapper_idx: Optional[dict[int, int]] = None,
        beatmap_descriptors: Optional[dict[int, list[int]]] = None,
        descriptor_idx: Optional[dict[str, int]] = None,
    ):
        self.context_sos = dict(context_sos or {})
        self.context_eos = dict(context_eos or {})
        self.offset = offset if offset is not None else 3 + 2 * len(self.context_sos)
        self.event_ranges = list(event_ranges)
        self.input_event_ranges = list(input_event_ranges)

        self.num_classes = num_classes
        self.num_diff_classes = num_diff_classes
        self.max_difficulty = max_difficulty
        self.num_cs_classes = num_cs_classes
        self.num_mapper_classes = num_mapper_classes
        self.num_descriptor_classes = num_descriptor_classes

        self.beatmap_idx = dict(beatmap_idx or {})
        self.beatmap_mapper = dict(beatmap_mapper or {})
        self.mapper_idx = dict(mapper_idx or {})
        self.beatmap_descriptors = dict(beatmap_descriptors or {})
        self.descriptor_idx = dict(descriptor_idx or {})

        self._build_tables()

    # -- table construction -------------------------------------------------

    def _build_tables(self) -> None:
        self.event_range: dict[EventType, EventRange] = {
            er.type: er for er in self.event_ranges
        } | {er.type: er for er in self.input_event_ranges}

        self.event_start: dict[EventType, int] = {}
        self.event_end: dict[EventType, int] = {}
        cursor = self.offset
        for er in list(self.event_ranges) + list(self.input_event_ranges):
            self.event_start[er.type] = cursor
            cursor += er.size
            self.event_end[er.type] = cursor

        self.vocab_size_out = self.offset + sum(er.size for er in self.event_ranges)
        self.vocab_size_in = self.vocab_size_out + sum(er.size for er in self.input_event_ranges)

        # Flat id -> (type index, value) tables for O(1)/vectorized decode.
        all_ranges = list(self.event_ranges) + list(self.input_event_ranges)
        self._types: list[Optional[EventType]] = [None] * self.vocab_size_in
        self._type_idx = np.full(self.vocab_size_in, -1, dtype=np.int32)
        self._values = np.zeros(self.vocab_size_in, dtype=np.int32)
        type_list = list(EventType)
        type_pos = {t: i for i, t in enumerate(type_list)}
        for er in all_ranges:
            start = self.event_start[er.type]
            ids = np.arange(start, start + er.size)
            self._type_idx[ids] = type_pos[er.type]
            self._values[ids] = np.arange(er.min_value, er.max_value + 1)
            for i in range(start, start + er.size):
                self._types[i] = er.type
        self._type_list = type_list

    # -- core encode / decode ------------------------------------------------

    @property
    def pad_id(self) -> int:
        return PAD_ID

    @property
    def sos_id(self) -> int:
        return SOS_ID

    @property
    def eos_id(self) -> int:
        return EOS_ID

    def encode(self, event: Event) -> int:
        er = self.event_range.get(event.type)
        if er is None:
            raise ValueError(f"unknown event type: {event.type}")
        if not er.min_value <= event.value <= er.max_value:
            raise ValueError(
                f"event value {event.value} is not within range "
                f"[{er.min_value}, {er.max_value}] for event type {event.type}"
            )
        return self.event_start[event.type] + event.value - er.min_value

    def decode(self, token_id: int) -> Event:
        if not self.offset <= token_id < self.vocab_size_in or self._types[token_id] is None:
            raise ValueError(f"id {token_id} is not mapped to any event")
        return Event(type=self._types[token_id], value=int(self._values[token_id]))

    def decode_ids(self, token_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized decode: returns (type_index, value) arrays; type index -1
        marks ids outside any event range (specials / context brackets)."""
        ids = np.asarray(token_ids)
        in_range = (ids >= self.offset) & (ids < self.vocab_size_in)
        safe = np.where(in_range, ids, 0)
        t = np.where(in_range, self._type_idx[safe], -1)
        v = np.where(in_range, self._values[safe], 0)
        return t, v

    def type_of(self, token_id: int) -> Optional[EventType]:
        """Event type of a token id, or None for specials; no exceptions."""
        if 0 <= token_id < self.vocab_size_in:
            return self._types[token_id]
        return None

    def event_type_range(self, event_type: EventType) -> tuple[int, int]:
        """Inclusive (first_id, last_id) span of an event type."""
        if event_type not in self.event_range:
            raise ValueError(f"unknown event type: {event_type}")
        return self.event_start[event_type], self.event_end[event_type] - 1

    # -- conditioning encoders (reference tokenizer.py:301-472) --------------

    def encode_gamemode(self, gamemode: int) -> int:
        return self.encode(Event(EventType.GAMEMODE, gamemode))

    def encode_diff_event(self, diff: float) -> Event:
        return Event(
            EventType.DIFFICULTY,
            int(np.clip(int(diff * self.num_diff_classes / self.max_difficulty), 0, self.num_diff_classes - 1)),
        )

    def encode_diff(self, diff: float) -> int:
        return self.encode(self.encode_diff_event(diff))

    @property
    def diff_unk(self) -> int:
        return self.encode(Event(EventType.DIFFICULTY, self.num_diff_classes))

    def decode_diff(self, token_id: int) -> float:
        if token_id == self.diff_unk:
            return -1
        if not (self.event_start[EventType.DIFFICULTY] <= token_id < self.event_end[EventType.DIFFICULTY]):
            raise ValueError(f"token id {token_id} is not a difficulty token")
        return self.decode(token_id).value * self.max_difficulty / self.num_diff_classes

    def encode_style_event(self, beatmap_id: int) -> Event:
        return Event(EventType.STYLE, self.beatmap_idx.get(beatmap_id, self.num_classes))

    def encode_style(self, beatmap_id: int) -> int:
        return self.encode(self.encode_style_event(beatmap_id))

    def encode_style_idx(self, beatmap_idx: int) -> int:
        return self.encode(Event(EventType.STYLE, beatmap_idx))

    @property
    def style_unk(self) -> int:
        return self.encode(Event(EventType.STYLE, self.num_classes))

    def encode_mapper_event(self, beatmap_id: int) -> Event:
        user_id = self.beatmap_mapper.get(beatmap_id, -1)
        return Event(EventType.MAPPER, self.mapper_idx.get(user_id, self.num_mapper_classes))

    def encode_mapper(self, beatmap_id: int) -> int:
        return self.encode(self.encode_mapper_event(beatmap_id))

    def encode_mapper_id(self, user_id: int) -> int:
        return self.encode(Event(EventType.MAPPER, self.mapper_idx.get(user_id, self.num_mapper_classes)))

    def get_mapper_idx(self, user_id: int) -> int:
        return self.mapper_idx.get(user_id, self.num_mapper_classes)

    @property
    def mapper_unk(self) -> int:
        return self.encode(Event(EventType.MAPPER, self.num_mapper_classes))

    def encode_cs_event(self, cs: float) -> Event:
        return Event(
            EventType.CS,
            int(np.clip(int(cs * (self.num_cs_classes - 1) / 10), 0, self.num_cs_classes - 1)),
        )

    def encode_cs(self, cs: float) -> int:
        return self.encode(self.encode_cs_event(cs))

    @property
    def cs_unk(self) -> int:
        return self.encode(Event(EventType.CS, self.num_cs_classes))

    def encode_descriptor_events(self, beatmap_id: int) -> list[Event]:
        return [
            Event(EventType.DESCRIPTOR, idx)
            for idx in self.beatmap_descriptors.get(beatmap_id, [self.num_descriptor_classes])
        ]

    def encode_descriptor(self, beatmap_id: int) -> list[int]:
        return [self.encode(e) for e in self.encode_descriptor_events(beatmap_id)]

    def encode_descriptor_name(self, descriptor: str) -> int:
        return self.encode_descriptor_idx(self.descriptor_idx.get(descriptor, self.num_descriptor_classes))

    def encode_descriptor_idx(self, descriptor_idx: int) -> int:
        return self.encode(Event(EventType.DESCRIPTOR, descriptor_idx))

    @property
    def descriptor_unk(self) -> int:
        return self.encode(Event(EventType.DESCRIPTOR, self.num_descriptor_classes))

    def descriptor_name(self, descriptor_idx: int) -> str:
        for name, idx in self.descriptor_idx.items():
            if idx == descriptor_idx:
                return name
        return "unknown"

    @property
    def year_unk(self) -> int:
        return self.encode(Event(EventType.YEAR, 2077))

    def encode_year(self, year: int) -> int:
        return self.encode(Event(EventType.YEAR, year))

    @staticmethod
    def ratio_to_value(ratio: float, resolution: int) -> int:
        value = int(np.clip(round(ratio * resolution), 0, resolution))
        if ratio <= 0:
            value = -1
        elif ratio >= 1:
            value = resolution + 1
        return value

    @property
    def hold_note_ratio_unk(self) -> int:
        return self.encode(Event(EventType.HOLD_NOTE_RATIO, 12))

    def encode_hold_note_ratio(self, hold_note_ratio: Optional[float]) -> int:
        if hold_note_ratio is None:
            return self.hold_note_ratio_unk
        return self.encode(Event(EventType.HOLD_NOTE_RATIO, self.ratio_to_value(hold_note_ratio, 10)))

    @property
    def scroll_speed_ratio_unk(self) -> int:
        return self.encode(Event(EventType.SCROLL_SPEED_RATIO, 12))

    def encode_scroll_speed_ratio(self, scroll_speed_ratio: Optional[float]) -> int:
        if scroll_speed_ratio is None:
            return self.scroll_speed_ratio_unk
        return self.encode(Event(EventType.SCROLL_SPEED_RATIO, self.ratio_to_value(scroll_speed_ratio, 10)))

    def encode_song_length_event(self, song_length: float) -> Event:
        return Event(EventType.SONG_LENGTH, int(np.clip(song_length // 10000, 0, 60)))

    def encode_song_length(self, song_length: float) -> int:
        return self.encode(self.encode_song_length_event(song_length))

    def encode_song_position_event(self, song_position: float, song_length: float) -> Event:
        return Event(EventType.SONG_POSITION, self.ratio_to_value(song_position / song_length, 100))

    def encode_song_position(self, song_position: float, song_length: float) -> int:
        return self.encode(self.encode_song_position_event(song_position, song_length))

    def encode_global_sv(self, global_sv: float) -> int:
        return self.encode(Event(EventType.GLOBAL_SV, round(float(np.clip(global_sv, 0.4, 3.6)) * 100)))

    # -- serialization (same JSON schema as reference tokenizer.py:703-843) --

    def state_dict(self) -> dict:
        er_dict = lambda er: {"type": er.type.value, "min_value": er.min_value, "max_value": er.max_value}
        return {
            "offset": self.offset,
            "context_sos": {k.value: v for k, v in self.context_sos.items()},
            "context_eos": {k.value: v for k, v in self.context_eos.items()},
            "event_ranges": [er_dict(er) for er in self.event_ranges],
            "input_event_ranges": [er_dict(er) for er in self.input_event_ranges],
            "num_classes": self.num_classes,
            "num_diff_classes": self.num_diff_classes,
            "max_difficulty": self.max_difficulty,
            "event_range": {k.value: er_dict(v) for k, v in self.event_range.items()},
            "event_start": {k.value: v for k, v in self.event_start.items()},
            "event_end": {k.value: v for k, v in self.event_end.items()},
            "vocab_size_out": self.vocab_size_out,
            "vocab_size_in": self.vocab_size_in,
            "beatmap_idx": self.beatmap_idx,
            "beatmap_mapper": self.beatmap_mapper,
            "mapper_idx": self.mapper_idx,
            "num_mapper_classes": self.num_mapper_classes,
            "beatmap_descriptors": self.beatmap_descriptors,
            "descriptor_idx": self.descriptor_idx,
            "num_descriptor_classes": self.num_descriptor_classes,
            "num_cs_classes": self.num_cs_classes,
        }

    @classmethod
    def from_state_dict(cls, sd: dict) -> "Vocabulary":
        load_er = lambda x: EventRange(EventType(x["type"]), x["min_value"], x["max_value"])
        vocab = cls(
            event_ranges=[load_er(x) for x in sd.get("event_ranges", [])],
            input_event_ranges=[load_er(x) for x in sd.get("input_event_ranges", [])],
            context_sos={ContextType(k): v for k, v in sd.get("context_sos", {}).items()},
            context_eos={ContextType(k): v for k, v in sd.get("context_eos", {}).items()},
            offset=sd.get("offset", 3),
            num_classes=sd["num_classes"],
            num_diff_classes=sd["num_diff_classes"],
            max_difficulty=sd["max_difficulty"],
            num_cs_classes=sd.get("num_cs_classes", 0),
            num_mapper_classes=sd.get("num_mapper_classes", 0),
            num_descriptor_classes=sd.get("num_descriptor_classes", 0),
            beatmap_idx={int(k): v for k, v in sd.get("beatmap_idx", {}).items()},
            beatmap_mapper={int(k): v for k, v in sd.get("beatmap_mapper", {}).items()},
            mapper_idx={int(k): v for k, v in sd.get("mapper_idx", {}).items()},
            beatmap_descriptors={int(k): v for k, v in sd.get("beatmap_descriptors", {}).items()},
            descriptor_idx=sd.get("descriptor_idx", {}),
        )
        # Serialized vocab sizes are authoritative (backward compat with
        # tokenizers whose ranges list predates some event types).
        if vocab.vocab_size_in != sd["vocab_size_in"] or vocab.vocab_size_out != sd["vocab_size_out"]:
            vocab.vocab_size_out = sd["vocab_size_out"]
            vocab.vocab_size_in = sd["vocab_size_in"]
            n = vocab.vocab_size_in
            if n > len(vocab._types):
                pad = n - len(vocab._types)
                vocab._types += [None] * pad
                vocab._type_idx = np.concatenate([vocab._type_idx, np.full(pad, -1, np.int32)])
                vocab._values = np.concatenate([vocab._values, np.zeros(pad, np.int32)])
        return vocab

    def save_pretrained(self, save_directory: Union[str, os.PathLike]) -> None:
        Path(save_directory).mkdir(parents=True, exist_ok=True)
        with open(Path(save_directory) / "tokenizer.json", "w", encoding="utf-8") as f:
            f.write(json.dumps(self.state_dict(), ensure_ascii=False))

    @classmethod
    def from_pretrained(cls, path: Union[str, os.PathLike], subfolder: Optional[str] = None) -> "Vocabulary":
        base = Path(path)
        if subfolder:
            base = base / subfolder
        file = base / "tokenizer.json" if base.is_dir() else base
        if not file.exists():
            raise FileNotFoundError(f"Could not find tokenizer.json at '{file}'")
        with open(file, encoding="utf-8") as f:
            return cls.from_state_dict(json.load(f))


def build_vocabulary(args=None) -> Vocabulary:
    """Construct a :class:`Vocabulary` from a TrainConfig.

    Range declaration order replicates the reference constructor
    (reference: ``osuT5/osuT5/tokenizer.py:47-245``) exactly — the order is
    part of the id layout and thus of checkpoint compatibility.
    """
    if args is None:
        return Vocabulary(
            event_ranges=_BASE_RANGES + _TAIL_RANGES,
            offset=3,
        )

    data = args.data
    meta = _load_metadata_indices(args)
    context_sos: dict[ContextType, int] = {}
    context_eos: dict[ContextType, int] = {}
    cursor = 3

    def add_context_type(ct: ContextType):
        nonlocal cursor
        if ct not in context_sos:
            context_sos[ct] = cursor
            cursor += 1
            context_eos[ct] = cursor
            cursor += 1

    for cts in data.context_types:
        if isinstance(cts, (str, ContextType)):
            add_context_type(ContextType(cts) if isinstance(cts, str) else cts)
        else:
            for c in cts["in"]:
                add_context_type(ContextType(c) if isinstance(c, str) else c)
            if data.add_out_context_types:
                for c in cts["out"]:
                    add_context_type(ContextType(c) if isinstance(c, str) else c)

    ms_per_seq = (
        (data.src_seq_len - 1) * args.model.spectrogram.hop_length
        * MILLISECONDS_PER_SECOND / args.model.spectrogram.sample_rate
    )
    max_time_shift = int(ms_per_seq / MILLISECONDS_PER_STEP)
    min_time_shift = -max_time_shift if data.add_pre_tokens or data.add_pre_tokens_at_step >= 0 else 0

    event_ranges = [
        EventRange(EventType.TIME_SHIFT, min_time_shift, max_time_shift),
        EventRange(EventType.SNAPPING, 0, 16),
    ]
    input_event_ranges: list[EventRange] = []

    num_classes = 0
    num_mapper_classes = meta["num_mapper_classes"]
    num_descriptor_classes = meta["num_descriptor_classes"]
    num_diff_classes = 0
    max_difficulty = 0
    num_cs_classes = 0

    if data.add_gamemode_token:
        input_event_ranges.append(EventRange(EventType.GAMEMODE, 0, 3))

    if args.model.do_style_embed or data.add_style_token:
        num_classes = max(data.num_classes, len(meta["beatmap_idx"]))
        if data.add_style_token:
            input_event_ranges.append(EventRange(EventType.STYLE, 0, num_classes))

    if data.add_diff_token:
        num_diff_classes = data.num_diff_classes
        max_difficulty = data.max_diff
        input_event_ranges.append(EventRange(EventType.DIFFICULTY, 0, num_diff_classes))

    if args.model.do_mapper_embed or data.add_mapper_token:
        if data.add_mapper_token:
            input_event_ranges.append(EventRange(EventType.MAPPER, 0, num_mapper_classes))

    if data.add_cs_token:
        num_cs_classes = data.num_cs_classes
        input_event_ranges.append(EventRange(EventType.CS, 0, num_cs_classes))

    if data.add_year_token:
        input_event_ranges.append(EventRange(EventType.YEAR, 2007, 2077))

    if data.add_hitsounded_token:
        input_event_ranges.append(EventRange(EventType.HITSOUNDED, 0, 1))

    if data.add_song_length_token:
        input_event_ranges.append(EventRange(EventType.SONG_LENGTH, 0, 60))

    if data.add_song_position_token:
        input_event_ranges.append(EventRange(EventType.SONG_POSITION, -1, 101))

    if data.add_descriptors:
        input_event_ranges.append(EventRange(EventType.DESCRIPTOR, 0, num_descriptor_classes))

    if data.add_distances:
        event_ranges.append(EventRange(EventType.DISTANCE, 0, 640))

    if data.add_positions:
        p = data.position_precision
        x_min, x_max, y_min, y_max = (v // p for v in data.position_range)
        if data.position_split_axes:
            event_ranges.append(EventRange(EventType.POS_X, x_min, x_max))
            event_ranges.append(EventRange(EventType.POS_Y, y_min, y_max))
        else:
            x_count = x_max - x_min + 1
            y_count = y_max - y_min + 1
            event_ranges.append(EventRange(EventType.POS, 0, x_count * y_count - 1))
            if data.position_refinement:
                ref_count = p // data.position_refinement
                event_ranges.append(EventRange(EventType.POS_REFINE, 0, ref_count * ref_count - 1))

    if 3 in data.gamemodes:
        if data.add_keycount_token:
            input_event_ranges.append(EventRange(EventType.MANIA_KEYCOUNT, 1, 18))
        if data.add_hold_note_ratio_token:
            input_event_ranges.append(EventRange(EventType.HOLD_NOTE_RATIO, -1, 12))
        event_ranges.append(EventRange(EventType.MANIA_COLUMN, 0, 17))

    if 1 in data.gamemodes or 3 in data.gamemodes or data.add_sv:
        if data.add_scroll_speed_ratio_token:
            input_event_ranges.append(EventRange(EventType.SCROLL_SPEED_RATIO, -1, 12))
        event_ranges.append(EventRange(EventType.SCROLL_SPEED, 0, 1000))

    if data.add_global_sv_token:
        input_event_ranges.append(EventRange(EventType.GLOBAL_SV, 40, 360))

    event_ranges += _TAIL_RANGES

    if data.add_timing_points:
        event_ranges.append(EventRange(EventType.TIMING_POINT, 0, 0))

    has_kiai_out = any(
        not isinstance(c, (str, ContextType)) and ContextType.KIAI in c["out"]
        for c in data.context_types
    )
    if data.add_kiai_special_token or data.add_kiai or has_kiai_out:
        event_ranges.append(EventRange(EventType.KIAI, 0, 1))

    if data.sustain_interval:
        event_ranges.append(EventRange(EventType.SLIDER_SUSTAIN, 0, 0))
        event_ranges.append(EventRange(EventType.SLIDER_REPEAT_SUSTAIN, 0, 0))
        event_ranges.append(EventRange(EventType.SPINNER_SUSTAIN, 0, 0))

    if 3 in data.gamemodes:
        event_ranges.append(EventRange(EventType.HOLD_NOTE, 0, 0))
        event_ranges.append(EventRange(EventType.HOLD_NOTE_END, 0, 0))
        event_ranges.append(EventRange(EventType.SCROLL_SPEED_CHANGE, 0, 0))
        if data.sustain_interval:
            event_ranges.append(EventRange(EventType.HOLD_NOTE_SUSTAIN, 0, 0))

    if 1 in data.gamemodes:
        event_ranges.append(EventRange(EventType.DRUMROLL, 0, 0))
        event_ranges.append(EventRange(EventType.DRUMROLL_END, 0, 0))
        event_ranges.append(EventRange(EventType.DENDEN, 0, 0))
        event_ranges.append(EventRange(EventType.DENDEN_END, 0, 0))
        if data.sustain_interval:
            event_ranges.append(EventRange(EventType.DRUMROLL_SUSTAIN, 0, 0))
            event_ranges.append(EventRange(EventType.DENDEN_SUSTAIN, 0, 0))

    return Vocabulary(
        event_ranges=event_ranges,
        input_event_ranges=input_event_ranges,
        context_sos=context_sos,
        context_eos=context_eos,
        offset=cursor,
        num_classes=num_classes,
        num_diff_classes=num_diff_classes,
        max_difficulty=max_difficulty,
        num_cs_classes=num_cs_classes,
        num_mapper_classes=num_mapper_classes,
        num_descriptor_classes=num_descriptor_classes,
        beatmap_idx=meta["beatmap_idx"],
        beatmap_mapper=meta["beatmap_mapper"],
        mapper_idx=meta["mapper_idx"],
        beatmap_descriptors=meta["beatmap_descriptors"],
        descriptor_idx=meta["descriptor_idx"],
    )


def _resolve_table_path(path_str: str) -> Optional[Path]:
    """Resolve a config-named metadata table path.

    Shipped configs name tables as ``datasets/<file>`` and reference-era
    configs as ``../../../datasets/<file>`` (hydra run-dir relative); both
    must resolve from any cwd against the repo checkout's ``datasets/``
    directory. Returns the first existing candidate, else None.
    """
    p = Path(path_str)
    repo_root = Path(__file__).resolve().parents[2]
    candidates = [p]
    if not p.is_absolute():
        candidates.append(repo_root / p)
        candidates.append(repo_root / "datasets" / p.name)
    for c in candidates:
        if c.exists():
            return c
    return None


def _load_metadata_indices(args) -> dict:
    """Dataset-metadata-derived lookup tables sizing the MAPPER/DESCRIPTOR/
    STYLE vocab ranges (reference: tokenizer.py:474-701).

    Local file sources (mappers JSON, descriptors CSV, tags-metadata JSON)
    are implemented; dataset-repo scans (mmrs parquet, HF web streaming) are
    deferred to the data layer. A config that names a table path that does
    not exist is a hard error (reference parity: tokenizer.py:565-571,
    690-693) — a silently empty vocab would produce a layout incompatible
    with checkpoints trained with the table. An empty path string means
    "explicitly no table" and yields empty tables without complaint.
    """
    out = {
        "beatmap_idx": {},
        "beatmap_mapper": {},
        "mapper_idx": {},
        "num_mapper_classes": 0,
        "beatmap_descriptors": {},
        "descriptor_idx": {},
        "num_descriptor_classes": 0,
    }
    data = args.data

    if args.model.do_mapper_embed or data.add_mapper_token:
        named = getattr(data, "mappers_path", "") or ""
        if named:
            path = _resolve_table_path(named)
            if path is None:
                raise ValueError(f"mappers_path {named} not found")
            with open(path, encoding="utf-8") as f:
                raw = json.load(f)
            out["beatmap_mapper"] = {int(k): v for k, v in raw.items()}
            unique_user_ids = list(set(out["beatmap_mapper"].values()))
            out["mapper_idx"] = {uid: i for i, uid in enumerate(unique_user_ids)}
            out["num_mapper_classes"] = len(unique_user_ids)

    if data.add_descriptors:
        source = getattr(data, "descriptor_source", "omdb")
        if source == "local" or data.dataset_type == "ors":
            named = getattr(data, "descriptors_path", "") or ""
            if named:
                path = _resolve_table_path(named)
                if path is None:
                    raise ValueError(f"descriptors_path {named} not found")
                with open(path, encoding="utf-8") as f:
                    lines = f.readlines()
                for line in lines:
                    _, name = line.strip().split(",")
                    if name not in out["descriptor_idx"]:
                        out["descriptor_idx"][name] = len(out["descriptor_idx"])
                for line in lines:
                    bid_str, name = line.strip().split(",")
                    out["beatmap_descriptors"].setdefault(int(bid_str), []).append(out["descriptor_idx"][name])
                out["num_descriptor_classes"] = len(out["descriptor_idx"])
        elif source in ("web", "user_tags"):
            named = getattr(data, "tags_metadata_path", "") or ""
            if named:
                path = _resolve_table_path(named)
                if path is None:
                    raise ValueError(f"tags_metadata_path {named} not found")
                with open(path, encoding="utf-8") as f:
                    tags = json.load(f)["tags"]
                out["descriptor_idx"] = {t["name"]: t["id"] for t in tags}
                out["num_descriptor_classes"] = max(out["descriptor_idx"].values()) + 1
        # per-beatmap descriptor lists for 'web'/'omdb' come from the data
        # layer's dataset scan, not needed for vocab layout.

    return out


# Ranges present with no config (reference tokenizer.py:53-57) ...
_BASE_RANGES = [
    EventRange(EventType.TIME_SHIFT, -512, 512),
    EventRange(EventType.SNAPPING, 0, 16),
    EventRange(EventType.DISTANCE, 0, 640),
]

# ... and the unconditional tail appended in all cases (tokenizer.py:179-195).
_TAIL_RANGES = [
    EventRange(EventType.NEW_COMBO, 0, 0),
    EventRange(EventType.HITSOUND, 0, 2**3 * 3 * 3),
    EventRange(EventType.VOLUME, 0, 100),
    EventRange(EventType.CIRCLE, 0, 0),
    EventRange(EventType.SPINNER, 0, 0),
    EventRange(EventType.SPINNER_END, 0, 0),
    EventRange(EventType.SLIDER_HEAD, 0, 0),
    EventRange(EventType.BEZIER_ANCHOR, 0, 0),
    EventRange(EventType.PERFECT_ANCHOR, 0, 0),
    EventRange(EventType.CATMULL_ANCHOR, 0, 0),
    EventRange(EventType.RED_ANCHOR, 0, 0),
    EventRange(EventType.LAST_ANCHOR, 0, 0),
    EventRange(EventType.SLIDER_END, 0, 0),
    EventRange(EventType.BEAT, 0, 0),
    EventRange(EventType.MEASURE, 0, 0),
]
