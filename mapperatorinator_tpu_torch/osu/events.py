"""The osu! beatmap event language.

Beatmaps are described as a stream of discrete :class:`Event`s drawn from a
fixed vocabulary of event *types*, each carrying an integer value inside a
per-type range.  This is the lingua franca between the audio model, the
diffusion model and the ``.osu`` renderer.

Semantics match the reference event language (reference:
``osuT5/osuT5/event.py:7-91``) — the string values of the enums are part of
the serialized ``tokenizer.json`` format and therefore stable.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class EventType(Enum):
    TIME_SHIFT = "t"
    SNAPPING = "snap"
    DISTANCE = "dist"
    NEW_COMBO = "new_combo"
    HITSOUND = "hitsound"
    VOLUME = "volume"
    CIRCLE = "circle"
    SPINNER = "spinner"
    SPINNER_END = "spinner_end"
    SLIDER_HEAD = "slider_head"
    BEZIER_ANCHOR = "bezier_anchor"
    PERFECT_ANCHOR = "perfect_anchor"
    CATMULL_ANCHOR = "catmull_anchor"
    RED_ANCHOR = "red_anchor"
    LAST_ANCHOR = "last_anchor"
    SLIDER_END = "slider_end"
    BEAT = "beat"
    MEASURE = "measure"
    TIMING_POINT = "timing_point"
    GAMEMODE = "gamemode"
    STYLE = "style"
    DIFFICULTY = "difficulty"
    MAPPER = "mapper"
    CS = "cs"
    YEAR = "year"
    HITSOUNDED = "hitsounded"
    SONG_LENGTH = "song_length"
    SONG_POSITION = "song_position"
    GLOBAL_SV = "global_sv"
    MANIA_KEYCOUNT = "keycount"
    HOLD_NOTE_RATIO = "hold_note_ratio"
    SCROLL_SPEED_RATIO = "scroll_speed_ratio"
    DESCRIPTOR = "descriptor"
    POS_X = "pos_x"
    POS_Y = "pos_y"
    POS = "pos"
    KIAI = "kiai"
    MANIA_COLUMN = "column"
    HOLD_NOTE = "hold_note"
    HOLD_NOTE_END = "hold_note_end"
    SCROLL_SPEED_CHANGE = "scroll_speed_change"
    SCROLL_SPEED = "scroll_speed"
    DRUMROLL = "drumroll"
    DRUMROLL_END = "drumroll_end"
    DENDEN = "denden"
    DENDEN_END = "denden_end"
    CONTROL = "control"
    SLIDER_SUSTAIN = "slider_sustain"
    SLIDER_REPEAT_SUSTAIN = "slider_repeat_sustain"
    SPINNER_SUSTAIN = "spinner_sustain"
    HOLD_NOTE_SUSTAIN = "hold_note_sustain"
    DRUMROLL_SUSTAIN = "drumroll_sustain"
    DENDEN_SUSTAIN = "denden_sustain"
    POS_REFINE = "pos_refine"


class ContextType(Enum):
    """Kinds of auxiliary token streams fed to / produced by the model."""

    NONE = "none"
    TIMING = "timing"
    NO_HS = "no_hs"
    GD = "gd"
    MAP = "map"
    KIAI = "kiai"
    SV = "sv"


@dataclass(frozen=True)
class EventRange:
    """Inclusive integer value range for one event type."""

    type: EventType
    min_value: int
    max_value: int

    @property
    def size(self) -> int:
        return self.max_value - self.min_value + 1


@dataclass
class Event:
    type: EventType
    value: int = 0

    def __repr__(self) -> str:
        return f"{self.type.value}{self.value}"

    def __str__(self) -> str:
        return f"{self.type.value}{self.value}"


# Event types that denote the *onset* of a new hit object.
HIT_TYPE_EVENTS = frozenset(
    {
        EventType.CIRCLE,
        EventType.SPINNER,
        EventType.SPINNER_END,
        EventType.SLIDER_HEAD,
        EventType.BEZIER_ANCHOR,
        EventType.PERFECT_ANCHOR,
        EventType.CATMULL_ANCHOR,
        EventType.RED_ANCHOR,
        EventType.LAST_ANCHOR,
        EventType.SLIDER_END,
        EventType.HOLD_NOTE,
        EventType.HOLD_NOTE_END,
        EventType.DRUMROLL,
        EventType.DRUMROLL_END,
        EventType.DENDEN,
        EventType.DENDEN_END,
    }
)
