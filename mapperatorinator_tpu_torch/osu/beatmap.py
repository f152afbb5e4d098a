"""osu! beatmap (.osu) file model, parser, and serializer.

A from-scratch replacement for the external ``slider`` library the reference
depends on (reference: requirements.txt:8; used throughout
``osuT5/osuT5/dataset/osu_parser.py``). Semantics follow the osu! file format
(v14) and the client's gameplay rules:

* times are float milliseconds (the reference wraps them in ``timedelta``;
  we don't — this module is pure host-side code and float ms is simpler),
* timing points carry a ``parent`` link from inherited (green) points to the
  governing uninherited (red) point,
* slider end times derive from pixel length, slider multiplier, and the
  active SV at the head.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Union

import numpy as np

from .curves import PATH_TYPE_BY_LETTER, SliderPath

PLAYFIELD_CENTER = (256, 192)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass
class TimingPoint:
    offset: float  # ms
    ms_per_beat: float  # raw beatLength field (negative for inherited)
    meter: int = 4
    sample_type: int = 0  # osu 'sampleSet' column (0=inherit,1=normal,2=soft,3=drum)
    sample_index: int = 0
    volume: int = 100
    uninherited: bool = True
    kiai: bool = False
    effects: int = 0
    parent: Optional["TimingPoint"] = None  # set for inherited points

    @property
    def bpm(self) -> Optional[float]:
        if not self.uninherited or self.ms_per_beat <= 0:
            return None
        return 60000.0 / self.ms_per_beat

    @property
    def kiai_mode(self) -> bool:
        return self.kiai

    def sv_multiplier(self) -> float:
        """Slider-velocity multiplier encoded by an inherited point."""
        if self.uninherited or self.ms_per_beat >= 0 or math.isnan(self.ms_per_beat):
            return 1.0
        return float(np.clip(-100.0 / self.ms_per_beat, 0.01, 10.0))


@dataclass
class HitObject:
    x: float
    y: float
    time: float  # ms
    type_flags: int
    hitsound: int
    new_combo: bool = False
    combo_skip: int = 0
    addition: str = "0:0:0:0:"  # hitSample column

    @property
    def position(self) -> tuple[float, float]:
        return (self.x, self.y)

    @property
    def end_time(self) -> float:
        return self.time


@dataclass
class Circle(HitObject):
    pass


@dataclass
class Spinner(HitObject):
    _end_time: float = 0.0

    @property
    def end_time(self) -> float:
        return self._end_time


@dataclass
class HoldNote(HitObject):
    _end_time: float = 0.0

    @property
    def end_time(self) -> float:
        return self._end_time


@dataclass
class Slider(HitObject):
    curve_type: str = "B"  # letter code: L/P/C/B
    curve_points: list = field(default_factory=list)  # anchors excl. head
    repeat: int = 1
    length: float = 0.0  # pixel length
    edge_sounds: list = field(default_factory=list)
    edge_additions: list = field(default_factory=list)  # "set:addset" strings
    duration: float = 0.0  # full duration across all spans, ms

    _path: Optional[SliderPath] = None

    @property
    def end_time(self) -> float:
        return self.time + self.duration

    @property
    def span_duration(self) -> float:
        return self.duration / self.repeat

    @property
    def anchors(self) -> list[tuple[float, float]]:
        """All control points including the head, as (x, y) tuples —
        equivalent of the reference's ``slider.curve.points``."""
        return [(self.x, self.y)] + [(p[0], p[1]) for p in self.curve_points]

    @property
    def path(self) -> SliderPath:
        if self._path is None:
            self._path = SliderPath(
                PATH_TYPE_BY_LETTER.get(self.curve_type, "Bezier"),
                np.array(self.anchors, dtype=float),
                self.length,
            )
        return self._path

    def position_at_progress(self, progress: float) -> np.ndarray:
        """Position along one span at progress in [0, 1] — the reference's
        ``slider.curve(t)`` equivalent for t within a single span."""
        return self.path.position_at(progress)


@dataclass
class Beatmap:
    format_version: int = 14
    # [General]
    audio_filename: str = ""
    audio_lead_in: int = 0
    preview_time: int = -1
    countdown: int = 0
    sample_set: str = "Normal"
    stack_leniency: float = 0.7
    mode: int = 0
    letterbox_in_breaks: bool = False
    widescreen_storyboard: bool = False
    # [Editor]
    distance_spacing: float = 1.0
    beat_divisor: int = 4
    grid_size: int = 4
    timeline_zoom: float = 1.0
    bookmarks: list = field(default_factory=list)
    # [Metadata]
    title: str = ""
    title_unicode: str = ""
    artist: str = ""
    artist_unicode: str = ""
    creator: str = ""
    version: str = ""
    source: str = ""
    tags: str = ""
    beatmap_id: int = 0
    beatmap_set_id: int = -1
    # [Difficulty]
    hp_drain_rate: float = 5.0
    circle_size: float = 5.0
    overall_difficulty: float = 5.0
    approach_rate: float = 5.0
    slider_multiplier: float = 1.4
    slider_tick_rate: float = 1.0
    # [Events] (raw passthrough lines) + background filename
    events: list = field(default_factory=list)
    background: Optional[str] = None
    # content
    timing_points: list = field(default_factory=list)
    _hit_objects: list = field(default_factory=list)

    # -- queries (slider-library-compatible semantics) -----------------------

    def hit_objects(self, stacking: bool = False) -> list[HitObject]:
        # stacking is display-only; the reference always passes stacking=False
        return self._hit_objects

    def timing_point_at(self, time: float) -> Optional[TimingPoint]:
        """Last timing point with offset <= time; first point if none."""
        if not self.timing_points:
            return None
        result = None
        for tp in self.timing_points:
            if tp.offset <= time:
                result = tp
            else:
                break
        return result if result is not None else self.timing_points[0]

    def uninherited_timing_point_at(self, time: float) -> Optional[TimingPoint]:
        tp = self.timing_point_at(time)
        if tp is None:
            return None
        return tp if tp.parent is None else tp.parent

    @property
    def max_combo(self) -> int:
        return len(self._hit_objects)

    # -- parsing --------------------------------------------------------------

    @classmethod
    def from_path(cls, path: Union[str, Path]) -> "Beatmap":
        with open(path, encoding="utf-8-sig", errors="replace") as f:
            return cls.from_string(f.read())

    @classmethod
    def from_string(cls, text: str) -> "Beatmap":
        bm = cls()
        section = None
        for raw_line in text.splitlines():
            line = raw_line.strip()
            if not line or line.startswith("//"):
                continue
            if line.startswith("osu file format"):
                try:
                    bm.format_version = int(line.rsplit("v", 1)[1])
                except (ValueError, IndexError):
                    pass
                continue
            if line.startswith("[") and line.endswith("]"):
                section = line[1:-1].lower()
                continue
            try:
                bm._parse_line(section, line)
            except (ValueError, IndexError):
                continue  # skip malformed lines like the client does

        bm._link_timing_points()
        bm._finalize_hit_objects()
        return bm

    def _parse_line(self, section: Optional[str], line: str) -> None:
        if section in ("general", "editor", "metadata", "difficulty"):
            key, _, value = line.partition(":")
            self._set_kv(section, key.strip(), value.strip())
        elif section == "events":
            self.events.append(line)
            parts = line.split(",")
            if parts[0] in ("0", "Background") and len(parts) >= 3:
                self.background = parts[2].strip().strip('"')
        elif section == "timingpoints":
            self.timing_points.append(_parse_timing_point(line))
        elif section == "hitobjects":
            obj = _parse_hit_object(line)
            if obj is not None:
                self._hit_objects.append(obj)

    _KV_FIELDS = {
        "audiofilename": ("audio_filename", str),
        "audioleadin": ("audio_lead_in", int),
        "previewtime": ("preview_time", int),
        "countdown": ("countdown", int),
        "sampleset": ("sample_set", str),
        "stackleniency": ("stack_leniency", float),
        "mode": ("mode", int),
        "letterboxinbreaks": ("letterbox_in_breaks", lambda v: v == "1"),
        "widescreenstoryboard": ("widescreen_storyboard", lambda v: v == "1"),
        "distancespacing": ("distance_spacing", float),
        "beatdivisor": ("beat_divisor", int),
        "gridsize": ("grid_size", int),
        "timelinezoom": ("timeline_zoom", float),
        "bookmarks": ("bookmarks", lambda v: [int(x) for x in v.split(",") if x.strip()]),
        "title": ("title", str),
        "titleunicode": ("title_unicode", str),
        "artist": ("artist", str),
        "artistunicode": ("artist_unicode", str),
        "creator": ("creator", str),
        "version": ("version", str),
        "source": ("source", str),
        "tags": ("tags", str),
        "beatmapid": ("beatmap_id", int),
        "beatmapsetid": ("beatmap_set_id", int),
        "hpdrainrate": ("hp_drain_rate", float),
        "circlesize": ("circle_size", float),
        "overalldifficulty": ("overall_difficulty", float),
        "approachrate": ("approach_rate", float),
        "slidermultiplier": ("slider_multiplier", float),
        "slidertickrate": ("slider_tick_rate", float),
    }

    def _set_kv(self, section: str, key: str, value: str) -> None:
        spec = self._KV_FIELDS.get(key.lower())
        if spec is None:
            return
        attr, conv = spec
        setattr(self, attr, conv(value))

    def _link_timing_points(self) -> None:
        self.timing_points.sort(key=lambda tp: tp.offset)
        last_uninherited = None
        for tp in self.timing_points:
            if tp.uninherited:
                last_uninherited = tp
                tp.parent = None
            else:
                tp.parent = last_uninherited

    def _finalize_hit_objects(self) -> None:
        self._hit_objects.sort(key=lambda h: h.time)
        for obj in self._hit_objects:
            if isinstance(obj, Slider):
                obj.duration = self._slider_duration(obj)

    def _slider_duration(self, s: Slider) -> float:
        red = self.uninherited_timing_point_at(s.time)
        beat_duration = red.ms_per_beat if red is not None else 500.0
        green = self.timing_point_at(s.time)
        sv = green.sv_multiplier() if green is not None else 1.0
        if self.format_version < 8 and green is not None and not green.uninherited:
            # pre-v8 maps apply inherited multipliers without the SV cap
            raw = green.ms_per_beat
            sv = -100.0 / raw if raw < 0 else 1.0
        pixels_per_beat = self.slider_multiplier * 100.0 * sv
        if pixels_per_beat <= 0:
            return 0.0
        num_beats = (s.length * s.repeat) / pixels_per_beat
        return num_beats * beat_duration

    # -- serialization ---------------------------------------------------------

    def to_string(self) -> str:
        lines = [f"osu file format v{self.format_version}", ""]
        lines += [
            "[General]",
            f"AudioFilename: {self.audio_filename}",
            f"AudioLeadIn: {self.audio_lead_in}",
            f"PreviewTime: {self.preview_time}",
            f"Countdown: {self.countdown}",
            f"SampleSet: {self.sample_set}",
            f"StackLeniency: {self.stack_leniency}",
            f"Mode: {self.mode}",
            f"LetterboxInBreaks: {int(self.letterbox_in_breaks)}",
            f"WidescreenStoryboard: {int(self.widescreen_storyboard)}",
            "",
            "[Editor]",
            f"DistanceSpacing: {self.distance_spacing}",
            f"BeatDivisor: {self.beat_divisor}",
            f"GridSize: {self.grid_size}",
            f"TimelineZoom: {self.timeline_zoom}",
            "",
            "[Metadata]",
            f"Title:{self.title}",
            f"TitleUnicode:{self.title_unicode or self.title}",
            f"Artist:{self.artist}",
            f"ArtistUnicode:{self.artist_unicode or self.artist}",
            f"Creator:{self.creator}",
            f"Version:{self.version}",
            f"Source:{self.source}",
            f"Tags:{self.tags}",
            f"BeatmapID:{self.beatmap_id}",
            f"BeatmapSetID:{self.beatmap_set_id}",
            "",
            "[Difficulty]",
            f"HPDrainRate:{_fmt(self.hp_drain_rate)}",
            f"CircleSize:{_fmt(self.circle_size)}",
            f"OverallDifficulty:{_fmt(self.overall_difficulty)}",
            f"ApproachRate:{_fmt(self.approach_rate)}",
            f"SliderMultiplier:{_fmt(self.slider_multiplier)}",
            f"SliderTickRate:{_fmt(self.slider_tick_rate)}",
            "",
            "[Events]",
        ]
        lines += self.events
        lines += ["", "[TimingPoints]"]
        lines += [serialize_timing_point(tp) for tp in self.timing_points]
        lines += ["", "[HitObjects]"]
        lines += [serialize_hit_object(h) for h in self._hit_objects]
        lines.append("")
        return "\n".join(lines)


def _fmt(x: float) -> str:
    return str(int(x)) if float(x).is_integer() else str(x)


# ---------------------------------------------------------------------------
# line-level parsing
# ---------------------------------------------------------------------------


def _parse_timing_point(line: str) -> TimingPoint:
    parts = line.split(",")
    offset = float(parts[0])
    ms_per_beat = float(parts[1])
    meter = int(float(parts[2])) if len(parts) > 2 else 4
    sample_type = int(float(parts[3])) if len(parts) > 3 else 0
    sample_index = int(float(parts[4])) if len(parts) > 4 else 0
    volume = int(float(parts[5])) if len(parts) > 5 else 100
    uninherited = (int(float(parts[6])) == 1) if len(parts) > 6 else ms_per_beat >= 0
    effects = int(float(parts[7])) if len(parts) > 7 else 0
    return TimingPoint(
        offset=offset,
        ms_per_beat=ms_per_beat,
        meter=meter,
        sample_type=sample_type,
        sample_index=sample_index,
        volume=volume,
        uninherited=uninherited,
        kiai=bool(effects & 1),
        effects=effects,
    )


TYPE_CIRCLE = 1
TYPE_SLIDER = 2
TYPE_NEW_COMBO = 4
TYPE_SPINNER = 8
TYPE_HOLD = 128


def _parse_hit_object(line: str) -> Optional[HitObject]:
    parts = line.split(",")
    x, y = float(parts[0]), float(parts[1])
    time = float(parts[2])
    type_flags = int(parts[3])
    hitsound = int(parts[4])
    new_combo = bool(type_flags & TYPE_NEW_COMBO)
    combo_skip = (type_flags >> 4) & 0b111
    common = dict(
        x=x, y=y, time=time, type_flags=type_flags, hitsound=hitsound,
        new_combo=new_combo, combo_skip=combo_skip,
    )

    if type_flags & TYPE_CIRCLE:
        addition = parts[5] if len(parts) > 5 else "0:0:0:0:"
        return Circle(**common, addition=addition)

    if type_flags & TYPE_SLIDER:
        curve = parts[5]
        segs = curve.split("|")
        curve_type = segs[0] if segs[0] in PATH_TYPE_BY_LETTER else "B"
        curve_points = []
        for seg in segs[1:]:
            cx, _, cy = seg.partition(":")
            curve_points.append((float(cx), float(cy)))
        repeat = int(parts[6]) if len(parts) > 6 else 1
        length = float(parts[7]) if len(parts) > 7 and parts[7] else 0.0
        edge_sounds = [int(v) for v in parts[8].split("|") if v != ""] if len(parts) > 8 and parts[8] else []
        edge_additions = parts[9].split("|") if len(parts) > 9 and parts[9] else []
        addition = parts[10] if len(parts) > 10 else "0:0:0:0:"
        return Slider(
            **common,
            addition=addition,
            curve_type=curve_type,
            curve_points=curve_points,
            repeat=max(1, repeat),
            length=length,
            edge_sounds=edge_sounds,
            edge_additions=edge_additions,
        )

    if type_flags & TYPE_SPINNER:
        end_time = float(parts[5]) if len(parts) > 5 else time
        addition = parts[6] if len(parts) > 6 else "0:0:0:0:"
        return Spinner(**common, addition=addition, _end_time=end_time)

    if type_flags & TYPE_HOLD:
        # mania hold: x,y,time,type,hitSound,endTime:hitSample
        tail = parts[5] if len(parts) > 5 else str(int(time))
        end_str, _, addition = tail.partition(":")
        end_time = float(end_str) if end_str else time
        return HoldNote(**common, addition=addition or "0:0:0:0:", _end_time=end_time)

    return None


def serialize_timing_point(tp: TimingPoint) -> str:
    offset = _fmt(round(tp.offset, 6)) if isinstance(tp.offset, float) else str(tp.offset)
    msb = _fmt(tp.ms_per_beat) if float(tp.ms_per_beat).is_integer() else repr(tp.ms_per_beat)
    return (
        f"{offset},{msb},{tp.meter},{tp.sample_type},{tp.sample_index},"
        f"{tp.volume},{int(tp.uninherited)},{tp.effects | (1 if tp.kiai else 0)}"
    )


def serialize_hit_object(h: HitObject) -> str:
    t = int(round(h.time))
    x, y = int(round(h.x)), int(round(h.y))
    if isinstance(h, Slider):
        curve = "|".join([h.curve_type] + [f"{int(p[0]) if float(p[0]).is_integer() else p[0]}:"
                                           f"{int(p[1]) if float(p[1]).is_integer() else p[1]}"
                                           for p in h.curve_points])
        base = f"{x},{y},{t},{h.type_flags},{h.hitsound},{curve},{h.repeat},{_fmt(round(h.length, 12))}"
        if h.edge_sounds:
            base += "," + "|".join(str(s) for s in h.edge_sounds)
            base += "," + "|".join(h.edge_additions or ["0:0"] * (h.repeat + 1))
            base += f",{h.addition}"
        return base
    if isinstance(h, Spinner):
        return f"{x},{y},{t},{h.type_flags},{h.hitsound},{int(round(h.end_time))},{h.addition}"
    if isinstance(h, HoldNote):
        return f"{x},{y},{t},{h.type_flags},{h.hitsound},{int(round(h.end_time))}:{h.addition}"
    return f"{x},{y},{t},{h.type_flags},{h.hitsound},{h.addition}"
