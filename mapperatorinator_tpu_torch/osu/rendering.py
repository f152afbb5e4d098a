"""Events -> .osu renderer ("postprocessor").

Deterministic host-side stage turning the model's event stream into a valid
beatmap file (reference: ``osuT5/osuT5/inference/postprocessor.py:122-1001``):
slider reconstruction (repeats from span/total duration, SliderPath length,
"human" SV quantization and length re-fit, control-point scaling), per-node
hitsound/volume greenline writes, taiko drumrolls as zigzag sliders, mania
hold notes, kiai and normalized scroll-speed greenlines, timing inference
from beat markers (redlines with human BPM rounding, split-search, meter
repair), beat-snap resnapping, near-perfect-overlap snapping, add-to-beatmap
merging, and .osz export.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import zipfile
from string import Template
from typing import Optional

import numpy as np

from .beatmap import Beatmap, TimingPoint, serialize_timing_point
from .curves import SliderPath
from .events import Event, EventType
from .streams import BEAT_TYPES, Group, get_groups, get_median_mpb
from .timing import TimingPointsChange, sort_timing_points

STEPS_PER_MILLISECOND = 0.1

OSU_TEMPLATE = """osu file format v14

[General]
AudioFilename: $audio_filename
AudioLeadIn: 0
PreviewTime: $preview_time
Countdown: 0
SampleSet: All
StackLeniency: 0.7
Mode: $mode
LetterboxInBreaks: 0
WidescreenStoryboard: 1
OverlayPosition: Above

[Editor]
DistanceSpacing: 1.0
BeatDivisor: 4
GridSize: 8
TimelineZoom: 2.2

[Metadata]
Title:$title
TitleUnicode:$title_unicode
Artist:$artist
ArtistUnicode:$artist_unicode
Creator:$creator
Version:$version
Source:$source
Tags:$tags

[Difficulty]
HPDrainRate:$hp_drain_rate
CircleSize:$circle_size
OverallDifficulty:$overall_difficulty
ApproachRate:$approach_rate
SliderMultiplier:$slider_multiplier
SliderTickRate:$slider_tick_rate

[Events]
//Background and Video events
$background_line//Break Periods
//Storyboard Layer 0 (Background)
//Storyboard Layer 1 (Fail)
//Storyboard Layer 2 (Pass)
//Storyboard Layer 3 (Foreground)
//Storyboard Layer 4 (Overlay)
//Storyboard Sound Samples

[TimingPoints]
$timing_points

[HitObjects]
$hit_objects
"""


@dataclasses.dataclass
class BeatmapConfig:
    audio_filename: str = ""
    preview_time: int = -1
    mode: int = 0
    title: str = ""
    title_unicode: str = ""
    artist: str = ""
    artist_unicode: str = ""
    creator: str = ""
    version: str = ""
    source: str = ""
    tags: str = ""
    hp_drain_rate: float = 5
    circle_size: float = 4
    overall_difficulty: float = 8
    approach_rate: float = 9
    slider_multiplier: float = 1.4
    slider_tick_rate: float = 1
    bpm: float = 120
    offset: int = 0
    background_line: str = ""


def background_line(background: Optional[str]) -> str:
    return f'0,0,"{os.path.basename(background)}",0,0\n' if background else ""


def beatmap_config_from_beatmap(beatmap: Beatmap) -> BeatmapConfig:
    reds = [tp for tp in beatmap.timing_points if tp.uninherited]
    max_bpm = max((tp.bpm for tp in reds if tp.bpm), default=120)
    return BeatmapConfig(
        audio_filename=beatmap.audio_filename,
        preview_time=int(beatmap.preview_time),
        mode=int(beatmap.mode),
        title=beatmap.title,
        title_unicode=beatmap.title_unicode,
        artist=beatmap.artist,
        artist_unicode=beatmap.artist_unicode,
        creator=beatmap.creator,
        version=beatmap.version,
        source=beatmap.source,
        tags=beatmap.tags,
        hp_drain_rate=beatmap.hp_drain_rate,
        circle_size=beatmap.circle_size,
        overall_difficulty=beatmap.overall_difficulty,
        approach_rate=beatmap.approach_rate,
        slider_multiplier=beatmap.slider_multiplier,
        slider_tick_rate=beatmap.slider_tick_rate,
        bpm=max_bpm,
        offset=int(round(min(tp.offset for tp in beatmap.timing_points))) if beatmap.timing_points else 0,
        background_line=background_line(beatmap.background),
    )


def calculate_coordinates(last_pos, dist, num_samples, playfield_size):
    """Points at distance ``dist`` from last_pos within the playfield
    (reference: postprocessor.py:86-103)."""
    angles = np.linspace(0, 2 * np.pi, num_samples)
    x = last_pos[0] + dist * np.cos(angles)
    y = last_pos[1] + dist * np.sin(angles)
    coords = [(xi, yi) for xi, yi in zip(x, y) if 0 <= xi <= playfield_size[0] and 0 <= yi <= playfield_size[1]]
    if len(coords) == 0:
        return [playfield_size] if last_pos[0] + last_pos[1] > (playfield_size[0] + playfield_size[1]) / 2 else [(0, 0)]
    return coords


def position_to_progress(slider_path: SliderPath, pos: np.ndarray) -> float:
    """Gradient-descent inverse of position_at (reference: postprocessor.py:106-119)."""
    eps = 1e-4
    lr = 1
    t = 1.0
    for _ in range(100):
        grad = np.linalg.norm(slider_path.position_at(t) - pos) - np.linalg.norm(
            slider_path.position_at(t - eps) - pos
        )
        t -= lr * grad
        if grad == 0 or t < 0 or t > 1:
            break
    return float(np.clip(t, 0, 1))


@dataclasses.dataclass
class Marker:
    time: float
    is_measure: bool
    is_redline: bool
    beats_from_last_marker: float = 1


def _make_tp(offset: float, ms_per_beat: float, meter: int = 4, volume: int = 100, kiai: bool = False,
             uninherited: bool = False) -> TimingPoint:
    return TimingPoint(
        offset=offset, ms_per_beat=ms_per_beat, meter=meter, sample_type=2, sample_index=-1,
        volume=volume, uninherited=uninherited, kiai=kiai, parent=None,
    )


class Renderer:
    """The postprocessor. Named Renderer here; API mirrors the reference."""

    curve_type_shorthand = {"B": "Bezier", "P": "PerfectCurve", "C": "Catmull"}

    def __init__(self, args, logger: Optional[logging.Logger] = None):
        self.offset = args.offset
        self.beat_length = 60000 / args.bpm if args.bpm else 500
        self.timing_leniency = args.timing_leniency
        self.types_first = args.train.data.types_first
        self.has_pos = args.train.data.add_positions
        self.mania_bpm_normalized_scroll_speed = args.train.data.mania_bpm_normalized_scroll_speed
        self.start_time = args.start_time
        self.end_time = args.end_time
        self.has_sv = args.train.data.add_sv
        self.snap_near_perfect_overlaps_enabled = args.snap_near_perfect_overlaps
        self.logger = logging.getLogger(__name__) if logger is None else logger.getChild(__name__)

    # -- main entry -------------------------------------------------------------

    def generate(
        self,
        events: list[Event],
        beatmap_config: BeatmapConfig,
        timing: Optional[list[TimingPoint]] = None,
    ) -> str:
        hit_object_strings: list[str] = []
        spinner_start = None
        slider_head = None
        anchor_info: list[tuple] = []
        last_anchor = None
        hold_note_start = None
        drumroll_start = None
        denden_start = None

        if timing is None:
            timing = [_make_tp(self.offset or 0, self.beat_length, uninherited=True)]

        groups, _ = get_groups(events, types_first=self.types_first)
        last_x, last_y = 256, 192

        if self.snap_near_perfect_overlaps_enabled:
            self.snap_near_perfect_overlaps(groups)

        last_time = max((g.time for g in groups), default=0)
        median_mpb = get_median_mpb(timing, last_time)

        for group in groups:
            hit_type = group.event_type

            if group.distance is not None and group.x is None and group.y is None:
                coords = calculate_coordinates((last_x, last_y), group.distance, 500, (512, 384))
                group.x, group.y = coords[np.random.randint(len(coords))]

            if group.x is None or group.y is None:
                group.x, group.y = last_x, last_y

            if hit_type in (
                EventType.CIRCLE, EventType.SLIDER_HEAD, EventType.BEZIER_ANCHOR, EventType.PERFECT_ANCHOR,
                EventType.CATMULL_ANCHOR, EventType.RED_ANCHOR, EventType.LAST_ANCHOR, EventType.SLIDER_END,
            ):
                last_x, last_y = group.x, group.y

            if beatmap_config.mode == 1:
                group.x, group.y = 256, 192
            if beatmap_config.mode == 3:
                group.y = 192

            if hit_type == EventType.CIRCLE:
                hitsound = group.hitsounds[0] if group.hitsounds else 0
                sampleset = group.samplesets[0] if group.samplesets else 0
                addition = group.additions[0] if group.additions else 0
                volume = group.volumes[0] if group.volumes and beatmap_config.mode == 3 else 0
                hit_object_strings.append(
                    f"{int(round(group.x))},{int(round(group.y))},{int(round(group.time))},"
                    f"{5 if group.new_combo else 1},{hitsound},{sampleset}:{addition}:-1:{volume}:"
                )
                if group.volumes and beatmap_config.mode != 3:
                    timing = self.set_volume(int(round(group.time)), group.volumes[0], timing)
                if beatmap_config.mode == 1 and group.scroll_speed is not None:
                    timing = self.set_sv(int(round(group.time)), group.scroll_speed, timing)

            elif hit_type == EventType.HOLD_NOTE:
                if hold_note_start is not None:
                    self.logger.warning(f"Warning: Incomplete hold note at {int(round(hold_note_start.time))}")
                hold_note_start = group

            elif hit_type == EventType.HOLD_NOTE_END and hold_note_start is not None:
                hitsound = hold_note_start.hitsounds[0] if hold_note_start.hitsounds else 0
                sampleset = hold_note_start.samplesets[0] if hold_note_start.samplesets else 0
                addition = hold_note_start.additions[0] if hold_note_start.additions else 0
                volume = hold_note_start.volumes[0] if hold_note_start.volumes and beatmap_config.mode == 3 else 0
                hit_object_strings.append(
                    f"{int(round(hold_note_start.x))},192,{int(round(hold_note_start.time))},128,{hitsound},"
                    f"{int(round(group.time))}:{sampleset}:{addition}:-1:{volume}:"
                )
                if hold_note_start.volumes and beatmap_config.mode != 3:
                    timing = self.set_volume(int(round(hold_note_start.time)), hold_note_start.volumes[0], timing)
                hold_note_start = None

            elif hit_type == EventType.DRUMROLL:
                if drumroll_start is not None:
                    self.logger.warning(f"Warning: Incomplete drumroll at {int(round(drumroll_start.time))}")
                drumroll_start = group

            elif hit_type == EventType.DRUMROLL_END and drumroll_start is not None:
                drumroll_start_time = int(round(drumroll_start.time))
                duration = int(round(group.time)) - drumroll_start_time
                if duration < 1:
                    drumroll_start = None
                    continue
                hitsound = drumroll_start.hitsounds[0] if drumroll_start.hitsounds else 0
                sampleset = drumroll_start.samplesets[0] if drumroll_start.samplesets else 0
                addition = drumroll_start.additions[0] if drumroll_start.additions else 0
                if drumroll_start.volumes:
                    timing = self.set_volume(int(round(drumroll_start.time)), drumroll_start.volumes[0], timing)
                if beatmap_config.mode == 1 and drumroll_start.scroll_speed is not None:
                    timing = self.set_sv(int(round(drumroll_start.time)), drumroll_start.scroll_speed, timing)

                tp = self.timing_point_at(drumroll_start_time, timing)
                redline = tp if tp.parent is None else tp.parent
                sv = 1 if tp.parent is None else -100 / tp.ms_per_beat
                length = sv * duration * 100 / redline.ms_per_beat * beatmap_config.slider_multiplier

                start_pos, *zigzag = self.get_control_points_for_length(length)
                control_points = "|".join(f"{cp[0]}:{cp[1]}" for cp in zigzag)
                hit_object_strings.append(
                    f"{start_pos[0]},{start_pos[1]},{drumroll_start_time},2,{hitsound},L|{control_points},1,"
                    f"{length},0|0,0:0|0:0,{sampleset}:{addition}:-1:0:"
                )
                drumroll_start = None

            elif hit_type == EventType.DENDEN:
                if denden_start is not None:
                    self.logger.warning(f"Warning: Incomplete denden at {int(round(denden_start.time))}")
                denden_start = group

            elif hit_type == EventType.DENDEN_END and denden_start is not None:
                hitsound = denden_start.hitsounds[0] if denden_start.hitsounds else 0
                sampleset = denden_start.samplesets[0] if denden_start.samplesets else 0
                addition = denden_start.additions[0] if denden_start.additions else 0
                hit_object_strings.append(
                    f"256,192,{int(round(denden_start.time))},12,{hitsound},{int(round(group.time))},"
                    f"{sampleset}:{addition}:-1:0:"
                )
                if denden_start.volumes:
                    timing = self.set_volume(int(round(denden_start.time)), denden_start.volumes[0], timing)
                if beatmap_config.mode == 1 and denden_start.scroll_speed is not None:
                    timing = self.set_sv(int(round(denden_start.time)), denden_start.scroll_speed, timing)
                denden_start = None

            elif hit_type == EventType.SPINNER:
                if spinner_start is not None:
                    self.logger.warning(f"Warning: Incomplete spinner at {int(round(spinner_start.time))}")
                spinner_start = group

            elif hit_type == EventType.SPINNER_END and spinner_start is not None:
                hitsound = group.hitsounds[0] if group.hitsounds else 0
                sampleset = group.samplesets[0] if group.samplesets else 0
                addition = group.additions[0] if group.additions else 0
                hit_object_strings.append(
                    f"256,192,{int(round(spinner_start.time))},12,{hitsound},{int(round(group.time))},"
                    f"{sampleset}:{addition}:-1:0:"
                )
                if group.volumes:
                    timing = self.set_volume(int(round(group.time)), group.volumes[0], timing)
                spinner_start = None
                last_x, last_y = 256, 192

            elif hit_type == EventType.SLIDER_HEAD:
                if slider_head is not None:
                    self.logger.warning(f"Warning: Incomplete slider at {int(round(slider_head.time))}")
                slider_head = group
                last_anchor = None
                anchor_info = []

            elif hit_type == EventType.BEZIER_ANCHOR:
                anchor_info.append(("B", group.x, group.y))
            elif hit_type == EventType.PERFECT_ANCHOR:
                anchor_info.append(("P", group.x, group.y))
            elif hit_type == EventType.CATMULL_ANCHOR:
                anchor_info.append(("C", group.x, group.y))
            elif hit_type == EventType.RED_ANCHOR:
                anchor_info.append(("B", group.x, group.y))
                anchor_info.append(("B", group.x, group.y))
            elif hit_type == EventType.LAST_ANCHOR:
                if last_anchor is None:  # first = position; last = time + hitsounds
                    anchor_info.append(("B", group.x, group.y))
                last_anchor = group

            elif hit_type == EventType.SLIDER_END and slider_head is not None and last_anchor is not None:
                result = self._render_slider(
                    group, slider_head, last_anchor, anchor_info, timing, beatmap_config
                )
                if result == "keep":
                    # near-zero required length: drop this end but keep the
                    # open slider state (reference: postprocessor.py:374-375)
                    continue
                if result is not None:
                    hit_string, timing = result
                    if hit_string:
                        hit_object_strings.append(hit_string)
                slider_head = None
                last_anchor = None
                anchor_info = []

            elif hit_type == EventType.KIAI:
                timing = self.set_kiai(group.time, bool(group.value), timing)

            elif hit_type == EventType.SCROLL_SPEED_CHANGE and group.scroll_speed is not None:
                if self.mania_bpm_normalized_scroll_speed:
                    timing = self.set_normalized_scroll_speed(group.time, group.scroll_speed, timing, median_mpb)
                else:
                    timing = self.set_sv(group.time, group.scroll_speed, timing)

        # Remove greenlines before the first redline
        if len(timing) > 0:
            first_red = next(tp for tp in timing if tp.parent is None)
            timing = [tp for tp in timing if tp.offset >= first_red.offset]

        template = Template(OSU_TEMPLATE)
        cfg_dict = dataclasses.asdict(beatmap_config)
        return template.safe_substitute(
            {
                **cfg_dict,
                "hit_objects": "\n".join(hit_object_strings),
                "timing_points": "\n".join(serialize_timing_point(tp) for tp in timing),
            }
        )

    def _render_slider(self, group, slider_head, last_anchor, anchor_info, timing, beatmap_config):
        """Slider reconstruction (reference: postprocessor.py:344-428)."""
        slider_start_time = int(round(slider_head.time))
        curve_type = anchor_info[0][0]
        span_duration = last_anchor.time - slider_head.time
        total_duration = group.time - slider_head.time

        if total_duration <= 0 or span_duration <= 0:
            self.logger.warning(f"Warning: Invalid slider duration at {slider_start_time}")
            return None

        slides = max(int(round(total_duration / span_duration)), 1)
        span_duration = total_duration / slides
        slider_path = SliderPath(
            self.curve_type_shorthand[curve_type],
            np.array([(slider_head.x, slider_head.y)] + [(cp[1], cp[2]) for cp in anchor_info], dtype=float),
        )
        max_length = slider_path.get_distance()

        tp = self.timing_point_at(slider_start_time, timing)
        redline = tp if tp.parent is None else tp.parent
        last_sv = 1 if tp.parent is None else -100 / tp.ms_per_beat

        if not self.has_sv or slider_head.scroll_speed is None:
            if self.has_pos:
                req_length = max_length * position_to_progress(slider_path, np.array((group.x, group.y)))
            else:
                req_length = max_length - np.linalg.norm(
                    np.array((group.x, group.y)) - np.array((last_anchor.x, last_anchor.y))
                )
            if req_length < 1e-4:
                return "keep"
            sv, length = self.get_human_sv_and_length(
                req_length, max_length, span_duration, last_sv, redline,
                slider_head.new_combo, beatmap_config.slider_multiplier,
            )
        else:
            sv = slider_head.scroll_speed
            length = self.calc_length(sv, span_duration, redline, beatmap_config.slider_multiplier)

        # Reduce sv if way too long
        if length > max_length * 1.5:
            sv = max_length / 100 / span_duration * redline.ms_per_beat / beatmap_config.slider_multiplier
            sv = round(sv * 20) / 20
            length = self.calc_length(sv, span_duration, redline, beatmap_config.slider_multiplier)

        # Scale control points to fit if adjusted length overshoots
        if length > max_length + 1e-4:
            scale = length / max_length
            anchor_info = [
                (cp[0], (cp[1] - slider_head.x) * scale + slider_head.x, (cp[2] - slider_head.y) * scale + slider_head.y)
                for cp in anchor_info
            ]

        if sv != last_sv:
            timing = self.set_sv(slider_start_time, sv, timing)

        node_hitsounds = slider_head.hitsounds + last_anchor.hitsounds[1:] + group.hitsounds
        node_samplesets = slider_head.samplesets + last_anchor.samplesets[1:] + group.samplesets
        node_additions = slider_head.additions + last_anchor.additions[1:] + group.additions
        node_volumes = slider_head.volumes + last_anchor.volumes[1:] + group.volumes

        body_hitsound = last_anchor.hitsounds[0] if last_anchor.hitsounds else 0
        body_sampleset = last_anchor.samplesets[0] if last_anchor.samplesets else 0
        body_addition = last_anchor.additions[0] if last_anchor.additions else 0

        control_points = "|".join(f"{int(round(cp[1]))}:{int(round(cp[2]))}" for cp in anchor_info)
        node_hitsounds_s = "|".join(map(str, node_hitsounds))
        node_sampleset_s = "|".join(f"{s}:{a}" for s, a in zip(node_samplesets, node_additions))

        hit_string = (
            f"{int(round(slider_head.x))},{int(round(slider_head.y))},{slider_start_time},"
            f"{6 if slider_head.new_combo else 2},{body_hitsound},{curve_type}|{control_points},{slides},{length},"
            f"{node_hitsounds_s},{node_sampleset_s},{body_sampleset}:{body_addition}:-1:0:"
        )

        # per-node volumes
        for i in range(min(slides + 1, len(node_volumes))):
            t = int(round(slider_head.time + span_duration * i))
            node_volume = node_volumes[i]
            timing = self.set_volume(t, node_volume, timing)
            if last_anchor.volumes and last_anchor.volumes[0] != node_volume and i < slides and span_duration > 6:
                timing = self.set_volume(t + 6, last_anchor.volumes[0], timing)

        return hit_string, timing

    # -- file output ---------------------------------------------------------------

    def add_to_beatmap(self, result: str, beatmap_path: str) -> str:
        """Merge generated content into an existing beatmap between
        start_time/end_time (reference: postprocessor.py:456-506)."""
        result_beatmap = Beatmap.from_string(result)
        beatmap = Beatmap.from_path(beatmap_path)

        start_time = self.start_time if self.start_time is not None else -86400000.0
        end_time = self.end_time if self.end_time is not None else 86400000.0

        beatmap._hit_objects = [h for h in beatmap._hit_objects if h.time < start_time or h.time > end_time]
        beatmap.timing_points = [tp for tp in beatmap.timing_points if tp.offset < start_time or tp.offset > end_time]

        beatmap._hit_objects.extend(h for h in result_beatmap._hit_objects if start_time <= h.time <= end_time)
        beatmap.timing_points.extend(
            tp for tp in result_beatmap.timing_points if start_time <= tp.offset <= end_time
        )
        beatmap._hit_objects.sort(key=lambda h: h.time)
        beatmap.timing_points.sort(key=lambda tp: tp.offset)

        if result_beatmap.timing_points and beatmap.timing_points:
            result_tp = result_beatmap.timing_point_at(start_time)
            beatmap_tp = beatmap.timing_point_at(start_time)

            result_sv = result_tp.ms_per_beat if result_tp.parent is not None else -100
            tp = _make_tp(result_tp.offset, result_sv, volume=result_tp.volume, kiai=result_tp.kiai)
            beatmap.timing_points = TimingPointsChange(tp, mpb=True, volume=True, kiai=True).add_change(
                beatmap.timing_points, False
            )

            result_red = result_tp if result_tp.parent is None else result_tp.parent
            beatmap_red = beatmap_tp if beatmap_tp.parent is None else beatmap_tp.parent
            result_counter = ((start_time - result_red.offset) / result_red.ms_per_beat + 1e-4) % result_red.meter
            beatmap_counter = ((start_time - beatmap_red.offset) / beatmap_red.ms_per_beat + 1e-4) % beatmap_red.meter
            if (
                result_red.meter != beatmap_red.meter
                or abs(result_counter - beatmap_counter) > 1e-4
                or abs(result_red.ms_per_beat - beatmap_red.ms_per_beat) > 1e-4
            ):
                offset = start_time - result_counter * result_red.ms_per_beat
                tp = _make_tp(offset, result_red.ms_per_beat, meter=result_red.meter, uninherited=True)
                beatmap.timing_points = TimingPointsChange(tp, mpb=True, meter=True, uninherited=True).add_change(
                    beatmap.timing_points, False
                )

        beatmap._link_timing_points()
        return beatmap.to_string()

    @staticmethod
    def write_result(output_path: str, result: str) -> None:
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        with open(output_path, "w", encoding="utf-8-sig") as f:
            f.write(result)

    @staticmethod
    def export_osz(output_path: str, osu_content: str, osu_filename: str, audio_path: str, background_path=None) -> None:
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
        with zipfile.ZipFile(output_path, "w") as zipf:
            zipf.writestr(osu_filename, osu_content)
            zipf.write(audio_path, os.path.basename(audio_path))
            if background_path and os.path.exists(background_path):
                zipf.write(background_path, os.path.basename(background_path))

    # -- greenline writers --------------------------------------------------------------

    @staticmethod
    def set_volume(time: float, volume: int, timing: list[TimingPoint]) -> list[TimingPoint]:
        tp = _make_tp(time, -100, volume=volume)
        return TimingPointsChange(tp, volume=True, index=True).add_change(timing, True)

    @staticmethod
    def set_sv(time: float, sv: float, timing: list[TimingPoint]) -> list[TimingPoint]:
        if sv == 0:
            return timing
        tp = _make_tp(time, -100 / sv + 1e-10)
        return TimingPointsChange(tp, mpb=True).add_change(timing, True)

    def set_normalized_scroll_speed(self, time, normalized_scroll_speed, timing, median_mpb):
        def apply_norm(td, redline, t):
            return self.set_sv(td, normalized_scroll_speed * redline.ms_per_beat / median_mpb, t)

        tp = self.timing_point_at(time, timing)
        redline = tp if tp.parent is None else tp.parent
        timing = apply_norm(time, redline, timing)
        for tp in timing:
            if tp.offset > time and tp.parent is None:
                timing = apply_norm(tp.offset, tp, timing)
        return timing

    @staticmethod
    def set_kiai(time: float, kiai: bool, timing: list[TimingPoint]) -> list[TimingPoint]:
        tp = _make_tp(time, -100, kiai=kiai)
        return TimingPointsChange(tp, kiai=True).add_change(timing, True)

    @staticmethod
    def get_control_points_for_length(length: float) -> list[tuple[int, int]]:
        control_points = [(0, 192)]
        y = 192
        for i in range(int(np.ceil(length / 512))):
            x = 512 if i % 2 == 0 else 0
            control_points.append((x, y))
        return control_points

    def get_human_sv_and_length(self, req_length, length, span_duration, last_sv, redline, new_combo, slider_multiplier):
        sv = req_length / 100 / span_duration * redline.ms_per_beat / slider_multiplier
        leniency = 0.05 if new_combo else 0.15
        if abs(sv - last_sv) / last_sv <= leniency:
            sv = last_sv
        else:
            rounded_sv = round(sv * 20) / 20
            if rounded_sv < 0.1:
                rounded_sv = round(sv * 100) / 100
            sv = rounded_sv if rounded_sv > 1e-5 else sv
        return sv, self.calc_length(sv, span_duration, redline, slider_multiplier)

    @staticmethod
    def calc_length(sv, span_duration, redline, slider_multiplier):
        return sv * span_duration * 100 / redline.ms_per_beat * slider_multiplier

    # -- resnapping -------------------------------------------------------------------

    def resnap_events(self, events: list[Event], timing: list[TimingPoint]) -> list[Event]:
        timing = sort_timing_points(timing)
        out = []
        for i, event in enumerate(events):
            if event.type != EventType.TIME_SHIFT:
                out.append(event)
                continue
            time = event.value
            snap_divisor = 0
            if i + 1 < len(events) and events[i + 1].type == EventType.SNAPPING:
                snap_divisor = events[i + 1].value
            if snap_divisor > 0:
                time = int(self.resnap(time, timing, snap_divisor))
            out.append(Event(EventType.TIME_SHIFT, time))
        return out

    def resnap(self, time: float, timing: list[TimingPoint], snap_divisor: int) -> float:
        ignore_ticks = {
            1: [], 4: [2], 6: [2, 3], 8: [4], 9: [3], 10: [2, 5],
            12: [4, 6], 14: [2, 7], 15: [3, 5], 16: [8],
        }
        if len(timing) == 0:
            return time

        current_tp = self.timing_point_at(time, timing)
        current_tp = current_tp if current_tp.parent is None else current_tp.parent
        current_tp_time = round(current_tp.offset)
        before_tp = self.timing_point_at(current_tp_time - 1, timing)
        after_tp = self.uninherited_timing_point_after(time, timing)
        after_tp_time = round(after_tp.offset) if after_tp is not None else np.inf

        current_interval = (current_tp_time, after_tp_time)

        def local_ticks(tp: TimingPoint, divisor: int) -> set:
            tp_time = round(tp.offset)
            ms_per_tick = tp.ms_per_beat / divisor
            remainder = (time - tp_time) % ms_per_tick
            return {
                int(time - remainder - ms_per_tick),
                int(time - remainder),
                int(time - remainder + ms_per_tick),
                int(time - remainder + 2 * ms_per_tick),
            }

        def local_ticks_minus_ignored(tp: TimingPoint, divisor: int) -> set:
            ticks = local_ticks(tp, divisor)
            for ignore_divisor in ignore_ticks.get(divisor, [1]):
                ticks -= local_ticks(tp, ignore_divisor)
            return ticks

        ticks = local_ticks_minus_ignored(current_tp, snap_divisor)
        m = 20
        ticks = {t for t in ticks if current_interval[0] - m <= t <= current_interval[1] + m}
        if before_tp is not None:
            ticks.update(
                t for t in local_ticks_minus_ignored(before_tp, snap_divisor) if t <= current_interval[0] + m
            )
        if after_tp is not None:
            ticks.update(
                t for t in local_ticks_minus_ignored(after_tp, snap_divisor) if t >= current_interval[1] - m
            )
        if len(ticks) == 0:
            return time
        return min(ticks, key=lambda x: abs(x - time))

    @staticmethod
    def timing_point_at(time: float, timing_points: list[TimingPoint]) -> TimingPoint:
        for tp in reversed(timing_points):
            if tp.offset <= time:
                return tp
        return timing_points[0]

    @staticmethod
    def uninherited_timing_point_after(time: float, timing_points: list[TimingPoint]) -> Optional[TimingPoint]:
        for tp in timing_points:
            if tp.offset > time and tp.parent is None:
                return tp
        return None

    # -- timing inference from beat markers ------------------------------------------------

    def generate_timing(self, events: list[Event]) -> list[TimingPoint]:
        """Marker stream -> redlines with mpb estimation, human BPM rounding,
        split-search, and meter repair (reference: postprocessor.py:716-895)."""
        markers: list[Marker] = []
        step = 1 if self.types_first else -1
        for i, event in enumerate(events):
            if event.type in BEAT_TYPES and 0 <= i + step < len(events) and events[i + step].type == EventType.TIME_SHIFT:
                markers.append(
                    Marker(
                        int(events[i + step].value),
                        event.type == EventType.MEASURE,
                        event.type == EventType.TIMING_POINT,
                        0 if event.type == EventType.TIMING_POINT else 1,
                    )
                )

        if len(markers) == 0:
            return []
        markers.sort(key=lambda x: x.time)

        timing: list[TimingPoint] = []
        for marker in markers:
            if not marker.is_redline:
                continue
            tp = _make_tp(marker.time, 1000, uninherited=True)
            timing = TimingPointsChange(tp, uninherited=True).add_change(timing, True)

        if len(timing) == 0:
            timing = [_make_tp(markers[0].time, 1000, uninherited=True)]

        counter = 0
        last_measure_time = markers[0].time

        # meter repair pass
        for marker in markers:
            time = marker.time
            if marker.is_redline:
                counter = 0
                last_measure_time = time
                continue
            redline = self.timing_point_at(time - 1, timing)
            redline = redline if redline.parent is None else redline.parent
            redline_offset = round(redline.offset)
            if redline_offset == time:
                continue
            counter += 1
            if not marker.is_measure:
                continue
            if redline.meter != counter:
                if last_measure_time <= redline_offset:
                    redline.meter = counter
                else:
                    tp = _make_tp(last_measure_time, 1000, meter=counter, uninherited=True)
                    timing = TimingPointsChange(tp, meter=True, uninherited=True).add_change(timing, True)
            counter = 0
            last_measure_time = time

        counter = 0
        last_mpb = 1000.0

        # BPM estimation pass
        for marker in markers:
            time = marker.time
            redline = self.timing_point_at(time - 1, timing)
            redline = redline if redline.parent is None else redline.parent
            redline_offset = round(redline.offset)
            beats_from_last_marker = marker.beats_from_last_marker

            if redline_offset == time:
                counter = 0
                continue

            markers_before = [o for o in markers if redline_offset + 1 <= o.time < time] + [marker]

            if beats_from_last_marker == 0:
                if len(markers_before) != 1:
                    counter = 0
                    continue
                beats_from_last_marker = (time - redline_offset) / last_mpb
                rounded_beats = [round(beats_from_last_marker), 1, 1 / 2, 1 / 4, 1 / 8, 1 / 16]
                beats_from_last_marker = min(rounded_beats, key=lambda x: abs(x - beats_from_last_marker))
                marker.beats_from_last_marker = beats_from_last_marker

            def get_mpb(m, offset):
                beats_from_redline = sum(mb.beats_from_last_marker for mb in m)
                return self.get_ms_per_beat(m[-1].time - offset, beats_from_redline, 0)

            mpb = get_mpb(markers_before, redline_offset)
            can_change_redline = self.check_ms_per_beat(mpb, markers_before, redline)

            if can_change_redline:
                mpb = self.human_round_ms_per_beat(mpb, markers_before, redline)
                redline.ms_per_beat = mpb
            elif len(markers_before) > 1:
                def test_split(m, o):
                    mpb_s = get_mpb(m, o)
                    loss = 0.0
                    beats = 0.0
                    for mb in m:
                        beats += mb.beats_from_last_marker
                        loss += (mb.time - (o + beats * mpb_s)) ** 2
                    return loss / len(m)

                best_loss = np.inf
                best_split = len(markers_before) - 1
                for i in range(1, len(markers_before)):
                    split = markers_before[i - 1]
                    if not split.is_measure and i != len(markers_before) - 1:
                        continue
                    loss = test_split(markers_before[:i], redline_offset) + test_split(markers_before[i:], split.time)
                    if loss < best_loss:
                        best_loss = loss
                        best_split = i

                if best_split < len(markers_before) - 1:
                    mpb = get_mpb(markers_before[:best_split], redline_offset)
                    mpb = self.human_round_ms_per_beat(mpb, markers_before[:best_split], redline)
                    redline.ms_per_beat = mpb

                last_time = markers_before[best_split - 1].time
                beats_from_split = sum(mb.beats_from_last_marker for mb in markers_before[best_split:])
                mpb = self.get_ms_per_beat(time - last_time, beats_from_split, self.timing_leniency)
                tp = _make_tp(last_time, mpb, uninherited=True)
                timing = TimingPointsChange(tp, mpb=True, uninherited=True).add_change(timing, True)
                counter = 0
                for i in range(len(markers_before) - 2, best_split - 1, -1):
                    if markers_before[i].is_measure:
                        break
                    counter += 1

            last_mpb = mpb
            counter += 1

            redline = self.timing_point_at(time, timing)
            redline = redline if redline.parent is None else redline.parent
            redline_offset = round(redline.offset)
            if redline_offset == time:
                counter = 0

            if marker.is_measure:
                if counter % redline.meter != 0:
                    tp = _make_tp(time, redline.ms_per_beat, meter=redline.meter, uninherited=True)
                    timing = TimingPointsChange(tp, mpb=True, uninherited=True).add_change(timing, True)
                counter = 0

        return timing

    def check_ms_per_beat(self, mpb_new: float, markers: list[Marker], redline: TimingPoint) -> bool:
        redline_offset = round(redline.offset)
        beats_from_redline = 0.0
        for mb in markers:
            beats_from_redline += mb.beats_from_last_marker
            resnapped = redline_offset + mpb_new * beats_from_redline
            if not self.is_snapped(mb.time, resnapped, self.timing_leniency):
                return False
        return True

    def human_round_ms_per_beat(self, mpb: float, markers: list[Marker], redline: TimingPoint) -> float:
        if mpb == 0 or mpb > 60000:
            return mpb
        bpm = 60000 / mpb
        for mult in (1, 2, 10, 100, 1000):
            candidate = 60000 / (round(bpm * mult) / mult)
            if self.check_ms_per_beat(candidate, markers, redline):
                return candidate
        return mpb

    def get_ms_per_beat(self, time_from_redline: float, beats_from_redline: float, leniency: float) -> float:
        if beats_from_redline == 0 or time_from_redline == 0:
            return 1000
        mpb = time_from_redline / beats_from_redline
        bpm = 60000 / mpb
        if bpm < 1:
            return 1000
        for mult in (1, 2, 10, 100, 1000):
            candidate = 60000 / (round(bpm * mult) / mult)
            if self.is_snapped(time_from_redline, candidate * beats_from_redline, leniency):
                return candidate
        return mpb

    @staticmethod
    def is_snapped(time: float, resnapped_time: float, leniency: float) -> bool:
        return abs(time - resnapped_time) <= leniency

    # -- overlap snapping ---------------------------------------------------------------

    @staticmethod
    def snap_near_perfect_overlaps(groups: list[Group]) -> None:
        snappable = {
            EventType.CIRCLE, EventType.SLIDER_HEAD, EventType.RED_ANCHOR,
            EventType.LAST_ANCHOR, EventType.SLIDER_END,
        }
        space_leniency = 3.8
        time_leniency = 1000
        prev_groups: list[Group] = []
        for group in groups:
            if group.event_type not in snappable or group.x is None or group.y is None:
                continue
            prev_groups = [p for p in prev_groups if abs(group.time - p.time) <= time_leniency]
            for p in prev_groups:
                if np.hypot(group.x - p.x, group.y - p.y) < space_leniency:
                    group.x = p.x
                    group.y = p.y
                    break
            prev_groups.append(group)


# Backwards-friendly alias matching the reference's class name
Postprocessor = Renderer
