"""Beatmap -> event-stream parser.

Converts a parsed :class:`~mapperatorinator_tpu.osu.beatmap.Beatmap` into the
discrete event language, producing byte-identical event streams to the
reference (reference: ``osuT5/osuT5/dataset/osu_parser.py:17-772``): per-hit-
object groups with time/snapping/position/hitsound/new-combo events, both
slider encodings (v1 anchors timed along the span, v2 untimed + LAST_ANCHOR),
taiko drumrolls/dendens, mania hold notes and columns, sustain markers, kiai
and BPM-normalized scroll-speed streams, and beat/measure/timing-point grids.
Times are float milliseconds end to end (no timedelta round-trips).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .beatmap import Beatmap, Circle, HitObject, HoldNote, Slider, Spinner, TimingPoint
from .events import Event, EventType
from .streams import get_median_mpb_beatmap, merge_events, speed_events
from .vocab import Vocabulary

PLAYFIELD_CENTER = np.array((256, 192))


class BeatmapParser:
    """Config-driven beatmap -> events converter."""

    def __init__(self, args, vocab: Vocabulary) -> None:
        data = args.data
        self.types_first = data.types_first
        self.add_timing = data.add_timing
        self.add_snapping = data.add_snapping
        self.add_timing_points = data.add_timing_points
        self.add_hitsounds = data.add_hitsounds
        self.add_distances = data.add_distances
        self.add_positions = data.add_positions
        self.add_kiai = data.add_kiai
        self.add_sv = data.add_sv
        self.add_mania_sv = data.add_mania_sv
        self.mania_bpm_normalized_scroll_speed = data.mania_bpm_normalized_scroll_speed
        self.position_precision = data.position_precision
        self.position_split_axes = data.position_split_axes
        self.position_refinement = data.position_refinement
        self.x_min, self.x_max, self.y_min, self.y_max = data.position_range
        if self.add_distances:
            dist_range = vocab.event_range[EventType.DISTANCE]
            self.dist_min = dist_range.min_value
            self.dist_max = dist_range.max_value
        self.slider_version = data.slider_version
        self.sustain_interval = data.sustain_interval

    # -- top level ------------------------------------------------------------

    def parse(
        self,
        beatmap: Beatmap,
        speed: float = 1.0,
        song_length: Optional[float] = None,
        flip: tuple[bool, bool] = (False, False),
    ) -> tuple[list[Event], list[int]]:
        events: list[Event] = []
        event_times: list[int] = []
        last_pos = np.array((256, 192))

        for obj in beatmap.hit_objects(stacking=False):
            if isinstance(obj, Circle):
                last_pos = self._parse_circle(obj, events, event_times, last_pos, beatmap, flip)
            elif isinstance(obj, Slider):
                if beatmap.mode == 1:
                    self._parse_drumroll(obj, events, event_times, beatmap)
                else:
                    last_pos = self._parse_slider(obj, events, event_times, last_pos, beatmap, flip)
            elif isinstance(obj, Spinner):
                if beatmap.mode == 1:
                    self._parse_denden(obj, events, event_times, beatmap)
                else:
                    last_pos = self._parse_spinner(obj, events, event_times, beatmap)
            elif isinstance(obj, HoldNote):
                last_pos = self._parse_hold_note(obj, events, event_times, beatmap, flip)

        if len(events) > 0:
            pairs = sorted(zip(events, event_times), key=lambda x: x[1])
            events, event_times = [list(x) for x in zip(*pairs)]
        result = (list(events), list(event_times))

        if self.add_mania_sv and beatmap.mode == 3:
            result = merge_events(self.parse_scroll_speeds(beatmap), result)
        if self.add_kiai:
            result = merge_events(self.parse_kiai(beatmap), result)
        if self.add_timing:
            result = merge_events(self.parse_timing(beatmap, song_length=song_length), result)
        if speed != 1.0:
            result = speed_events(result, speed)
        return result

    def parse_scroll_speeds(self, beatmap: Beatmap, speed: float = 1.0) -> tuple[list[Event], list[int]]:
        normalized = self.mania_bpm_normalized_scroll_speed
        events: list[Event] = []
        event_times: list[int] = []
        median_mpb = get_median_mpb_beatmap(beatmap)
        mpb = median_mpb
        last_scroll = -1.0

        tps = beatmap.timing_points
        for i, tp in enumerate(tps):
            if tp.parent is None:
                mpb = tp.ms_per_beat
                scroll_speed = 1.0
            else:
                scroll_speed = -100 / tp.ms_per_beat
            if i == len(tps) - 1 or tps[i + 1].offset > tp.offset:
                norm_scroll = scroll_speed * median_mpb / mpb if normalized else scroll_speed
                if abs(norm_scroll - last_scroll) > 1e-3 or last_scroll == -1:
                    self._emit_group(
                        EventType.SCROLL_SPEED_CHANGE,
                        tp.offset,
                        events,
                        event_times,
                        beatmap,
                        time_event=True,
                        scroll_speed=norm_scroll,
                    )
                last_scroll = norm_scroll

        if speed != 1.0:
            events, event_times = speed_events((events, event_times), speed)
        return events, event_times

    def parse_kiai(self, beatmap: Beatmap, speed: float = 1.0) -> tuple[list[Event], list[int]]:
        events: list[Event] = []
        event_times: list[int] = []
        kiai = False
        for tp in beatmap.timing_points:
            if tp.kiai == kiai:
                continue
            self._emit_group(
                Event(EventType.KIAI, int(tp.kiai)),
                tp.offset,
                events,
                event_times,
                beatmap,
                time_event=True,
            )
            kiai = tp.kiai
        if speed != 1.0:
            events, event_times = speed_events((events, event_times), speed)
        return events, event_times

    def parse_timing(
        self,
        beatmap,
        speed: float = 1.0,
        song_length: Optional[float] = None,
    ) -> tuple[list[Event], list[int]]:
        """Beat/measure/timing-point grid from redlines to the map end."""
        timing = beatmap.timing_points if isinstance(beatmap, Beatmap) else beatmap
        assert len(timing) > 0, "No timing points found in beatmap."

        events: list[Event] = []
        event_times: list[int] = []
        if isinstance(beatmap, Beatmap) and len(beatmap.hit_objects(stacking=False)) > 0:
            last_ho = beatmap.hit_objects(stacking=False)[-1]
            last_time = last_ho.end_time + 0.999
        elif song_length is not None:
            last_time = song_length
        else:
            last_time = timing[-1].offset + 10

        redlines = [tp for tp in timing if tp.bpm]
        for i, tp in enumerate(redlines):
            next_tp = redlines[i + 1] if i + 1 < len(redlines) else None
            next_time = next_tp.offset - 10 if next_tp else last_time
            start_time = tp.offset
            time = start_time
            measure_counter = 0
            beat_delta = tp.ms_per_beat
            while time <= next_time:
                if self.add_timing_points and measure_counter == 0:
                    event_type = EventType.TIMING_POINT
                elif measure_counter % tp.meter == 0:
                    event_type = EventType.MEASURE
                else:
                    event_type = EventType.BEAT
                self._emit_group(
                    event_type,
                    time,
                    events,
                    event_times,
                    beatmap if isinstance(beatmap, Beatmap) else None,
                    time_event=True,
                    add_snap=False,
                )
                measure_counter += 1
                time = int(start_time + measure_counter * beat_delta)

        if speed != 1.0:
            events, event_times = speed_events((events, event_times), speed)
        return events, event_times

    # -- timing point lookups ---------------------------------------------------

    @staticmethod
    def scroll_speed_at(time: float, beatmap: Beatmap) -> float:
        return BeatmapParser.tp_to_scroll_speed(beatmap.timing_point_at(time))

    @staticmethod
    def tp_to_scroll_speed(tp: TimingPoint) -> float:
        if tp is None or tp.parent is None or tp.ms_per_beat >= 0 or np.isnan(tp.ms_per_beat):
            return 1.0
        return float(np.clip(-100 / tp.ms_per_beat, 0.01, 10))

    # -- event emitters -----------------------------------------------------------

    def _emit_time(self, time: float, beatmap, events, event_times, add_snap: bool = True) -> None:
        time_ms = int(time + 1e-5)
        events.append(Event(EventType.TIME_SHIFT, time_ms))
        event_times.append(time_ms)

        if not add_snap or not self.add_snapping:
            return

        tp = beatmap.uninherited_timing_point_at(time)
        beats = (time - tp.offset) / tp.ms_per_beat
        snapping = 0
        for i in range(1, 17):
            if abs(beats - round(beats * i) / i) * tp.ms_per_beat < 2:
                snapping = i
                break
        events.append(Event(EventType.SNAPPING, snapping))
        event_times.append(time_ms)

    def _emit_hitsound(
        self, time: float, group_time: int, hitsound: int, addition: str, beatmap, events, event_times
    ) -> None:
        if not self.add_hitsounds:
            return

        parts = addition.split(":")

        def valid(i: int) -> bool:
            return len(parts) > i and parts[i] and parts[i] != "0"

        tp = beatmap.timing_point_at(time + 5)  # hitsounds inherit 5 ms late
        tp_sample_set = tp.sample_type if tp.sample_type != 0 else 2
        sample_set = int(parts[0]) if valid(0) else tp_sample_set
        addition_set = int(parts[1]) if valid(1) else sample_set
        volume = int(parts[3]) if valid(3) else tp.volume

        sample_set = sample_set if 0 < sample_set < 4 else 1
        addition_set = addition_set if 0 < addition_set < 4 else 1
        hitsound = hitsound & 14  # normal/whistle/finish bits only
        volume = int(np.clip(volume, 0, 100))

        # combined index: hitsound//2 + 8*(ss-1) + 24*(as-1)
        hitsound_idx = hitsound // 2 + 8 * (sample_set - 1) + 24 * (addition_set - 1)
        events.append(Event(EventType.HITSOUND, hitsound_idx))
        events.append(Event(EventType.VOLUME, volume))
        event_times.append(group_time)
        event_times.append(group_time)

    def _emit_position(self, pos: np.ndarray, last_pos: np.ndarray, time: float, events, event_times) -> np.ndarray:
        time_ms = int(time + 1e-5)
        if self.add_distances:
            dist = int(np.clip(np.linalg.norm(pos - last_pos), self.dist_min, self.dist_max))
            events.append(Event(EventType.DISTANCE, dist))
            event_times.append(time_ms)

        if self.add_positions:
            p = pos / self.position_precision
            px = int(np.clip(p[0], self.x_min / self.position_precision, self.x_max / self.position_precision))
            py = int(np.clip(p[1], self.y_min / self.position_precision, self.y_max / self.position_precision))
            if self.position_split_axes:
                events.append(Event(EventType.POS_X, px))
                events.append(Event(EventType.POS_Y, py))
                event_times.append(time_ms)
                event_times.append(time_ms)
            else:
                x_count = (self.x_max - self.x_min) / self.position_precision + 1
                events.append(
                    Event(
                        EventType.POS,
                        int((px - self.x_min / self.position_precision)
                            + (py - self.y_min / self.position_precision) * x_count),
                    )
                )
                event_times.append(time_ms)
                if self.position_refinement:
                    ref_range = self.position_precision // self.position_refinement
                    p_ref = np.clip((pos % self.position_precision) // self.position_refinement, 0, ref_range - 1)
                    events.append(Event(EventType.POS_REFINE, int(p_ref[0] + p_ref[1] * ref_range)))
                    event_times.append(time_ms)

        return pos

    def _emit_mania_column(self, pos: np.ndarray, columns: int, time: float, events, event_times) -> None:
        time_ms = int(time + 1e-5)
        column = int(np.clip(pos[0] / 512 * columns, 0, columns - 1))
        events.append(Event(EventType.MANIA_COLUMN, column))
        event_times.append(time_ms)

    @staticmethod
    def _flip_pos(pos: np.ndarray, flip: tuple[bool, bool]) -> np.ndarray:
        horizontal, vertical = flip
        if not horizontal and not vertical:
            return pos
        pos = np.array(pos, copy=True)
        if horizontal:
            pos[0] = 512 - pos[0]
        if vertical:
            pos[1] = 384 - pos[1]
        return pos

    def _emit_group(
        self,
        event,
        time: Optional[float],
        events: list[Event],
        event_times: list[int],
        beatmap: Optional[Beatmap],
        *,
        time_event: bool = False,
        add_snap: bool = True,
        pos: Optional[np.ndarray] = None,
        last_pos: Optional[np.ndarray] = None,
        new_combo: bool = False,
        hitsound_ref_times: Optional[list[float]] = None,
        hitsounds: Optional[list[int]] = None,
        additions: Optional[list[str]] = None,
        scroll_speed: Optional[float] = None,
        flip: tuple[bool, bool] = (False, False),
    ) -> Optional[np.ndarray]:
        """Emit one hit-object group in the configured token ordering."""
        time_ms = int(time + 1e-5) if time is not None else None
        if isinstance(event, EventType):
            event = Event(event)

        if self.types_first:
            events.append(event)
            event_times.append(time_ms)
        if time_event:
            self._emit_time(time, beatmap, events, event_times, add_snap)
        if pos is not None:
            pos = self._flip_pos(pos, flip)
            if beatmap.mode in (0, 2):
                last_pos = self._emit_position(pos, last_pos, time, events, event_times)
            elif beatmap.mode == 3:
                self._emit_mania_column(pos, int(beatmap.circle_size), time, events, event_times)
        if new_combo and beatmap.mode in (0, 2):
            events.append(Event(EventType.NEW_COMBO))
            event_times.append(time_ms)
        if scroll_speed is not None:
            events.append(Event(EventType.SCROLL_SPEED, round(float(np.clip(scroll_speed, 0.01, 10)) * 100)))
            event_times.append(time_ms)
        if hitsound_ref_times is not None:
            for i, ref_time in enumerate(hitsound_ref_times):
                self._emit_hitsound(ref_time, time_ms, hitsounds[i], additions[i], beatmap, events, event_times)
        if not self.types_first:
            events.append(event)
            event_times.append(time_ms)

        return last_pos

    def _emit_sustains(self, start_time: float, end_time: float, kwargs: dict) -> None:
        if not self.sustain_interval:
            return
        time = start_time + self.sustain_interval
        while time < end_time - 10:
            self._emit_group(time=time, time_event=True, add_snap=False, **kwargs)
            time += self.sustain_interval

    # -- per-object parsers ------------------------------------------------------

    def _parse_circle(self, circle: Circle, events, event_times, last_pos, beatmap, flip) -> np.ndarray:
        return self._emit_group(
            EventType.CIRCLE,
            circle.time,
            events,
            event_times,
            beatmap,
            time_event=True,
            pos=np.array(circle.position),
            last_pos=last_pos,
            new_combo=circle.new_combo,
            hitsound_ref_times=[circle.time],
            hitsounds=[circle.hitsound],
            additions=[circle.addition],
            scroll_speed=self.scroll_speed_at(circle.time, beatmap) if beatmap.mode == 1 else None,
            flip=flip,
        )

    def _parse_slider(self, s: Slider, events, event_times, last_pos, beatmap, flip) -> np.ndarray:
        anchors = s.anchors
        if len(anchors) >= 100:  # ignore degenerate mega-sliders
            return last_pos

        last_pos = self._emit_group(
            EventType.SLIDER_HEAD,
            s.time,
            events,
            event_times,
            beatmap,
            time_event=True,
            pos=np.array(s.position),
            last_pos=last_pos,
            new_combo=s.new_combo,
            hitsound_ref_times=[s.time],
            hitsounds=[s.edge_sounds[0] if len(s.edge_sounds) > 0 else 0],
            additions=[s.edge_additions[0] if len(s.edge_additions) > 0 else "0:0"],
            scroll_speed=self.scroll_speed_at(s.time, beatmap) if self.add_sv else None,
            flip=flip,
        )

        duration = (s.end_time - s.time) / s.repeat
        n = len(anchors)

        def add_anchor(event_type: EventType, i: int, last_pos):
            return self._emit_group(
                event_type,
                s.time + i / (n - 1) * duration if self.slider_version == 1 else s.time,
                events,
                event_times,
                beatmap,
                pos=np.array(anchors[i]),
                last_pos=last_pos,
                flip=flip,
            )

        curve_kind = {"L": "Linear", "C": "Catmull", "P": "PerfectCurve", "B": "Bezier"}[s.curve_type]
        # PerfectCurve with !=3 points degrades to bezier anchors like the client
        if curve_kind == "PerfectCurve" and n != 3:
            curve_kind = "Bezier"
        if curve_kind == "Linear":
            for i in range(1, n - 1):
                last_pos = add_anchor(EventType.RED_ANCHOR, i, last_pos)
        elif curve_kind == "Catmull":
            for i in range(1, n - 1):
                last_pos = add_anchor(EventType.CATMULL_ANCHOR, i, last_pos)
        elif curve_kind == "PerfectCurve":
            for i in range(1, n - 1):
                last_pos = add_anchor(EventType.PERFECT_ANCHOR, i, last_pos)
        else:
            for i in range(1, n - 1):
                if anchors[i] == anchors[i + 1]:
                    last_pos = add_anchor(EventType.RED_ANCHOR, i, last_pos)
                elif anchors[i] != anchors[i - 1]:
                    last_pos = add_anchor(EventType.BEZIER_ANCHOR, i, last_pos)

        if self.slider_version == 2:
            last_pos = self._emit_group(
                EventType.LAST_ANCHOR,
                s.time,
                events,
                event_times,
                beatmap,
                pos=np.array(anchors[-1]),
                last_pos=last_pos,
                flip=flip,
            )
            self._emit_sustains(
                s.time,
                s.time + duration,
                dict(event=EventType.SLIDER_SUSTAIN, events=events, event_times=event_times, beatmap=beatmap),
            )

        # span-end group carries body + repeat-edge hitsounds
        last_pos = self._emit_group(
            EventType.LAST_ANCHOR,
            s.time + duration,
            events,
            event_times,
            beatmap,
            time_event=True,
            pos=np.array(anchors[-1]) if self.slider_version == 1 else None,
            last_pos=last_pos,
            hitsound_ref_times=[s.time + 1] + [s.time + i * duration for i in range(1, s.repeat)],
            hitsounds=[s.hitsound] + [s.edge_sounds[i] if len(s.edge_sounds) > i else 0 for i in range(1, s.repeat)],
            additions=[s.addition] + [s.edge_additions[i] if len(s.edge_additions) > i else "0:0" for i in range(1, s.repeat)],
            flip=flip,
        )

        self._emit_sustains(
            s.time + duration,
            s.end_time,
            dict(event=EventType.SLIDER_REPEAT_SUSTAIN, events=events, event_times=event_times, beatmap=beatmap),
        )

        return self._emit_group(
            EventType.SLIDER_END,
            s.end_time,
            events,
            event_times,
            beatmap,
            time_event=True,
            pos=s.position_at_progress(1),
            last_pos=last_pos,
            hitsound_ref_times=[s.end_time],
            hitsounds=[s.edge_sounds[-1] if len(s.edge_sounds) > 0 else 0],
            additions=[s.edge_additions[-1] if len(s.edge_additions) > 0 else "0:0"],
            flip=flip,
        )

    def _parse_spinner(self, spinner: Spinner, events, event_times, beatmap) -> np.ndarray:
        self._emit_group(EventType.SPINNER, spinner.time, events, event_times, beatmap, time_event=True)
        self._emit_sustains(
            spinner.time,
            spinner.end_time,
            dict(event=EventType.SPINNER_SUSTAIN, events=events, event_times=event_times, beatmap=beatmap),
        )
        self._emit_group(
            EventType.SPINNER_END,
            spinner.end_time,
            events,
            event_times,
            beatmap,
            time_event=True,
            hitsound_ref_times=[spinner.end_time],
            hitsounds=[spinner.hitsound],
            additions=[spinner.addition],
        )
        return np.array((256, 192))

    def _parse_hold_note(self, hold: HoldNote, events, event_times, beatmap, flip) -> np.ndarray:
        pos = np.array(hold.position)
        self._emit_group(
            EventType.HOLD_NOTE,
            hold.time,
            events,
            event_times,
            beatmap,
            time_event=True,
            pos=pos,
            hitsound_ref_times=[hold.time],
            hitsounds=[hold.hitsound],
            additions=[hold.addition],
            flip=flip,
        )
        self._emit_sustains(
            hold.time,
            hold.end_time,
            dict(
                event=EventType.HOLD_NOTE_SUSTAIN,
                events=events,
                event_times=event_times,
                beatmap=beatmap,
                pos=pos,
                flip=flip,
            ),
        )
        self._emit_group(
            EventType.HOLD_NOTE_END, hold.end_time, events, event_times, beatmap, time_event=True, pos=pos, flip=flip
        )
        return pos

    def _parse_drumroll(self, s: Slider, events, event_times, beatmap) -> None:
        self._emit_group(
            EventType.DRUMROLL,
            s.time,
            events,
            event_times,
            beatmap,
            time_event=True,
            hitsound_ref_times=[s.time],
            hitsounds=[s.hitsound],
            additions=[s.addition],
            scroll_speed=self.scroll_speed_at(s.time, beatmap),
        )
        self._emit_sustains(
            s.time,
            s.end_time,
            dict(event=EventType.DRUMROLL_SUSTAIN, events=events, event_times=event_times, beatmap=beatmap),
        )
        self._emit_group(EventType.DRUMROLL_END, s.end_time, events, event_times, beatmap, time_event=True)

    def _parse_denden(self, spinner: Spinner, events, event_times, beatmap) -> None:
        self._emit_group(
            EventType.DENDEN,
            spinner.time,
            events,
            event_times,
            beatmap,
            time_event=True,
            hitsound_ref_times=[spinner.time],
            hitsounds=[spinner.hitsound],
            additions=[spinner.addition],
            scroll_speed=self.scroll_speed_at(spinner.time, beatmap),
        )
        self._emit_sustains(
            spinner.time,
            spinner.end_time,
            dict(event=EventType.DENDEN_SUSTAIN, events=events, event_times=event_times, beatmap=beatmap),
        )
        self._emit_group(EventType.DENDEN_END, spinner.end_time, events, event_times, beatmap, time_event=True)
