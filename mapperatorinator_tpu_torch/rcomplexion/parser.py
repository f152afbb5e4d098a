"""Rhythm-complexion beatmap parser: hit objects -> (time-shift, marker) event
pairs with clipped, quantized inter-object gaps
(reference: ``rcomplexion/libs/dataset/osu_parser.py:12-160``; spinners are
skipped there too)."""

from __future__ import annotations

import numpy as np

from ..osu.beatmap import Beatmap, Circle, Slider
from ..osu.events import Event, EventType


class RParser:
    def __init__(self, args) -> None:
        self.time_resolution = args.time_resolution
        self.min_time = args.min_time
        self.max_timeshift = int((args.max_time - args.min_time) * self.time_resolution)

    def _clip_time(self, time: float, last_time: float) -> int:
        delta = time - last_time
        return int(np.clip(round((delta - self.min_time) * self.time_resolution), 0, self.max_timeshift))

    def parse(self, beatmap: Beatmap) -> list[Event]:
        events: list[Event] = []
        last_time = -100_000.0
        for ho in beatmap.hit_objects(stacking=False):
            if isinstance(ho, Circle):
                events.append(Event(EventType.TIME_SHIFT, self._clip_time(ho.time, last_time)))
                events.append(Event(EventType.CIRCLE))
                last_time = ho.time
            elif isinstance(ho, Slider):
                events.append(Event(EventType.TIME_SHIFT, self._clip_time(ho.time, last_time)))
                events.append(Event(EventType.SLIDER_HEAD))
                last_time = ho.time
                span = (ho.end_time - ho.time) / ho.repeat
                events.append(Event(EventType.TIME_SHIFT, self._clip_time(ho.time + span, last_time)))
                events.append(Event(EventType.LAST_ANCHOR))
                events.append(Event(EventType.TIME_SHIFT, self._clip_time(ho.end_time, last_time)))
                events.append(Event(EventType.SLIDER_END))
        return events
