"""Timing-point algebra: ordered insertion/merging of inherited (green) and
uninherited (red) timing points with fuzzy-offset dedup and effect-equality
checks (reference: ``osuT5/osuT5/inference/timing_points_change.py:9-168``).
Used by the postprocessor to write SV/volume/kiai changes into .osu timing.

Times are float milliseconds (this framework's convention) rather than the
reference's timedeltas.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cmp_to_key
from typing import List, Optional

from .beatmap import TimingPoint


def copy_tp(tp: TimingPoint) -> TimingPoint:
    return dataclasses.replace(tp)


def same_effect(tp: TimingPoint, other: TimingPoint) -> bool:
    return (
        tp.ms_per_beat == other.ms_per_beat
        and tp.meter == other.meter
        and tp.sample_type == other.sample_type
        and tp.sample_index == other.sample_index
        and tp.volume == other.volume
        and (tp.parent is None) == (other.parent is None)
        and tp.kiai == other.kiai
    )


def compare_timing_point(tp1: Optional[TimingPoint], tp2: Optional[TimingPoint]) -> int:
    if tp1 is tp2:
        return 0
    if tp2 is None:
        return 1
    if tp1 is None:
        return -1
    if tp1.offset != tp2.offset:
        return 1 if tp1.offset > tp2.offset else -1
    # red before green at equal offsets
    a, b = tp1.parent is None, tp2.parent is None
    return -((a > b) - (a < b))


def sort_timing_points(timing_points: List[TimingPoint]) -> List[TimingPoint]:
    return sorted(timing_points, key=cmp_to_key(compare_timing_point))


class TimingPointsChange:
    """One desired change (mpb/meter/sampleset/index/volume/uninherited/kiai)
    at an offset, applied into an existing timing list with ~2 ms fuzz."""

    def __init__(
        self,
        tp_new: TimingPoint,
        mpb: bool = False,
        meter: bool = False,
        sampleset: bool = False,
        index: bool = False,
        volume: bool = False,
        uninherited: bool = False,
        kiai: bool = False,
        fuzzyness: float = 2,
    ):
        self.my_tp = tp_new
        self.ms_per_beat = mpb
        self.meter = meter
        self.sample_type = sampleset
        self.sample_index = index
        self.volume = volume
        self.uninherited = uninherited
        self.kiai = kiai
        self.fuzzyness = fuzzyness  # ms

    def add_change(self, timing: List[TimingPoint], all_after: bool = False) -> List[TimingPoint]:
        adding: Optional[TimingPoint] = None
        prev_tp: Optional[TimingPoint] = None
        on_points: list[TimingPoint] = []
        on_has_red = False
        on_has_green = False

        for tp in timing:
            if tp is None:
                continue
            if tp.offset < self.my_tp.offset and (prev_tp is None or tp.offset >= prev_tp.offset):
                prev_tp = tp
            if math.isclose(tp.offset, self.my_tp.offset, abs_tol=self.fuzzyness):
                on_points.append(tp)
                on_has_red = (tp.parent is None) or on_has_red
                on_has_green = (tp.parent is not None) or on_has_green

        if on_points:
            prev_tp = on_points[-1]

        if self.uninherited and not on_has_red:
            # new redline
            if prev_tp is None:
                adding = copy_tp(self.my_tp)
            else:
                adding = copy_tp(prev_tp)
                adding.offset = self.my_tp.offset
            adding.parent = None
            adding.uninherited = True
            on_points.append(adding)

        if not self.uninherited and (not on_points or (self.ms_per_beat and not on_has_green)):
            # new greenline — must inherit from an actual redline; conjure or
            # shift one backwards if none precedes this offset
            if prev_tp is None:
                prev_tp = self._ensure_redline_before(self.my_tp.offset, timing)
            adding = copy_tp(prev_tp)
            adding.offset = self.my_tp.offset
            adding.parent = prev_tp if prev_tp.parent is None else prev_tp.parent
            adding.uninherited = False
            if prev_tp.parent is None:
                adding.ms_per_beat = -100
            on_points.append(adding)

        for on in on_points:
            if self.ms_per_beat and (self.uninherited == (on.parent is None)):
                on.ms_per_beat = self.my_tp.ms_per_beat
            if self.meter and self.uninherited and on.parent is None:
                on.meter = self.my_tp.meter
            if self.sample_type:
                on.sample_type = self.my_tp.sample_type
            if self.sample_index:
                on.sample_index = self.my_tp.sample_index
            if self.volume:
                on.volume = self.my_tp.volume
            if self.kiai:
                on.kiai = self.my_tp.kiai

        if adding is not None and (prev_tp is None or not same_effect(adding, prev_tp) or self.uninherited):
            timing.append(adding)

        if all_after:
            for tp in timing:
                if tp.offset > self.my_tp.offset:
                    if self.sample_type:
                        tp.sample_type = self.my_tp.sample_type
                    if self.sample_index:
                        tp.sample_index = self.my_tp.sample_index
                    if self.volume:
                        tp.volume = self.my_tp.volume
                    if self.kiai:
                        tp.kiai = self.my_tp.kiai

        return sort_timing_points(timing)

    @staticmethod
    def apply_changes(
        timing: List[TimingPoint],
        changes: List["TimingPointsChange"],
        all_after: bool = False,
    ) -> List[TimingPoint]:
        changes.sort(key=lambda o: o.my_tp.offset)
        for change in changes:
            timing = change.add_change(timing, all_after)
        return timing

    @staticmethod
    def _first_redline(tps: List[TimingPoint]) -> Optional[TimingPoint]:
        reds = [tp for tp in tps if tp is not None and tp.parent is None]
        return min(reds, key=lambda t: t.offset) if reds else None

    def _ensure_redline_before(self, time_offset: float, tps: List[TimingPoint]) -> TimingPoint:
        first = self._first_redline(tps)
        if first is None:
            new_red = TimingPoint(
                offset=time_offset, ms_per_beat=1000, meter=4, sample_type=2,
                sample_index=-1, volume=100, uninherited=True, kiai=False,
            )
            tps.append(new_red)
            return new_red
        if first.offset > time_offset:
            measure_ms = first.ms_per_beat * first.meter
            back_ms = first.offset - time_offset
            n_measures = math.ceil(back_ms / measure_ms)
            first.offset -= n_measures * measure_ms
        return first
