"""Star-rating via the native C++ calculator: the port's copy of
``mapperatorinator_tpu/native/difficulty.py``.

Classic strain-based difficulty for all four gamemodes (the reference's
rosu-pp dependency, reference: ``osuT5/osuT5/dataset/data_utils.py:195-226``),
implemented in ``csrc/difficulty.cpp`` (a copy of the repo's
``native/difficulty.cpp``) and loaded over ctypes. The shared library is
built on first use with g++ into ``build/torch_kernels/`` by
:mod:`..ops._build`.

Matches the reference's call signature: ``calculate_difficulty(content=...,
path=..., speed=...) -> Optional[float]`` (rounded to 2 decimals, None on
failure).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from ..ops import _build

LIB_PATH = _build.library_path("difficulty")

_lib = None
_lib_lock = threading.Lock()

_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        _build.build("difficulty")
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.osu_std_stars.restype = ctypes.c_double
        lib.osu_std_stars.argtypes = [_F64P, _F64P, _F64P, _I32P, ctypes.c_int32,
                                      ctypes.c_double, ctypes.c_double]
        lib.osu_std_stars_v2.restype = ctypes.c_double
        lib.osu_std_stars_v2.argtypes = [_F64P, _F64P, _F64P, _I32P,
                                         _F64P, _F64P, _F64P, _F64P, _F64P, _F64P,
                                         ctypes.c_int32, ctypes.c_double,
                                         ctypes.c_double, ctypes.c_double]
        lib.taiko_stars.restype = ctypes.c_double
        lib.taiko_stars.argtypes = [_F64P, _I32P, ctypes.c_int32, ctypes.c_double]
        lib.mania_stars.restype = ctypes.c_double
        lib.mania_stars.argtypes = [_F64P, _F64P, _I32P, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_double]
        lib.catch_stars.restype = ctypes.c_double
        lib.catch_stars.argtypes = [_F64P, _F64P, ctypes.c_int32,
                                    ctypes.c_double, ctypes.c_double]
        lib.taiko_stars_v2.restype = ctypes.c_double
        lib.taiko_stars_v2.argtypes = [_F64P, _I32P, ctypes.c_int32, ctypes.c_double]
        lib.mania_stars_v2.restype = ctypes.c_double
        lib.mania_stars_v2.argtypes = [_F64P, _F64P, _I32P, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_double]
        lib.catch_stars_v2.restype = ctypes.c_double
        lib.catch_stars_v2.argtypes = [_F64P, _F64P, ctypes.c_int32,
                                       ctypes.c_double, ctypes.c_double]
        _lib = lib
        return _lib


def _arr_f64(values) -> tuple[np.ndarray, "_F64P"]:
    a = np.ascontiguousarray(values, dtype=np.float64)
    return a, a.ctypes.data_as(_F64P)


def _arr_i32(values) -> tuple[np.ndarray, "_I32P"]:
    a = np.ascontiguousarray(values, dtype=np.int32)
    return a, a.ctypes.data_as(_I32P)


def beatmap_stars(beatmap, speed: float = 1.0) -> float:
    """Star rating of a parsed :class:`~mapperatorinator_tpu.osu.Beatmap`."""
    from ..osu.beatmap import HoldNote, Slider, Spinner

    lib = _load_library()
    objs = beatmap.hit_objects(stacking=False)
    if len(objs) < 2:
        return 0.0

    mode = int(beatmap.mode)
    times = [float(h.time) for h in objs]

    if mode == 1:
        # taiko (current 2022-rework algorithm): kat = whistle(2) or clap(8);
        # drumrolls/dendens are non-hits (break colour streaks, no strain)
        colors = []
        for h in objs:
            if isinstance(h, (Slider, Spinner)):
                colors.append(2)
            else:
                colors.append(1 if h.hitsound & 10 else 0)
        t, tp = _arr_f64(times)
        c, cp = _arr_i32(colors)
        return float(lib.taiko_stars_v2(tp, cp, len(objs), float(speed)))

    if mode == 3:
        # mania (current per-column/overall Strain): column from x position;
        # notes ordered by start time (lazer sorts the same way)
        keys = max(int(round(beatmap.circle_size)), 1)
        order = sorted(range(len(objs)), key=lambda i: objs[i].time)
        columns = [min(int(objs[i].x * keys / 512.0), keys - 1) for i in order]
        starts = [float(objs[i].time) for i in order]
        end_times = [
            float(objs[i].end_time) if isinstance(objs[i], HoldNote) else float(objs[i].time)
            for i in order
        ]
        t, tp = _arr_f64(starts)
        e, ep = _arr_f64(end_times)
        c, cp = _arr_i32(columns)
        return float(lib.mania_stars_v2(tp, ep, cp, len(objs), keys, float(speed)))

    if mode == 2:
        # catch (current Movement skill): palpable objects are fruits,
        # juice-stream droplets (per-tick), repeat and tail fruits — tiny
        # droplets and banana showers are excluded (lazer
        # CatchDifficultyCalculator.CreateDifficultyHitObjects)
        palpable = []  # (time, x)
        for h in objs:
            if isinstance(h, Spinner):
                continue  # banana shower
            palpable.append((float(h.time), float(h.x)))
            if isinstance(h, Slider):
                tp_at = beatmap.timing_point_at(h.time)
                beat_length = 60000.0 / tp_at.bpm if tp_at is not None and tp_at.bpm else 500.0
                for nt, prog in _slider_nested(h, beat_length, beatmap.slider_tick_rate or 1.0):
                    pos = h.position_at_progress(prog)
                    palpable.append((float(nt), float(pos[0])))
        palpable.sort(key=lambda p: p[0])
        if len(palpable) < 2:
            return 0.0
        t, tp = _arr_f64([p[0] for p in palpable])
        x, xp = _arr_f64([p[1] for p in palpable])
        return float(lib.catch_stars_v2(tp, xp, len(palpable), float(beatmap.circle_size), float(speed)))

    # osu!standard — current (lazer 2022+/rosu-pp) algorithm. Slider lazy
    # travel is resolved here via the follow-circle cursor simulation
    # (lazer OsuDifficultyHitObject.computeSliderCursorPosition); the C++
    # side runs the Aim/Speed/Rhythm evaluators and the star combination.
    # Stacking offsets are applied like rosu-pp does internally (the stable
    # applyStacking pass), shifting whole objects by stack_height*scale*-6.4.
    radius = 32.0 * (1.0 - 0.7 * (beatmap.circle_size - 5.0) / 5.0)
    stack_offsets = _stack_offsets(objs, beatmap)
    xs, ys, types = [], [], []
    lazy_ex, lazy_ey, travel_d, travel_t, tail_xs, tail_ys = [], [], [], [], [], []
    for i, h in enumerate(objs):
        off = stack_offsets[i]
        if isinstance(h, Spinner):
            xs.append(256.0); ys.append(192.0); types.append(2)
        else:
            xs.append(float(h.x) + off); ys.append(float(h.y) + off)
            types.append(1 if isinstance(h, Slider) else 0)
        if isinstance(h, Slider):
            tp_at = beatmap.timing_point_at(h.time)
            beat_length = 60000.0 / tp_at.bpm if tp_at is not None and tp_at.bpm else 500.0
            lend, ldist, ltime, tail = _slider_lazy_travel(
                h, radius, beat_length, beatmap.slider_tick_rate or 1.0
            )
            # the stack offset shifts the whole slider; travel distances are
            # offset-invariant, endpoint positions are not
            lazy_ex.append(lend[0] + off); lazy_ey.append(lend[1] + off)
            travel_d.append(ldist); travel_t.append(ltime)
            tail_xs.append(tail[0] + off); tail_ys.append(tail[1] + off)
        else:
            lazy_ex.append(xs[-1]); lazy_ey.append(ys[-1])
            travel_d.append(0.0); travel_t.append(0.0)
            tail_xs.append(xs[-1]); tail_ys.append(ys[-1])
    t, tp = _arr_f64(times)
    x, xp = _arr_f64(xs)
    y, yp = _arr_f64(ys)
    ty, typ = _arr_i32(types)
    lex, lexp = _arr_f64(lazy_ex)
    ley, leyp = _arr_f64(lazy_ey)
    td, tdp = _arr_f64(travel_d)
    tt, ttp = _arr_f64(travel_t)
    tx, txp = _arr_f64(tail_xs)
    tyy, typp = _arr_f64(tail_ys)
    return float(lib.osu_std_stars_v2(
        tp, xp, yp, typ, lexp, leyp, tdp, ttp, txp, typp,
        len(objs), float(radius), float(beatmap.overall_difficulty), float(speed)))


def _slider_nested(slider, beat_length: float, tick_rate: float):
    """Nested-object (time, span-progress) samples: ticks, repeats, tail
    (lazer SliderEventGenerator semantics, simplified: no tick offset)."""
    span = max(slider.span_duration, 1.0)
    tick_dt = max(beat_length / max(tick_rate, 0.1), 1.0)
    nested = []
    for s in range(max(slider.repeat, 1)):
        start = slider.time + s * span
        forward = s % 2 == 0
        k = 1
        while k * tick_dt < span - 10.0 and k < 1000:
            prog = k * tick_dt / span
            nested.append((start + k * tick_dt, prog if forward else 1.0 - prog))
            k += 1
        nested.append((start + span, 1.0 if forward else 0.0))
    return nested


def _slider_lazy_travel(slider, radius: float, beat_length: float, tick_rate: float):
    """Follow-circle cursor simulation -> (lazy_end_pos, lazy_travel_dist
    [normalized], lazy_travel_time [ms], tail_pos). Ports lazer's
    OsuDifficultyHitObject.computeSliderCursorPosition."""
    assumed_slider_radius = 50.0 * 1.8
    scaling = 50.0 / max(radius, 1e-6)

    span = max(slider.span_duration, 1.0)
    duration = max(slider.duration, 1.0)
    # legacy last tick: the tracked end is 36 ms early, at least mid-duration
    tracking_end = max(slider.time + duration - 36.0, slider.time + duration / 2.0)
    lazy_travel_time = tracking_end - slider.time

    end_time_min = lazy_travel_time / span
    if end_time_min % 2 >= 1:
        end_time_min = 1 - end_time_min % 1
    else:
        end_time_min %= 1

    pos_at = slider.position_at_progress
    lazy_end = np.asarray(pos_at(end_time_min), dtype=float)
    tail = np.asarray(pos_at(1.0 if slider.repeat % 2 == 1 else 0.0), dtype=float)

    nested = _slider_nested(slider, beat_length, tick_rate)
    if nested:
        # replace the final nested event with the tracked end
        nested[-1] = (tracking_end, end_time_min)

    curr = np.asarray([slider.x, slider.y], dtype=float)
    lazy_travel_dist = 0.0
    for i, (_, prog) in enumerate(nested):
        pos = np.asarray(pos_at(prog), dtype=float)
        movement = pos - curr
        movement_len = scaling * float(np.hypot(*movement))
        if i == len(nested) - 1:
            end_movement = lazy_end - curr
            end_len = scaling * float(np.hypot(*end_movement))
            if end_len < movement_len:
                movement, movement_len = end_movement, end_len
        if movement_len > assumed_slider_radius:
            frac = (movement_len - assumed_slider_radius) / movement_len
            curr = curr + movement * frac
            lazy_travel_dist += movement_len * frac
        if i == len(nested) - 1:
            lazy_end = curr
    repeat_count = max(slider.repeat - 1, 0)
    lazy_travel_dist *= (1 + repeat_count / 2.5) ** (1.0 / 2.5)
    return (float(lazy_end[0]), float(lazy_end[1])), lazy_travel_dist, lazy_travel_time, (
        float(tail[0]), float(tail[1]))


def _stack_offsets(objs, beatmap) -> list:
    """osu!stable applyStacking: chains of overlapped circles/slider heads
    within the AR-preempt*leniency time window stack with 3 px tolerance;
    each layer shifts the object by stack_height * scale * -6.4 px on both
    axes (rosu-pp applies the same pass before difficulty calculation)."""
    from ..osu.beatmap import Slider, Spinner

    n = len(objs)
    heights = [0] * n
    ar = beatmap.approach_rate
    preempt = 1200.0 + (600.0 * (5.0 - ar) / 5.0 if ar < 5 else -750.0 * (ar - 5.0) / 5.0)
    stack_threshold = preempt * (beatmap.stack_leniency or 0.7)
    STACK_DISTANCE = 3.0

    def pos(h):
        return (float(h.x), float(h.y))

    def end_pos(h):
        if isinstance(h, Slider):
            p = h.position_at_progress(1.0 if h.repeat % 2 == 1 else 0.0)
            return (float(p[0]), float(p[1]))
        return pos(h)

    def end_time(h):
        return float(getattr(h, "end_time", h.time))

    def close(a, b):
        return ((a[0] - b[0]) ** 2 + (a[1] - b[1]) ** 2) ** 0.5 < STACK_DISTANCE

    for i in range(n - 1, 0, -1):
        cur = i
        obj_i = objs[cur]
        if heights[cur] != 0 or isinstance(obj_i, Spinner):
            continue
        if isinstance(obj_i, Slider):
            m = cur
            while m > 0:
                m -= 1
                obj_m = objs[m]
                if isinstance(obj_m, Spinner):
                    continue
                if objs[cur].time - obj_m.time > stack_threshold:
                    break
                if close(end_pos(obj_m), pos(objs[cur])):
                    heights[m] = heights[cur] + 1
                    cur = m
        else:
            m = cur
            while m > 0:
                m -= 1
                obj_m = objs[m]
                if isinstance(obj_m, Spinner):
                    continue
                if objs[cur].time - end_time(obj_m) > stack_threshold:
                    break
                if isinstance(obj_m, Slider) and close(end_pos(obj_m), pos(objs[cur])):
                    offset = heights[cur] - heights[m] + 1
                    for j in range(m + 1, i + 1):
                        if close(end_pos(obj_m), pos(objs[j])):
                            heights[j] -= offset
                    break
                if close(pos(obj_m), pos(objs[cur])):
                    heights[m] = heights[cur] + 1
                    cur = m

    scale = (1.0 - 0.7 * (beatmap.circle_size - 5.0) / 5.0) / 2.0
    return [h_count * scale * -6.4 for h_count in heights]


def calculate_difficulty(content: Optional[str] = None, path=None, speed: float = 1.0) -> Optional[float]:
    """Star rating from .osu text or path; None on failure
    (reference: data_utils.py:190-226)."""
    from ..osu.beatmap import Beatmap

    try:
        if content is not None:
            beatmap = Beatmap.from_string(content)
        elif path is not None:
            beatmap = Beatmap.from_path(path)
        else:
            raise ValueError("Either 'content' or 'path' must be provided")
        return round(beatmap_stars(beatmap, speed=speed), 2)
    except Exception as e:  # mirror the reference: log + None, never raise
        source = path if path is not None else "<content>"
        print(f"Failed to calculate difficulty for beatmap {source}: {e}")
        return None
