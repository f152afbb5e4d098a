"""Sampled coordinate sequences -> playable beatmaps: a copy of the JAX
``diffusion/export.py`` (``tests/test_torch_nojax.py`` holds it to its
source).

The inverse of :func:`.data.get_data` (reference:
``osu_diffusion/utils/export/create_beatmap.py:22-256``): walk the (19, T)
datapoint sequence's type one-hots, rebuild circles / spinners / sliders on
the :class:`~..osu.beatmap.Beatmap` model, fit each slider's pixel length to
the sampled end position, and write an SV greenline per slider so the
sampled geometry plays at the original velocity grid. Used by the
``diffusion_sample`` entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..osu.beatmap import Beatmap, Circle, Slider, Spinner, TimingPoint
from ..osu.curves import LETTER_BY_PATH_TYPE, SliderPath

# type one-hot indices emitted by data.get_data / create_datapoint
_CIRCLE, _CIRCLE_NC = 0, 1
_SPINNER, _SPINNER_END = 2, 3
_SLIDER, _SLIDER_NC = 4, 5
_BEZIER, _PERFECT, _CATMULL, _RED, _LAST = 6, 7, 8, 9, 10
# 11..15: slider end with repeat class 1, 2, 3, even, odd


def position_to_progress(path: SliderPath, pos: np.ndarray) -> float:
    """Gradient walk from t=1 toward the sampled end position (reference:
    create_beatmap.py:158-172) — finds where along the path the slider ends."""
    eps = 1e-4
    t = 1.0
    for _ in range(100):
        grad = float(
            np.linalg.norm(path.position_at(t) - pos)
            - np.linalg.norm(path.position_at(t - eps) - pos)
        )
        t -= grad
        if grad == 0 or t < 0 or t > 1:
            break
    return float(np.clip(t, 0.0, 1.0))


def sequence_to_beatmap(seq: np.ndarray, ref_beatmap: Beatmap, version: str) -> Beatmap:
    """(19, T) datapoint sequence (pixel positions, ms times) -> a new
    difficulty of ``ref_beatmap`` with the sampled geometry."""
    seq = np.asarray(seq)
    hit_objects: list = []
    timing_points = [tp for tp in ref_beatmap.timing_points if tp.parent is None]

    curr: Optional[Slider] = None
    curr_path: list[tuple[float, float]] = []
    curr_type = "Bezier"
    span_duration = 0.0

    for j in range(seq.shape[1]):
        x = float(round(float(seq[0, j])))
        y = float(round(float(seq[1, j])))
        time = float(seq[2, j])
        type_index = int(np.argmax(seq[3:, j]))
        pos = (x, y)

        if type_index in (_CIRCLE, _CIRCLE_NC):
            nc = type_index == _CIRCLE_NC
            hit_objects.append(Circle(x, y, time, type_flags=1 | (4 if nc else 0),
                                      hitsound=0, new_combo=nc))
        elif type_index == _SPINNER:
            curr = Spinner(x, y, time, type_flags=8 | 4, hitsound=0, new_combo=True,
                           _end_time=time)
        elif type_index == _SPINNER_END and isinstance(curr, Spinner):
            curr._end_time = time
            hit_objects.append(curr)
            curr = None
        elif type_index in (_SLIDER, _SLIDER_NC):
            nc = type_index == _SLIDER_NC
            curr = Slider(x, y, time, type_flags=2 | (4 if nc else 0), hitsound=0,
                          new_combo=nc)
            curr_path = [pos]
            curr_type = "Bezier"
        elif isinstance(curr, Slider):
            if type_index == _BEZIER:
                curr_path.append(pos)
            elif type_index == _PERFECT:
                curr_path.append(pos)
                curr_type = "PerfectCurve"
            elif type_index == _CATMULL:
                curr_path.append(pos)
                curr_type = "Catmull"
            elif type_index == _RED:
                curr_path.append(pos)
                curr_path.append(pos)
            elif type_index == _LAST:
                curr_path.append(pos)
                span_duration = time - curr.time
            else:  # slider end (repeat classes)
                path = SliderPath(curr_type, np.asarray(curr_path, float))
                req_length = path.get_distance() * position_to_progress(path, np.asarray(pos))
                duration = time - curr.time
                if span_duration <= 0:
                    span_duration = max(duration, 1.0)
                repeat = (
                    int(round(duration / span_duration))
                    if type_index > 13
                    else type_index - 10
                )
                repeat = max(repeat, 1)
                curr.curve_type = LETTER_BY_PATH_TYPE.get(curr_type, "B")
                curr.curve_points = list(curr_path[1:])
                curr.length = req_length
                curr.repeat = repeat
                curr.duration = duration
                curr.edge_sounds = [0] * (repeat + 1)
                curr.edge_additions = ["0:0"] * (repeat + 1)
                hit_objects.append(curr)

                # SV greenline so the sampled length spans the sampled
                # duration on the original timing grid
                tp = ref_beatmap.timing_point_at(curr.time)
                red = tp.parent if (tp is not None and tp.parent is not None) else tp
                ms_per_beat = red.ms_per_beat if red is not None else 500.0
                global_sv = ref_beatmap.slider_multiplier
                new_sv = req_length * ms_per_beat / (100.0 * global_sv * span_duration)
                timing_points.append(TimingPoint(
                    offset=curr.time,
                    ms_per_beat=-100.0 / new_sv if new_sv > 0 else -100.0,
                    meter=red.meter if red is not None else 4,
                    sample_type=tp.sample_type if tp is not None else 0,
                    sample_index=tp.sample_index if tp is not None else 0,
                    volume=tp.volume if tp is not None else 100,
                    uninherited=False,
                    kiai=tp.kiai if tp is not None else False,
                    parent=red,
                ))
                curr = None

    timing_points.sort(key=lambda tp: (tp.offset, tp.uninherited is False))
    return dataclasses.replace(
        ref_beatmap,
        version=version,
        timing_points=timing_points,
        _hit_objects=hit_objects,
    )
