"""Rhythm precision/recall/F1 between real and generated beatmaps
(reference: ``calc_fid.py:425-495``)."""

from __future__ import annotations

import numpy as np

from ..osu.beatmap import Beatmap, Circle, HoldNote, Slider, Spinner


def get_rhythm(beatmap: Beatmap, passive: bool = False) -> set[int]:
    """Active rhythm: circle/slider-head/hold-head times; passive also adds
    slider tails+repeats and spinner tails."""
    rhythm: set[int] = set()
    for ho in beatmap.hit_objects(stacking=False):
        if isinstance(ho, Slider):
            duration = (ho.end_time - ho.time) / ho.repeat
            rhythm.add(int(ho.time + 1e-5))
            if passive:
                for i in range(ho.repeat):
                    rhythm.add(int(ho.time + duration * (i + 1) + 1e-5))
        elif isinstance(ho, Spinner):
            if passive:
                rhythm.add(int(ho.end_time + 1e-5))
        elif isinstance(ho, (Circle, HoldNote)):
            rhythm.add(int(ho.time + 1e-5))
    return rhythm


def calculate_rhythm_stats(real_rhythm: set, generated_rhythm: set, leniency: int = 10) -> dict:
    real = np.array(sorted(real_rhythm))
    gen = np.array(sorted(generated_rhythm))

    def has_match(a, b):
        if len(b) == 0:
            return np.zeros(len(a), bool)
        idx = np.searchsorted(b, a)
        left = np.abs(a - b[np.clip(idx - 1, 0, len(b) - 1)])
        right = np.abs(a - b[np.clip(idx, 0, len(b) - 1)])
        return np.minimum(left, right) <= leniency

    tp = int(has_match(real, gen).sum()) if len(real) else 0
    fn = len(real) - tp
    fp = int((~has_match(gen, real)).sum()) if len(gen) else 0
    return {"true_positives": tp, "false_positives": fp, "false_negatives": fn}


def calculate_precision(stats: dict) -> float:
    tp, fp = stats["true_positives"], stats["false_positives"]
    return tp / (tp + fp) if tp + fp else 0.0


def calculate_recall(stats: dict) -> float:
    tp, fn = stats["true_positives"], stats["false_negatives"]
    return tp / (tp + fn) if tp + fn else 0.0


def calculate_f1(stats: dict) -> float:
    p, r = calculate_precision(stats), calculate_recall(stats)
    return 2 * p * r / (p + r) if p + r else 0.0
