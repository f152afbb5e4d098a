"""Slider curve flattening and arc-length parameterized path queries.

Implements the osu! path algorithms (piecewise Bezier via adaptive de
Casteljau subdivision, Catmull-Rom sampling, circular-arc stepping, linear)
with the exact tolerances and the expected-distance truncation/extension
quirks of the osu! client, matching the reference's behavior
(reference: ``osuT5/osuT5/inference/path_approximator.py``,
``osuT5/osuT5/inference/slider_path.py``) so rendered sliders are identical.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

BEZIER_TOLERANCE = 0.25
CATMULL_DETAIL = 50
CIRCULAR_ARC_TOLERANCE = 0.1


def _sqnorm(v: np.ndarray) -> float:
    return float(v[0] * v[0] + v[1] * v[1])


# ---------------------------------------------------------------------------
# flatteners
# ---------------------------------------------------------------------------


def flatten_linear(control_points: np.ndarray) -> list[np.ndarray]:
    return [np.array(p, dtype=float) for p in control_points]


def flatten_catmull(control_points: np.ndarray) -> list[np.ndarray]:
    """Catmull-Rom, CATMULL_DETAIL segments per span, duplicated sample points
    (each span emits both endpoints — mirrors the client's output stream)."""
    cps = np.asarray(control_points, dtype=float)
    n = len(cps)
    result: list[np.ndarray] = []
    for i in range(n - 1):
        v1 = cps[i - 1] if i > 0 else cps[i]
        v2 = cps[i]
        v3 = cps[i + 1] if i < n - 1 else v2 + v2 - v1
        v4 = cps[i + 2] if i < n - 2 else v3 + v3 - v2
        for c in range(CATMULL_DETAIL):
            result.append(_catmull_point(v1, v2, v3, v4, c / CATMULL_DETAIL))
            result.append(_catmull_point(v1, v2, v3, v4, (c + 1) / CATMULL_DETAIL))
    return result


def _catmull_point(v1, v2, v3, v4, t: float) -> np.ndarray:
    t2 = t * t
    t3 = t * t2
    return np.array(
        [
            0.5 * (2 * v2[0] + (-v1[0] + v3[0]) * t
                   + (2 * v1[0] - 5 * v2[0] + 4 * v3[0] - v4[0]) * t2
                   + (-v1[0] + 3 * v2[0] - 3 * v3[0] + v4[0]) * t3),
            0.5 * (2 * v2[1] + (-v1[1] + v3[1]) * t
                   + (2 * v1[1] - 5 * v2[1] + 4 * v3[1] - v4[1]) * t2
                   + (-v1[1] + 3 * v2[1] - 3 * v3[1] + v4[1]) * t3),
        ]
    )


def flatten_circular_arc(control_points: np.ndarray) -> list[np.ndarray]:
    """Three-point circular arc. Empty result signals a degenerate arc
    (collinear points) — caller falls back to a bezier."""
    a, b, c = (np.asarray(p, dtype=float) for p in control_points[:3])

    a_sq = _sqnorm(b - c)
    b_sq = _sqnorm(a - c)
    c_sq = _sqnorm(a - b)
    if np.isclose(a_sq, 0) or np.isclose(b_sq, 0) or np.isclose(c_sq, 0):
        return []

    s = a_sq * (b_sq + c_sq - a_sq)
    t = b_sq * (a_sq + c_sq - b_sq)
    u = c_sq * (a_sq + b_sq - c_sq)
    total = s + t + u
    if np.isclose(total, 0):
        return []

    centre = (s * a + t * b + u * c) / total
    d_a = a - centre
    d_c = c - centre
    r = float(np.linalg.norm(d_a))

    theta_start = np.arctan2(d_a[1], d_a[0])
    theta_end = np.arctan2(d_c[1], d_c[0])
    while theta_end < theta_start:
        theta_end += 2 * np.pi

    direction = 1.0
    theta_range = theta_end - theta_start
    ortho = c - a
    ortho = np.array([ortho[1], -ortho[0]])
    if np.dot(ortho, b - a) < 0:
        direction = -direction
        theta_range = 2 * np.pi - theta_range

    if 2 * r <= CIRCULAR_ARC_TOLERANCE:
        n_points = 2
    else:
        n_points = int(max(2, np.ceil(theta_range / (2 * np.arccos(1 - CIRCULAR_ARC_TOLERANCE / r)))))

    out = []
    for i in range(n_points):
        fract = i / (n_points - 1)
        theta = theta_start + direction * fract * theta_range
        out.append(centre + np.array([np.cos(theta), np.sin(theta)]) * r)
    return out


def flatten_bezier(control_points: np.ndarray) -> np.ndarray:
    """Adaptive de Casteljau flattening of an arbitrary-degree Bezier."""
    return _flatten_b_spline(np.asarray(control_points, dtype=float), 0)


def _flatten_b_spline(control_points: np.ndarray, p: int = 0) -> np.ndarray:
    n = len(control_points) - 1
    if n < 0:
        return np.empty([0, 2])

    to_flatten: list[np.ndarray] = []
    points = control_points.copy()

    if 0 < p < n:
        # B-spline: extract p-degree bezier segments via knot insertion.
        for i in range(n - p):
            sub = np.empty((p + 1, 2))
            sub[0] = points[i]
            for j in range(p - 1):
                sub[j + 1] = points[i + 1]
                for k in range(1, p - j):
                    l = min(k, n - p - i)
                    points[i + k] = (l * points[i + k] + points[i + k + 1]) / (l + 1)
            sub[p] = points[i + 1]
            to_flatten.append(sub)
        to_flatten.append(points[(n - p):])
        to_flatten.reverse()
    else:
        p = n
        to_flatten.append(points)

    output: list[np.ndarray] = []
    free_buffers: list[np.ndarray] = []
    count = p + 1
    buf_mid = np.empty([count, 2])
    left_child = np.empty([p * 2 + 1, 2])

    while to_flatten:
        parent = to_flatten.pop()
        if _flat_enough(parent):
            _approximate(parent, output, buf_mid, left_child, count)
            free_buffers.append(parent)
            continue
        right_child = free_buffers.pop() if free_buffers else np.empty([count, 2])
        _subdivide(parent, left_child, right_child, buf_mid, count)
        parent[:count] = left_child[:count]
        to_flatten.append(right_child)
        to_flatten.append(parent)

    output.append(control_points[n].copy())
    return np.vstack(output)


def _flat_enough(cps: np.ndarray) -> bool:
    for i in range(1, len(cps) - 1):
        v = cps[i - 1] - 2 * cps[i] + cps[i + 1]
        if _sqnorm(v) > BEZIER_TOLERANCE * BEZIER_TOLERANCE * 4:
            return False
    return True


def _subdivide(cps: np.ndarray, left: np.ndarray, right: np.ndarray, midpoints: np.ndarray, count: int) -> None:
    midpoints[:count] = cps[:count]
    for i in range(count):
        left[i] = midpoints[0].copy()
        right[count - i - 1] = midpoints[count - i - 1]
        for j in range(count - i - 1):
            midpoints[j] = (midpoints[j] + midpoints[j + 1]) / 2


def _approximate(cps: np.ndarray, output: list, buf_mid: np.ndarray, left: np.ndarray, count: int) -> None:
    right = buf_mid
    _subdivide(cps, left, right, buf_mid, count)
    for i in range(count - 1):
        left[count + i] = right[i + 1]
    output.append(cps[0].copy())
    for i in range(1, count - 1):
        index = 2 * i
        output.append((0.25 * (left[index - 1] + 2 * left[index] + left[index + 1])).copy())


# ---------------------------------------------------------------------------
# arc-length parameterized path
# ---------------------------------------------------------------------------

# .osu curve-type letters -> canonical path type names
PATH_TYPE_BY_LETTER = {"L": "Linear", "P": "PerfectCurve", "C": "Catmull", "B": "Bezier"}
LETTER_BY_PATH_TYPE = {v: k for k, v in PATH_TYPE_BY_LETTER.items()}


class SliderPath:
    """Flattened slider path with osu!-exact expected-distance handling.

    Red anchors (duplicated control points) split the path into sub-segments.
    ``expected_distance`` truncates or linearly extends the final segment the
    way the client does (including its delete-middle-slice quirk).
    """

    def __init__(
        self,
        path_type: str,
        control_points: np.ndarray,
        expected_distance: Optional[float] = None,
    ) -> None:
        self.path_type = path_type
        self.control_points = np.asarray(control_points, dtype=float)
        self.expected_distance = expected_distance
        self.calculated_path: list[np.ndarray] = []
        self.cumulative_length: list[float] = []
        self._build()

    # construction ----------------------------------------------------------

    def _segment(self, cps: np.ndarray) -> Sequence[np.ndarray]:
        if self.path_type == "Linear":
            return flatten_linear(cps)
        if self.path_type == "PerfectCurve":
            if len(self.control_points) != 3 or len(cps) != 3:
                return flatten_bezier(cps)
            arc = flatten_circular_arc(cps)
            return arc if len(arc) > 0 else flatten_bezier(cps)
        if self.path_type == "Catmull":
            return flatten_catmull(cps)
        return flatten_bezier(cps)

    def _build(self) -> None:
        cps = self.control_points
        path = self.calculated_path
        start = 0
        for i in range(len(cps)):
            if i == len(cps) - 1 or (cps[i] == cps[i + 1]).all():
                for t in self._segment(cps[start : i + 1]):
                    if len(path) == 0 or (path[-1] != t).any():
                        path.append(t)
                start = i + 1

        # cumulative arc length w/ expected-distance truncation/extension
        length = 0.0
        cum = self.cumulative_length
        cum.append(length)
        expected = self.expected_distance
        i = 0
        while i < len(path) - 1:
            diff = path[i + 1] - path[i]
            d = float(np.linalg.norm(diff))
            if expected is not None and expected - length < d:
                path[i + 1] = path[i] + diff * (expected - length) / d
                # client quirk: drops a middle slice rather than the tail
                del path[i + 2 : len(path) - 2 - i]
                length = expected
                cum.append(length)
                return
            length += d
            cum.append(length)
            i += 1

        if expected is not None and length < expected and len(path) > 1:
            diff = path[-1] - path[-2]
            d = float(np.linalg.norm(diff))
            if d <= 0:
                return
            path[-1] = path[-1] + diff * (expected - cum[-1]) / d
            cum[-1] = expected

    # queries ----------------------------------------------------------------

    def get_distance(self) -> float:
        return 0.0 if not self.cumulative_length else self.cumulative_length[-1]

    def position_at(self, progress: float) -> np.ndarray:
        d = float(np.clip(progress, 0, 1)) * self.get_distance()
        return self._vertex_at(self._index_of_distance(d), d)

    def path_between(self, p0: float, p1: float) -> list[np.ndarray]:
        """Sampled vertices covering the [p0, p1] progress span."""
        d0 = float(np.clip(p0, 0, 1)) * self.get_distance()
        d1 = float(np.clip(p1, 0, 1)) * self.get_distance()
        out: list[np.ndarray] = []
        i = 0
        while i < len(self.calculated_path) and self.cumulative_length[i] < d0:
            i += 1
        out.append(self._vertex_at(i, d0))
        while i < len(self.calculated_path) and self.cumulative_length[i] < d1:
            out.append(self.calculated_path[i])
            i += 1
        out.append(self._vertex_at(i, d1))
        return out

    def _index_of_distance(self, d: float) -> int:
        # first index with cumulative_length >= d
        import bisect

        return bisect.bisect_left(self.cumulative_length, d)

    def _vertex_at(self, i: int, d: float) -> np.ndarray:
        path, cum = self.calculated_path, self.cumulative_length
        if len(path) == 0:
            return np.zeros(2)
        if i <= 0:
            return path[0]
        if i >= len(path):
            return path[-1]
        p0, p1 = path[i - 1], path[i]
        d0, d1 = cum[i - 1], cum[i]
        if np.isclose(d0, d1):
            return p0
        w = (d - d0) / (d1 - d0)
        return p0 + (p1 - p0) * w
