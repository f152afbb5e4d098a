"""Ensemble timing inference: a copy of the JAX ``infer/super_timing.py``
(``tests/test_torch_nojax.py`` holds it to its source), on the port's
Processor (behavioral counterpart of reference
``osuT5/osuT5/inference/super_timing_generator.py``).

N timing passes over randomly offset copies of the audio vote on where the
beats are. Every window of every ensemble member is pooled into shared
batched parallel decodes (the ``Processor`` parallel-session API): on the
card, the engine's graphed decode step at batches of up to
``max_batch_size`` rows. The analysis is host-side numpy (accumulate,
localize, walk, label and repair); its constants are the ensemble's
behavioral contract, locked by ``tests/test_super_timing_golden.py`` and, for
this copy, ``tests/test_torch_super_timing.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import gaussian_filter1d
from scipy.signal import find_peaks

from ..osu.events import ContextType, Event, EventType
from ..osu.streams import BEAT_TYPES, get_groups
from ..osu.vocab import MILLISECONDS_PER_STEP
from .preprocessor import Preprocessor
from .processor import Processor

MS_PER_SECOND = 1000

# -- analysis constants (contract with the reference ensemble) ----------------
SMOOTH_SIGMA = 10.0  # gaussian blur of the vote densities, ms
DENSITY_GAIN = 50.0  # vote densities are rescaled to ~per-iteration units
TPB_MIN, TPB_MAX = 20, 100  # plausible inter-beat ticks (10 ms steps), exclusive
BPM_WINDOW_MS = 200  # tick samples this close to a peak vote on its BPM
SNAP_MS = 60  # walker: prominence-weighted snap-to-peak radius
HALT_MS = 300  # walker: a confident off-grid peak this close halts the walk
REGION_MARGIN_MS = 200  # claimed-region margin around each walked span
TYPE_WINDOW_MS = 10  # half-width of the density mass used to type a beat
PEAK_KWARGS = dict(distance=50, prominence=0.1, rel_height=1, width=2, wlen=50)

_BEAT, _MEASURE, _TIMING_POINT = 0, 1, 2
_TYPE_CODE = {EventType.BEAT: _BEAT, EventType.MEASURE: _MEASURE, EventType.TIMING_POINT: _TIMING_POINT}
_CODE_TYPE = {v: k for k, v in _TYPE_CODE.items()}


def _window_mass(density: np.ndarray, time: int) -> float:
    """Density mass in ±TYPE_WINDOW_MS around ``time``.

    Uses a raw numpy slice on purpose: for ``time < TYPE_WINDOW_MS`` the
    negative start wraps and the slice is empty (mass 0) — a reference
    quirk that is part of the locked behavior."""
    return density[time - TYPE_WINDOW_MS : time + TYPE_WINDOW_MS].sum()


class SuperTimingGenerator:
    def __init__(self, args, engine, vocab):
        self.args = args
        self.preprocessor = Preprocessor(args, parallel=True)
        self.processor = Processor(args, engine, vocab, cfg_scale=args.timer_cfg_scale)
        self.processor.do_sample = False
        self.processor.parallel = True
        self.processor.num_beams = args.timer_num_beams
        self.processor.top_p = 1
        self.processor.top_k = 50
        self.processor.add_to_beatmap = False
        self.bpm_change_threshold = args.timer_bpm_threshold
        self.types_first = args.train.data.types_first
        self.iterations = args.timer_iterations

        self.sample_rate = args.train.model.spectrogram.sample_rate
        window_samples = (args.train.data.src_seq_len - 1) * args.train.model.spectrogram.hop_length
        self.miliseconds_per_sequence = window_samples * MS_PER_SECOND / self.sample_rate

    # -- entry --------------------------------------------------------------------

    def generate(self, audio, generation_config, verbose: bool = False):
        num_ms = len(audio) * MS_PER_SECOND // self.sample_rate
        offsets = self._draw_offsets()
        if verbose:
            print("Generating timing")
        streams = self._decode_iterations(audio, offsets, generation_config, verbose)
        return self._analyze(streams, offsets, num_ms)

    def _draw_offsets(self) -> list[int]:
        """One random audio offset per ensemble member, within ±half a window."""
        rng = np.random.default_rng(self.processor.seed)
        half_window = self.miliseconds_per_sequence // 2
        return [int(rng.integers(-half_window, half_window)) for _ in range(self.iterations)]

    # -- model passes (one pooled batch) ------------------------------------------

    def _decode_iterations(self, audio, offsets, generation_config, verbose: bool = False) -> list[list[Event]]:
        """Decode all ensemble members' windows in shared device batches.

        Returns, per iteration, the generated event list in that
        iteration's shifted time frame."""
        proc = self.processor
        out_context = [ContextType.MAP] if self.args.train.data.add_timing else [ContextType.TIMING]

        sessions = []
        for offset in offsets:
            head_pad = max(0, offset * self.sample_rate // MS_PER_SECOND)
            head_cut = max(0, -offset * self.sample_rate // MS_PER_SECOND)
            sequences = self.preprocessor.segment(audio[head_cut:], head_pad, 0)
            state = proc._prepare_generation(
                sequences=sequences,
                generation_config=generation_config,
                in_context=[ContextType.NONE],
                out_context=out_context,
                verbose=False,
            )
            sessions.append(proc.open_parallel_session(state))

        proc._reset_generation_stats()
        proc.run_parallel_sessions(sessions, verbose=verbose)
        return [proc._finalize_generation(state)[0][0] for state in sessions]

    # -- ensemble analysis ---------------------------------------------------------

    def _analyze(self, streams, offsets, num_ms):
        counts, tick_times, tick_values, span_lengths = self._accumulate(streams, offsets, num_ms)
        if tick_values.size == 0:
            return [], []

        densities = [gaussian_filter1d(c.astype(float), SMOOTH_SIGMA) / self.iterations * DENSITY_GAIN for c in counts]
        beat_density, measure_density, tp_density = densities

        peaks = self._localize_beats(beat_density + measure_density + 2 * tp_density, tick_times, tick_values)
        if peaks is None:
            return [], []

        beat_times = _BeatWalker(peaks, num_ms).run()
        beat_types = self._label_beats(beat_times, beat_density, measure_density, tp_density)
        self._repair_measures(beat_times, beat_types, measure_density, tp_density, span_lengths)
        return self._emit(beat_times, beat_types)

    def _accumulate(self, streams, offsets, num_ms):
        """Reduce per-iteration event streams to vote densities and samples.

        Returns (per-type count arrays, inter-beat tick sample times &
        values, beats-per-measure span lengths)."""
        counts = [np.zeros(num_ms, np.int64) for _ in range(3)]
        tick_times, tick_values, span_lengths = [], [], []

        for events, offset in zip(streams, offsets):
            groups, _ = get_groups(events, types_first=self.types_first)
            pairs = [(g.time - offset, _TYPE_CODE[g.event_type]) for g in groups if g.event_type in BEAT_TYPES]
            if not pairs:
                continue
            times = np.array([p[0] for p in pairs], np.int64)
            codes = np.array([p[1] for p in pairs], np.int64)
            in_range = (times >= 0) & (times < num_ms)
            times, codes = times[in_range], codes[in_range]
            if times.size == 0:
                continue

            for code in range(3):
                np.add.at(counts[code], times[codes == code], 1)

            # inter-beat tick samples between consecutive surviving groups;
            # a fresh timing point after a non-timing-point group starts a
            # new tempo and contributes no sample
            prev_t, next_t = times[:-1], times[1:]
            prev_c, next_c = codes[:-1], codes[1:]
            ticks = (next_t - prev_t) // MILLISECONDS_PER_STEP
            valid = (
                (next_t != prev_t)
                & ~((next_c == _TIMING_POINT) & (prev_c != _TIMING_POINT))
                & (ticks > TPB_MIN)
                & (ticks < TPB_MAX)
            )
            tick_times.append(prev_t[valid])
            tick_values.append(ticks[valid])

            # beats-per-measure: between consecutive measure anchors
            # (MEASURE or TIMING_POINT), when the later one is a MEASURE,
            # the span length = anchor distance in groups (all BEATs between)
            anchors = np.flatnonzero(codes != _BEAT)
            if anchors.size >= 2:
                first, second = anchors[:-1], anchors[1:]
                closes_measure = codes[second] == _MEASURE
                span_lengths.extend((second - first)[closes_measure].tolist())

        if tick_times:
            tick_times = np.concatenate(tick_times)
            tick_values = np.concatenate(tick_values)
            order = np.argsort(tick_times, kind="stable")
            tick_times, tick_values = tick_times[order], tick_values[order]
        else:
            tick_times = np.zeros(0, np.int64)
            tick_values = np.zeros(0, np.int64)
        return counts, tick_times, tick_values, span_lengths

    def _localize_beats(self, signal, tick_times, tick_values):
        """Peak-pick the combined vote density and assign each peak a BPM.

        Returns dict(times, prominences, bpms, confident) or None if the
        signal has no peaks."""
        peak_times, props = find_peaks(signal, **PEAK_KWARGS)
        if peak_times.size == 0:
            return None
        prominences = props["prominences"]

        # per-peak BPM vote: mode of the tick samples within ±BPM_WINDOW_MS,
        # accepted only when it dominates (> threshold of the local mass)
        lo = np.searchsorted(tick_times, peak_times - BPM_WINDOW_MS, side="right")
        hi = np.searchsorted(tick_times, peak_times + BPM_WINDOW_MS, side="left")
        # tick values run TPB_MIN+1 .. TPB_MAX-1; the top value shares a bin
        # with TPB_MAX-2 (a reference histogram-edge quirk)
        low_tick = TPB_MIN + 1
        n_bins = TPB_MAX - TPB_MIN - 2
        bpms = np.full(peak_times.shape, np.nan)
        for i in range(len(peak_times)):
            local = tick_values[lo[i] : hi[i]]
            votes = np.bincount(np.minimum(local - low_tick, n_bins - 1), minlength=n_bins)
            total = votes.sum()
            if total and votes.max() > self.bpm_change_threshold * total:
                bpms[i] = 60_000 / ((low_tick + int(votes.argmax())) * MILLISECONDS_PER_STEP)

        confident = ~np.isnan(bpms)

        # fold every peak BPM into the song's median tempo octave
        median_bpm = 60_000 / (np.median(tick_values) * MILLISECONDS_PER_STEP)
        with np.errstate(invalid="ignore", divide="ignore"):
            bpms = bpms / np.ceil(bpms / (median_bpm * 1.5))
            bpms = bpms * np.ceil((median_bpm / 1.5) / bpms)

        bpms = self._fill_bpm_gaps(bpms, median_bpm)
        return dict(times=peak_times, prominences=prominences, bpms=bpms, confident=confident)

    @staticmethod
    def _fill_bpm_gaps(bpms: np.ndarray, fallback: float) -> np.ndarray:
        """Fill NaN peaks: the leading run copies the first defined value,
        every later NaN copies its left neighbor (the reference fills
        in-place left-to-right with a ties-go-left rule, which reduces to
        exactly this back-fill + forward-fill)."""
        known = np.flatnonzero(~np.isnan(bpms))
        if known.size == 0:
            return np.full_like(bpms, fallback)
        if known.size == len(bpms):
            return bpms
        out = bpms.copy()
        out[: known[0]] = bpms[known[0]]
        source = np.where(~np.isnan(out), np.arange(len(out)), 0)
        np.maximum.accumulate(source, out=source)
        return out[source]

    def _label_beats(self, beat_times, beat_density, measure_density, tp_density):
        """Type each walked beat by the dominant vote density around it."""
        types = []
        for time in beat_times:
            beat = _window_mass(beat_density, time)
            measure = _window_mass(measure_density, time)
            tp = _window_mass(tp_density, time)
            if tp > beat and tp > measure and beat + measure + tp > 1:
                types.append(EventType.TIMING_POINT)
            else:
                types.append(EventType.BEAT)
        return types

    def _repair_measures(self, beat_times, beat_types, measure_density, tp_density, span_lengths):
        """Re-phase measure downbeats onto the estimated time signature.

        Walks the labeled grid keeping a cooldown: positive while inside a
        committed measure, negative while deferring to a better-phased
        downbeat ahead. Phase scores average the measure+timing-point mass
        at beats that are whole measures away. Mutates ``beat_types``."""
        signature = int(np.median(span_lengths)) if span_lengths else 4
        original_types = list(beat_types)
        cooldown = 0
        for i, labeled in enumerate(original_types):
            if cooldown > 0:
                cooldown -= 1
                continue
            if cooldown < 0:
                cooldown += 1
                if cooldown == 0 and labeled != EventType.TIMING_POINT:
                    beat_types[i] = EventType.MEASURE
                    cooldown = signature - 1
                continue
            if labeled == EventType.TIMING_POINT:
                continue

            phase_scores = []
            for phase in range(signature):
                mass, used = 0.0, 0
                for measure_step in range(-3, 4):
                    j = i + measure_step * signature + phase
                    if j < 0 or j >= len(beat_times):
                        continue
                    # reference quirk: the timing-point blocker checks
                    # absolute grid indices 1..|step|-1 (sign-mirrored), not
                    # indices relative to i — replicated for parity
                    step_sign = 1 if measure_step > 0 else -1
                    blockers = range(step_sign, measure_step, step_sign) if abs(measure_step) > 1 else ()
                    if any(beat_types[k] == EventType.TIMING_POINT for k in blockers):
                        continue
                    mass += _window_mass(measure_density, beat_times[j]) + _window_mass(tp_density, beat_times[j])
                    used += 1
                phase_scores.append(mass / used if used else 0.0)

            best_phase = int(np.argmax(phase_scores))
            if best_phase == 0:
                beat_types[i] = EventType.MEASURE
                cooldown = signature - 1
            else:
                beat_types[i] = EventType.BEAT
                cooldown = -best_phase

    def _emit(self, beat_times, beat_types):
        events, event_times = [], []
        for time, beat_type in zip(beat_times, beat_types):
            type_event = Event(beat_type)
            shift_event = Event(EventType.TIME_SHIFT, time)
            events.extend([type_event, shift_event] if self.types_first else [shift_event, type_event])
            event_times.extend([time, time])
        return events, event_times


class _BeatWalker:
    """Greedy bidirectional beat-grid layout from prominence-ranked peaks.

    Seeds at the strongest unclaimed peak and steps outward one period at
    a time, snapping to nearby peaks (error weighted by 1/prominence) and
    adopting their tempo. A confident peak that is close-but-not-snappable
    halts the walk (probable tempo boundary); walked spans claim a margin
    so weaker peaks inside them never seed."""

    def __init__(self, peaks: dict, num_ms: int):
        self.times = peaks["times"]
        self.prominences = peaks["prominences"]
        self.bpms = peaks["bpms"]
        self.confident = peaks["confident"]
        self.num_ms = num_ms
        self.pending = np.ones(len(self.times), bool)
        self.claimed: list[tuple[float, float]] = []
        self.beat_times: list[int] = []

    def run(self) -> list[int]:
        by_prominence = sorted(range(len(self.times)), key=lambda i: self.prominences[i], reverse=True)
        for seed in by_prominence:
            if not self.pending[seed]:
                continue
            self.pending[seed] = False
            self.beat_times.append(int(self.times[seed]))
            period = 60_000 / self.bpms[seed]
            self._walk(self.times[seed], period, +1)
            self._walk(self.times[seed], period, -1)
        return sorted(self.beat_times)

    def _claim(self, lo: float, hi: float) -> None:
        if lo > hi:
            lo, hi = hi, lo
        self.pending[(self.times >= lo) & (self.times <= hi)] = False

    def _walk(self, seed_time, period, direction) -> None:
        time = seed_time
        while True:
            previous = time
            time = time + direction * period
            if not (0 <= time < self.num_ms):
                self._claim(previous, time)
                break
            nearest = int(np.argmin(np.abs(self.times - time) / self.prominences))
            error = abs(self.times[nearest] - time) / self.prominences[nearest]
            if error < SNAP_MS:
                time = self.times[nearest]
                period = 60_000 / self.bpms[nearest]
            elif error < HALT_MS and self.confident[nearest]:
                time = time - direction * period
                break
            if any(lo <= time <= hi for lo, hi in self.claimed):
                break
            self.beat_times.append(int(time))

        if direction > 0:
            region = (seed_time - REGION_MARGIN_MS, time + REGION_MARGIN_MS)
        else:
            region = (time - REGION_MARGIN_MS, seed_time + REGION_MARGIN_MS)
        self.claimed.append(region)
        self._claim(*region)
