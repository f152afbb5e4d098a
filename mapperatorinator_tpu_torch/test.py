"""Held-out model-quality eval harness on the port (the repo's ``test.py``).

Teacher-forced metrics over the test split with the reference's analysis
axes: per-context loss/accuracy stats, the timing-precision histogram
(pred-label offset in 10 ms steps over ±3), accuracy binned by window
position (100 bins over the audio window), and timing accuracy binned by
rhythm complexity (the rcomplexion sample weights). The analysis prints
tables and writes ``test_results.json`` in the working directory, with the
keys the JAX harness writes.

    python -m mapperatorinator_tpu_torch.test -cn v32 checkpoint_path=CKPT [overrides...] [device=cpu]

Two passes run: ``test_noise`` with the configured timing augmentation and
``test`` with ``timing_random_offset`` zeroed. The checkpoint is a native
or published one (:func:`.models.io.load_checkpoint`); its model runs on
the card unless ``device=cpu`` is given, and every attention call of its
forwards takes kernel B there (and the mel kernel A where its config
selects ``spectrogram.implementation=pallas``). The batches come from
:func:`.train.main.make_batch_factory`, so no second model is built.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from .config import load_train_config, parse_argv, select_device
from .models.io import load_checkpoint
from .osu import BeatmapParser, build_vocabulary
from .osu.events import ContextType, EventType
from .osu.vocab import MILLISECONDS_PER_STEP
from .train.loop import Averager, acc_range, add_prefix, fuzzy_acc_range, get_stats
from .train.main import make_batch_factory
from .train.step import make_eval_step

N_TIME_BINS = 100
MAX_RHYTHM_COMPLEXITY = 4.0
N_RHYTHM_BINS = 20
PRECISION_BIN_RANGE = 3
LABEL_IGNORE_ID = -100


def _label_times(labels: np.ndarray, ts_start: int, ts_end: int, ts_min: int) -> np.ndarray:
    """Per-position window time (ms): the last TIME_SHIFT value seen so far
    (reference: test.py:119-127), vectorized as a forward fill."""
    in_range = (labels >= ts_start) & (labels < ts_end)
    values = np.where(in_range, (labels - ts_start + ts_min) * MILLISECONDS_PER_STEP, 0)
    idx = np.where(in_range, np.arange(labels.shape[1])[None, :], 0)
    last = np.maximum.accumulate(idx, axis=1)
    return np.take_along_axis(values, last, axis=1).astype(np.float32)


class Analysis:
    """Accumulators for one prefix (context-type slice)."""

    def __init__(self, max_window_ms: float):
        self.time_bins = np.linspace(0, max_window_ms, N_TIME_BINS + 1)[1:]
        self.bin_totals = np.zeros(N_TIME_BINS)
        self.bin_counts = np.zeros(N_TIME_BINS)
        self.rhythm_bins = np.linspace(0, MAX_RHYTHM_COMPLEXITY, N_RHYTHM_BINS + 1)[1:]
        self.rhythm_totals = np.zeros(N_RHYTHM_BINS)
        self.rhythm_counts = np.zeros(N_RHYTHM_BINS)
        self.fuzzy_rhythm_totals = np.zeros(N_RHYTHM_BINS)
        self.precision_bins = np.arange(-PRECISION_BIN_RANGE, PRECISION_BIN_RANGE + 1)
        self.precision_totals = np.zeros(2 * PRECISION_BIN_RANGE + 1)
        self.precision_counts = np.zeros(2 * PRECISION_BIN_RANGE + 1)

    def update(self, preds, labels, vocab, rhythm_complexity=None):

        ts_start = vocab.event_start[EventType.TIME_SHIFT]
        ts_end = vocab.event_end[EventType.TIME_SHIFT]
        ts_min = vocab.event_range[EventType.TIME_SHIFT].min_value

        # timing precision: distribution of (pred - label) over TIME_SHIFTs
        index = (labels >= ts_start) & (labels < ts_end)
        diffs = (preds[index] - labels[index]).astype(np.int64)
        for i, offset in enumerate(self.precision_bins):
            self.precision_totals[i] += np.sum(diffs == offset)
            self.precision_counts[i] += diffs.size

        # accuracy binned by window position
        times = _label_times(labels, ts_start, ts_end, ts_min)
        binned = np.digitize(times, self.time_bins)
        valid = (labels != LABEL_IGNORE_ID) & (labels != vocab.eos_id)
        for i in range(N_TIME_BINS):
            sel = (binned == i) & valid
            self.bin_totals[i] += np.sum(preds[sel] == labels[sel])
            self.bin_counts[i] += np.sum(sel)

        # timing accuracy binned by rhythm complexity
        if rhythm_complexity is not None:
            sample_bins = np.clip(
                np.digitize(rhythm_complexity, self.rhythm_bins), 0, N_RHYTHM_BINS - 1
            )
            for row in range(len(rhythm_complexity)):
                sample = acc_range(preds[row], labels[row], ts_start, ts_end)
                fuzzy = fuzzy_acc_range(preds[row], labels[row], ts_start, ts_end, 2)
                b = sample_bins[row]
                self.rhythm_totals[b] += np.sum(sample)
                self.rhythm_counts[b] += len(sample)
                self.fuzzy_rhythm_totals[b] += np.sum(fuzzy)

    def tables(self) -> dict:
        def ratio(totals, counts):
            with np.errstate(invalid="ignore", divide="ignore"):
                return np.where(counts > 0, totals / counts, np.nan)

        return {
            "timing_precision": {
                "offset_steps": self.precision_bins.tolist(),
                "acc": ratio(self.precision_totals, self.precision_counts).tolist(),
            },
            "acc_over_time": {
                "bin_time_ms": self.time_bins.tolist(),
                "acc": ratio(self.bin_totals, self.bin_counts).tolist(),
            },
            "timing_acc_over_rhythm_complexity": {
                "rhythm_complexity": self.rhythm_bins.tolist(),
                "acc": ratio(self.rhythm_totals, self.rhythm_counts).tolist(),
                "fuzzy_acc": ratio(self.fuzzy_rhythm_totals, self.rhythm_counts).tolist(),
            },
        }


def run_test(args, model, vocab, prefix: str, max_steps=None) -> dict:
    """One analysis pass over the test split (the JAX ``run_test``):
    ``model`` (on its device) teacher-forced on at most ``eval.steps *
    optim.grad_acc`` batches (or ``max_steps``) of the split that ``args``
    configures, the stats per context type averaged, the analysis tables
    accumulated. The batches come from the configured vocabulary, the
    metrics read ``vocab`` (the checkpoint's), as in JAX."""
    data_vocab = build_vocabulary(args)
    make_batches = make_batch_factory(args, BeatmapParser(args, data_vocab), data_vocab)
    eval_step = make_eval_step()

    max_window_ms = (
        1000 * args.data.src_seq_len * args.model.spectrogram.hop_length
        / args.model.spectrogram.sample_rate
    )
    averager = Averager()
    analyses: dict[str, Analysis] = {}

    all_in_contexts: set = set()
    for cts in args.data.context_types:
        if isinstance(cts, (str, ContextType)):
            all_in_contexts.add(ContextType(cts) if isinstance(cts, str) else cts)
        else:
            all_in_contexts.update(cts["in"])

    start_time = time.time()
    limit = max_steps if max_steps is not None else args.eval.steps * args.optim.grad_acc
    for batch_id, batch in enumerate(make_batches(test=True), start=1):
        if batch_id > limit:
            break
        rhythm_complexity = np.asarray(batch["sample_weights"]) if "sample_weights" in batch else None
        loss, logits = eval_step(model, batch)
        preds = logits.argmax(-1).cpu().numpy()
        labels = np.asarray(batch["labels"])

        def gather(loss_value, ct_preds, ct_labels, ct_rhythm, ct_prefix=""):
            stats = add_prefix(ct_prefix, get_stats(loss_value, ct_preds, ct_labels, vocab, args))
            averager.update(stats)
            analysis = analyses.setdefault(ct_prefix, Analysis(max_window_ms))
            analysis.update(ct_preds, ct_labels, vocab, ct_rhythm)

        if len(args.data.context_types) > 0:
            ids = np.asarray(batch["decoder_input_ids"])
            for cts in args.data.context_types:
                if isinstance(cts, (str, ContextType)):
                    cts = {"out": [ContextType.MAP],
                           "in": [ContextType(cts) if isinstance(cts, str) else cts]}
                ct_index = np.ones(ids.shape[0], bool)
                for c in cts["in"]:
                    ct_index &= (ids == vocab.context_sos[c]).any(axis=1)
                for c in all_in_contexts - set(cts["in"]):
                    ct_index &= ~(ids == vocab.context_sos[c]).any(axis=1)
                if not ct_index.any():
                    continue
                gather(
                    float(loss), preds[ct_index], labels[ct_index],
                    rhythm_complexity[ct_index] if rhythm_complexity is not None else None,
                    "+".join(c.value for c in cts["in"]),
                )
        else:
            gather(float(loss), preds, labels, rhythm_complexity)

    stats = averager.average()
    stats["time"] = time.time() - start_time
    return {
        "stats": add_prefix(prefix, stats),
        "analysis": {p: a.tables() for p, a in analyses.items()},
    }


def print_report(result: dict) -> None:
    print(json.dumps(result["stats"], indent=1, default=float))
    for ct_prefix, tables in result["analysis"].items():
        label = ct_prefix or "(all)"
        tp = tables["timing_precision"]
        print(f"\n[{label}] timing precision (offset in {MILLISECONDS_PER_STEP} ms steps):")
        for off, acc in zip(tp["offset_steps"], tp["acc"]):
            bar = "#" * int(0 if acc is None or np.isnan(acc) else acc * 60)
            print(f"  {off:+d}: {0.0 if acc is None or np.isnan(acc) else acc:6.3f} {bar}")
        at = tables["acc_over_time"]
        accs = np.asarray(at["acc"], dtype=float)
        if np.isfinite(accs).any():
            head = np.nanmean(accs[: N_TIME_BINS // 4])
            tail = np.nanmean(accs[-N_TIME_BINS // 4:])
            print(f"[{label}] acc over window position: first-quarter {head:.3f}, last-quarter {tail:.3f}")


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "v32", {})
    args = load_train_config(config_name, overrides)
    device = select_device(args)

    model, vocab = load_checkpoint(args.checkpoint_path)
    model = model.to(device).eval()
    if vocab is None:
        vocab = build_vocabulary(args)

    results = {}
    # pass 1: with the configured timing augmentation noise
    results["test_noise"] = run_test(args, model, vocab, "test_noise")
    # pass 2: clean timing (reference: test.py:252-256)
    args.data.timing_random_offset = 0
    if hasattr(args.data, "timing_random_offset_2"):
        args.data.timing_random_offset_2 = 0
    results["test"] = run_test(args, model, vocab, "test")

    for result in results.values():
        print_report(result)

    out_path = Path("test_results.json")
    out_path.write_text(json.dumps(results, indent=1, default=float))
    print(f"\nwrote {out_path.resolve()}")
    return results


if __name__ == "__main__":
    main()
