"""Shared pad-to-batch apply loop for feature-extraction passes.

Both the classifier FID extractor (calc_fid.py) and the CM3P extractor
(models/cm3p.py) walk a list of per-window example dicts, chunk them by
batch size, pad the trailing chunk by repeating its last row (so every
chunk hits the same compiled program), apply a model, and slice the pad
rows back off. One implementation, so boundary fixes reach both.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

__all__ = ["batched_apply"]


def batched_apply(
    examples: Sequence[dict],
    batch_size: int,
    apply_fn: Callable[[dict], np.ndarray],
) -> np.ndarray:
    """Run ``apply_fn`` over ``examples`` in fixed-size batches.

    ``examples``: per-window dicts of equal-keyed arrays with a leading
    batch axis of 1. ``apply_fn`` receives the concatenated batch dict
    (always exactly ``batch_size`` rows — the trailing chunk is padded by
    repeating its last row so compiles are reused) and returns a (B, F)
    array; pad rows are sliced off. Returns (N, F), or (0, 1) when empty.
    """
    features = []
    for start in range(0, len(examples), batch_size):
        chunk = examples[start : start + batch_size]
        n = len(chunk)
        batch = {k: np.concatenate([e[k] for e in chunk]) for k in chunk[0]}
        if n < batch_size:
            pad = batch_size - n
            batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in batch.items()}
        out = np.asarray(apply_fn(batch))
        features.append(out[:n])
    return np.concatenate(features) if features else np.zeros((0, 1))
