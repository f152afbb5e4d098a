"""Host-side audio loading: a copy of ``mapperatorinator_tpu/audio/io.py``.

The JAX module is numpy and scipy only, but its package's ``__init__``
imports the JAX mel front end, so the port carries its own copy
(``tests/test_torch_nojax.py`` holds it to its source). WAV decodes with the
stdlib; other containers go through an ffmpeg subprocess, and raise where
there is no ``ffmpeg`` binary. Output is mono float32 in [-1, 1], resampled
with ``scipy.signal.resample_poly`` (the speed frame-rate hack included) and
optionally peak-normalized.
"""

from __future__ import annotations

import math
import shutil
import subprocess
import wave
from pathlib import Path
from typing import Union

import numpy as np
from scipy.signal import resample_poly

MILLISECONDS_PER_SECOND = 1000


def _load_wav(path: Path) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate


def _load_ffmpeg(path: Path, sample_rate: int) -> tuple[np.ndarray, int]:
    if shutil.which("ffmpeg") is None:
        raise RuntimeError(
            f"cannot decode {path.suffix} audio: ffmpeg not available and file is not WAV"
        )
    cmd = [
        "ffmpeg", "-v", "error", "-i", str(path),
        "-f", "f32le", "-ac", "1", "-ar", str(sample_rate), "-",
    ]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.float32).copy(), sample_rate


def load_audio_file(
    path: Union[str, Path],
    sample_rate: int,
    speed: float = 1.0,
    normalize: bool = False,
) -> np.ndarray:
    """Decode audio to mono float32 at ``sample_rate``.

    ``speed`` applies the reference's frame-rate hack: samples are
    reinterpreted at ``rate*speed`` then resampled back, shortening the audio
    by ``speed`` without pitch correction (data_utils.py:88-103).
    """
    path = Path(path)
    if path.suffix.lower() == ".wav":
        samples, rate = _load_wav(path)
    else:
        samples, rate = _load_ffmpeg(path, sample_rate)

    effective_rate = rate * speed
    if effective_rate != sample_rate:
        up, down = _resample_ratio(sample_rate, effective_rate)
        samples = resample_poly(samples, up, down).astype(np.float32)

    if normalize and len(samples) > 0:
        peak = float(np.max(np.abs(samples)))
        if peak > 0:
            samples = samples / peak

    return samples.astype(np.float32)


def resample_and_speed(samples: np.ndarray, rate: int, sample_rate: int, speed: float = 1.0) -> np.ndarray:
    """Resample decoded samples to ``sample_rate`` applying the frame-rate
    speed hack (see :func:`load_audio_file`)."""
    effective_rate = rate * speed
    if effective_rate != sample_rate:
        up, down = _resample_ratio(sample_rate, effective_rate)
        samples = resample_poly(samples, up, down)
    return samples.astype(np.float32)


def decode_audio_bytes(raw: bytes, sample_rate: int, speed: float = 1.0) -> np.ndarray:
    """Decode an in-memory audio container (opus/mp3/ogg/wav bytes) to mono
    float32 at ``sample_rate`` via a temp file (web-dataset rows embed audio
    as bytes; reference decodes via the datasets Audio feature)."""
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".audio") as tmp:
        tmp.write(raw)
        tmp.flush()
        path = Path(tmp.name)
        try:
            samples, rate = _load_wav(path)
        except Exception:
            samples, rate = _load_ffmpeg(path, sample_rate)
    return resample_and_speed(samples, rate, sample_rate, speed)


def _resample_ratio(target: float, source: float) -> tuple[int, int]:
    """Small integer up/down factors for resample_poly."""
    from fractions import Fraction

    frac = Fraction(target / source).limit_denominator(10000)
    return frac.numerator, frac.denominator


def get_song_length_ms(samples: np.ndarray, sample_rate: int) -> float:
    return len(samples) / sample_rate * MILLISECONDS_PER_SECOND
