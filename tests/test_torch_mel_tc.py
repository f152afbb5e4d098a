"""Kernel A's tensor-core design (split-TF32 products, bins split across a
thread-block cluster) on the CPU: its rounding-faithful plain version against
the JAX package, its plan, and the work ``chip_smoke.py`` bounds it by.

* ``mel_plain_tf32x3`` (each product as three TF32 products of split
  operands) against the JAX ``fused_mel`` run in Pallas interpret mode, and
  against the JAX rfft path (``Precision.HIGHEST``), at the reference's bar
  (test_audio.py:80);
* at one v32 window (2048 frames, 1024 -> 513 -> 128, log1p, the seeded audio
  of ``chip_smoke.py``'s ``check_mel``) ``mel_plain_tf32x3`` within 1e-4 of
  ``mel_plain``, the bar the kernel is held to on the card;
* ``mel_plan``: a cluster of at most 8, slices of at most 80 bins (a
  multiple of 8) that cover the bins with none empty, and at least one block
  for each of the H100's 132 SMs at one window, at two (CFG) and at an odd
  row count; its limits are those ``csrc/fused_mel.cu`` takes;
* ``fused_mel`` on a CPU tensor is ``mel_plain``.

The kernel itself is held against both plain versions on a card by
``tests/test_torch_kernels.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.audio.mel import MelSpectrogram as JaxMelSpectrogram
from mapperatorinator_tpu.audio.mel import _dft_matrices
from mapperatorinator_tpu.ops.mel_kernel import fused_mel as jax_fused_mel
from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
from mapperatorinator_tpu_torch.ops.mel_kernel import (
    MEL_MAX_CLUSTER,
    MEL_SLICE,
    MEL_TM,
    fused_mel,
    mel_plain,
    mel_plain_tf32x3,
    mel_plan,
)
from tests.test_torch_qmm_tc import chip_smoke

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
MEL_CU = REPO / "mapperatorinator_tpu_torch" / "csrc" / "fused_mel.cu"
SMS = 132  # the H100 SXM's streaming multiprocessors
KW = dict(sample_rate=16000, n_fft=1024, hop_length=128, n_mels=128, f_min=20, f_max=8000)
MEL_TOL = 5e-3  # test_audio.py:80
MEL_TC_TOL = 1e-4  # the kernel against its plain versions on the card (tests/test_torch_kernels.py)


def window(batch: int, n_frames: int = 2048) -> np.ndarray:
    """``chip_smoke.py``'s seeded audio: a 440 Hz tone and noise, ``n_frames``
    frames' worth of 128-sample hops."""
    n = (n_frames - 1) * 128
    t = np.arange(n) / 16000
    rng = np.random.default_rng(0)
    return (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal((batch, n))).astype(np.float32)


def frames_of(audio: np.ndarray, n_frames: int) -> np.ndarray:
    """Reflect-padded frames of 1024 samples at hop 128, as both packages frame them."""
    padded = np.pad(audio, ((0, 0), (512, 512)), mode="reflect")
    return np.stack([padded[:, i * 128: i * 128 + 1024] for i in range(n_frames)], axis=1)


def test_mel_plain_tf32x3_matches_jax_interpret_and_rfft():
    """64 frames, as test_audio.py:60-80: the port's split-TF32 plain version
    against the Pallas kernel in interpret mode and the rfft path."""
    audio = window(2, 64)
    frames = frames_of(audio, 64)
    jm = JaxMelSpectrogram("xla", True, pad_mode="reflect", **KW)
    w_re, w_im = _dft_matrices(1024, jm.window)
    want_pallas = np.asarray(jax_fused_mel(jnp.asarray(frames), jnp.asarray(w_re), jnp.asarray(w_im),
                                           jnp.asarray(jm.fbanks), True, tile_frames=64, interpret=True))
    want_rfft = np.asarray(jm(jnp.asarray(audio)))
    got = mel_plain_tf32x3(torch.from_numpy(frames), torch.from_numpy(w_re), torch.from_numpy(w_im),
                           torch.from_numpy(np.asarray(jm.fbanks)), True).numpy()
    assert got.shape == want_pallas.shape == want_rfft.shape == (2, 64, 128)
    np.testing.assert_allclose(got, want_pallas, rtol=MEL_TOL, atol=MEL_TOL)
    np.testing.assert_allclose(got, want_rfft, rtol=MEL_TOL, atol=MEL_TOL)


def test_mel_plain_tf32x3_is_fp32_grade_at_a_v32_window():
    """One v32 window through the port's front end matrices: the plain
    version that rounds as the kernel does lies within the kernel's card bar
    of the fp32 one (one TF32 product instead would miss it)."""
    mel = MelSpectrogram("pallas", True, pad_mode="reflect", **KW)
    frames = torch.from_numpy(frames_of(window(1), 2048))
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    got, want = mel_plain_tf32x3(frames, *args), mel_plain(frames, *args)
    assert got.shape == (1, 2048, 128)
    torch.testing.assert_close(got, want, rtol=MEL_TC_TOL, atol=MEL_TC_TOL)


@pytest.mark.parametrize("rows,n_freqs,n_mels", [
    (2048, 513, 128),  # one v32 window
    (4096, 513, 128),  # two (CFG, batch 2)
    (2047, 513, 128),  # an odd row count: the last tile is short
    (2048, 513, 388),  # the default MelSpectrogram's mels
    (2048, 201, 80),   # n_fft 400
    (64, 129, 40),     # n_fft 256
    (300, 640, 128),   # the most bins the kernel takes
    (1, 1, 1),
])
def test_mel_plan_covers_the_bins(rows, n_freqs, n_mels):
    plan = mel_plan(rows, n_freqs, n_mels)
    assert plan.tm == MEL_TM and 1 <= plan.cluster <= MEL_MAX_CLUSTER
    assert plan.nb % 8 == 0 and 8 <= plan.nb <= MEL_SLICE
    # slice r holds bins [r nb, min(n_freqs, (r + 1) nb)), as csrc/fused_mel.cu reads them
    slices = [(r * plan.nb, min(n_freqs, (r + 1) * plan.nb)) for r in range(plan.cluster)]
    assert slices[0][0] == 0 and slices[-1][1] == n_freqs
    assert all(lo < hi for lo, hi in slices)  # none empty
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # no gap, no overlap
    assert (plan.blocks(rows) // plan.cluster - 1) * plan.tm < rows <= plan.blocks(rows) // plan.cluster * plan.tm


@pytest.mark.parametrize("rows", [2048, 4096, 2047])
def test_mel_plan_fills_the_card_at_v32_windows(rows):
    """At least one block for each SM at one window, two (CFG) and an odd row count."""
    plan = mel_plan(rows, 513, 128)
    assert plan.blocks(rows) >= SMS, plan
    assert plan.cluster == 7 and plan.nb == 80  # 7 slices of 80 cover 513 bins


def test_mel_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n_freqs"):
        mel_plan(2048, MEL_MAX_CLUSTER * MEL_SLICE + 1, 128)
    with pytest.raises(ValueError, match="rows"):
        mel_plan(0, 513, 128)


def test_plan_limits_match_the_kernel_source():
    """The wrapper's tile, slice and cluster limits are the kernel's."""
    src = MEL_CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("TM"), const("SLICE"), const("MAX_CLUSTER")) == (MEL_TM, MEL_SLICE, MEL_MAX_CLUSTER)
    assert re.search(r"__global__ void __launch_bounds__\(THREADS, 2\) fused_mel_kernel", src)


def test_fused_mel_on_the_cpu_is_the_plain_version():
    mel = MelSpectrogram("pallas", False, pad_mode="reflect", **KW)
    frames = torch.from_numpy(frames_of(window(1, 70), 70))
    args = (mel.w_re, mel.w_im, mel.fbanks, False)
    assert torch.equal(fused_mel(frames, *args), mel_plain(frames, *args))


def test_chip_smoke_counts_the_mel_work():
    """The operations and bytes ``chip_smoke.py`` bounds a window's call by:
    the DFT products and the projection, the padded signal, W and the
    filterbank read once, the mels written once; 4.57 GFLOP at one window."""
    flops, nbytes = chip_smoke().mel_work(1, 2048, 1024, 513, 128, 2047 * 128 + 1024)
    assert flops == 2.0 * 2048 * 1024 * 513 * 2 + 2.0 * 2048 * 513 * 128
    assert round(flops / 1e9, 2) == 4.57
    assert nbytes == 4.0 * (2047 * 128 + 1024 + 2 * 1024 * 513 + 513 * 128 + 2048 * 128)
