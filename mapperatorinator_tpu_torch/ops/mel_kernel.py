"""Fused mel spectrogram: the CUDA kernel and its plain PyTorch versions.

Replaces ``mapperatorinator_tpu/ops/mel_kernel.py`` (``_mel_kernel`` via
``fused_mel``): frames times the window-folded DFT matrices, power spectrum,
filterbank projection and optional ``log1p``, all at fp32 accuracy. The
kernel (``csrc/fused_mel.cu``) runs every product on the tensor cores as
three TF32 products of split operands (:func:`mel_plain_tf32x3` rounds as it
does), reads each tile's frames once from the signal they overlap in, and
splits the frequency bins across the blocks of a thread-block cluster as
:func:`mel_plan` says; its header says what bounds it on the H100.
:func:`fused_mel` runs the plain version for a tensor on the CPU and the
kernel for a tensor on a CUDA device; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, launches
from .attention_kernel import tf32_split

MEL_TM = 64  # frames a tile (csrc/fused_mel.cu TM)
MEL_SLICE = 80  # bins a block at most (csrc/fused_mel.cu SLICE)
MEL_MAX_CLUSTER = 8  # blocks a cluster at most: the portable size (csrc/fused_mel.cu MAX_CLUSTER)
MEL_MAX_SMEM = 232448  # bytes of shared memory a block may have on an H100

# frames, w_re, w_im, fbanks, out; batch, n_frames, s_batch, s_frame, n_fft,
# n_freqs, n_mels, log_scale, and the plan's cluster and nb; the stream
_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


class MelPlan(NamedTuple):
    """How the kernel splits its work: tiles of ``tm`` frames of one batch
    item; the bins in ``cluster`` slices of ``nb``, slice r holding bins
    [r nb, min(n_freqs, (r + 1) nb)), one a block of a thread-block cluster."""

    tm: int
    cluster: int
    nb: int

    def blocks(self, rows: int) -> int:
        """Blocks for ``rows`` frames of one batch item."""
        return self.cluster * _ceil_div(rows, self.tm)


@functools.cache
def mel_plan(rows: int, n_freqs: int, n_mels: int) -> MelPlan:
    """The kernel's split of ``rows`` frames (of one batch item) by
    ``n_freqs`` bins, projected onto ``n_mels`` mels: the fewest slices of at
    most ``MEL_SLICE`` bins that cover ``n_freqs``, each a multiple of 8
    (an mma tile is 4 bins' re and im), as even as that allows and none
    empty. A block computes all ``MEL_SLICE`` bins whatever its slice holds,
    so more, narrower slices would add blocks and no speed. At v32's 513 bins:
    7 slices of 80, 224 blocks for a 2048-frame window, which an H100 runs
    in one wave at two blocks an SM. The plan does not depend on the row or
    mel count."""
    if rows < 1 or n_mels < 1 or not 1 <= n_freqs <= MEL_MAX_CLUSTER * MEL_SLICE:
        raise ValueError(f"mel_plan: rows {rows} and n_mels {n_mels} must be positive and n_freqs {n_freqs} "
                         f"1 to {MEL_MAX_CLUSTER * MEL_SLICE}")
    cluster = _ceil_div(n_freqs, MEL_SLICE)
    nb = 8 * _ceil_div(_ceil_div(n_freqs, 8), cluster)
    return MelPlan(MEL_TM, _ceil_div(n_freqs, nb), nb)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def mel_plain(frames, w_re, w_im, fbanks, log_scale: bool = False) -> torch.Tensor:
    """frames (..., n_frames, n_fft) -> (..., n_frames, n_mels), in fp32."""
    frames = frames.float()
    re = frames @ w_re
    im = frames @ w_im
    mel = (re * re + im * im) @ fbanks
    return torch.log1p(mel) if log_scale else mel


def _matmul_3tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three TF32 products of the split operands, the big one
    hi·hi' plus the small ones (hi·lo' + lo·hi'), all summed in fp32."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def mel_plain_tf32x3(frames, w_re, w_im, fbanks, log_scale: bool = False) -> torch.Tensor:
    """What the kernel computes, rounding where it rounds: :func:`mel_plain`
    with each of its three products taken as three TF32 products of split
    operands (:func:`~.attention_kernel.tf32_split`)."""
    frames = frames.float()
    re = _matmul_3tf32(frames, w_re)
    im = _matmul_3tf32(frames, w_im)
    mel = _matmul_3tf32(re * re + im * im, fbanks)
    return torch.log1p(mel) if log_scale else mel


@functools.cache
def _smem_bytes(s_frame: int, n_fft: int) -> int:
    """The kernel's shared memory for a frame stride and n_fft, from the
    library (-1 where the stride is not a multiple of 16)."""
    fn = _build.function("fused_mel", "fused_mel_smem_bytes", (ctypes.c_longlong, ctypes.c_int), ctypes.c_longlong)
    return fn(s_frame, n_fft)


def _check(frames, w_re, w_im, fbanks) -> tuple[int, int, int, int, int]:
    """(batch, n_frames, n_fft, n_freqs, n_mels) of operands the kernel
    takes; anything else raises."""
    if frames.dim() != 3 or frames.dtype != torch.float32 or frames.stride(2) != 1:
        raise ValueError(
            f"fused_mel: fp32 (B, n_frames, n_fft) frames with unit last stride, got "
            f"{frames.dtype} {tuple(frames.shape)} strides {frames.stride()}"
        )
    b, n_frames, n_fft = frames.shape
    n_freqs, n_mels = fbanks.shape
    for name, m, shape in (("w_re", w_re, (n_fft, n_freqs)), ("w_im", w_im, (n_fft, n_freqs)),
                           ("fbanks", fbanks, (n_freqs, n_mels))):
        if m.shape != shape or m.dtype != torch.float32 or not m.is_contiguous() or m.device != frames.device:
            raise ValueError(f"fused_mel: {name} must be contiguous fp32 {shape} on {frames.device}")
    if b == 0 or n_frames == 0 or n_fft == 0 or n_mels == 0:
        raise ValueError(f"fused_mel: empty frames {tuple(frames.shape)} or filterbank {tuple(fbanks.shape)}")
    if n_freqs > MEL_MAX_CLUSTER * MEL_SLICE:
        raise ValueError(f"fused_mel: at most {MEL_MAX_CLUSTER * MEL_SLICE} frequency bins "
                         f"({MEL_MAX_CLUSTER} slices of {MEL_SLICE}), got {n_freqs}")
    need = _smem_bytes(frames.stride(1), n_fft)
    if need < 0:
        raise ValueError(f"fused_mel: the frame stride must be a multiple of 16 floats, got {frames.stride(1)}")
    if need > MEL_MAX_SMEM:
        raise ValueError(
            f"fused_mel: the samples that a tile of {MEL_TM} frames spans at frame stride {frames.stride(1)} and "
            f"n_fft {n_fft} need {need} bytes of shared memory, more than the {MEL_MAX_SMEM} a block has"
        )
    return b, n_frames, n_fft, n_freqs, n_mels


def fused_mel(frames, w_re, w_im, fbanks, log_scale: bool = False) -> torch.Tensor:
    """Same contract as :func:`mel_plain`. On a CUDA tensor: kernel A, which
    takes fp32 frames of shape (B, n_frames, n_fft) with a unit stride along
    n_fft and a frame stride that is a multiple of 16 (a strided view into the
    padded signal is read in place; the span a tile's frames cover must fit
    in shared memory), contiguous fp32 matrices, and at most 640 bins;
    anything else raises. ``fused_mel.launches`` counts kernel launches."""
    if frames.device.type == "cpu":
        return mel_plain(frames, w_re, w_im, fbanks, log_scale)
    b, n_frames, n_fft, n_freqs, n_mels = _check(frames, w_re, w_im, fbanks)
    plan = mel_plan(n_frames, n_freqs, n_mels)
    out = frames.new_empty((b, n_frames, n_mels))
    fn = _build.function("fused_mel", "fused_mel_fwd", _ARGTYPES)
    err = fn(frames.data_ptr(), w_re.data_ptr(), w_im.data_ptr(), fbanks.data_ptr(), out.data_ptr(),
             b, n_frames, frames.stride(0), frames.stride(1), n_fft, n_freqs, n_mels, int(log_scale),
             plan.cluster, plan.nb, torch._C._cuda_getCurrentRawStream(frames.device.index))
    _build.check(fn.lib, err, "fused_mel")
    launches.count(fused_mel, "launches")
    return out


fused_mel.launches = 0
