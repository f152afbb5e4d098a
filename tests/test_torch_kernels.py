"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips elsewhere (the kernels have no
CPU mode; the plain versions are held against the JAX package by
test_torch_attention.py, test_torch_attention_tc.py, test_torch_mel.py,
test_torch_mel_tc.py, test_torch_qmm.py and test_torch_qmm_tc.py).
Attention is checked on both routes: the fp32 kernels (split-TF32 products, against both the plain
versions that round as they do and the fp32 ones, at D 32, 64 and 128) and
the bf16 pair (D 64), both routes at moonshine's head dims 36 and 52
(padded to the widths the kernels take), and the fp32 forward as the DiT calls it (the band
as ``window`` 256, a key mask over a bucket's padding) and one DiT-B block
through it, and both routes unscaled (``sm_scale`` 1.0) at T5-base's cross
attention, and the fp32 forward at the mapper classifier's and CM3P's calls
(windows of pads only included) and through a small classifier, and the
fp32 backward at DiT-B's and the classifier's training calls (a window of
pads' dq and dk exactly 0) and through a DiT training step, and the bf16
pair under autograd at the backbone families' training calls (T5's cross
attention and an nGPT decoder at ``sm_scale`` 1.0, moonshine's D 36 padded
to 64, causal under a key mask with an empty row); qmm on
both of its paths (also at T5-base's products) (its GEMV path also for
bit-equal repeats and a refused launch); the fused mel against both its
plain versions (the split-TF32 one and fp32), for bit-equal repeats, and
on the frame layouts it takes and refuses. CUDA graphs: the GEMV captured
and replayed, its counters counting the replays; a tiny engine's graphed
``generate`` against its eager one; the sampler's noise against
``torch.multinomial``. The file imports only
torch and the port, so it runs where the JAX package's test helpers do not:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""

import itertools

import pytest
import torch

from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
from mapperatorinator_tpu_torch.ops.attention_kernel import (
    attention_backward_plain,
    attention_backward_plain_bf16_tc,
    attention_backward_plain_fp32_tc,
    attention_plain,
    attention_plain_bf16_tc,
    attention_plain_fp32_tc,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_bwd_fp32,
    flash_bwd_sm90,
    flash_fwd_fp32,
    flash_fwd_sm90,
)
from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain, mel_plain_tf32x3
from mapperatorinator_tpu_torch.ops.qmm_kernel import GEMV_ROWS, qmm, qmm_kernel, qmm_plain, qmm_plain_tf32x2

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # fp32: test_attention_kernel.py:47
# the backward's bar is ATTN_TOL times the largest reference gradient (at
# least 1): gradients grow with the length, and dq is summed with atomics in
# an order that changes from run to run
MEL_TOL = 5e-3  # test_audio.py:80
# the mel kernel against its plain versions (the split-TF32 one and fp32):
# fp32 accuracy, the products' sums taken in another order
MEL_TC_TOL = 1e-4
# qmm: the reference's 1e-5 (test_qmm_kernel.py:30) in fp32, 2e-2 in bf16, each
# times the largest |reference output| (at least 1): the sums run in another order
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the tensor-core path against qmm_plain_tf32x2, which rounds as it does: in
# fp32 only the order of the sums differs (bf16: that plain version is
# qmm_plain, and the output's own rounding sets the bar)
QMM_TC_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}

CASES = [  # t, s, causal, window, key mask
    (64, 64, False, 0, "some"),
    (64, 64, True, 0, "some"),
    (64, 64, False, 16, "some"),
    (50, 70, False, 0, "some"),
    (64, 64, True, 16, "none"),
    (64, 64, False, 0, "all-in-row-0"),
    (1024, 1024, False, 128, "some"),
    (300, 1024, False, 0, "some"),
    (2048, 2048, False, 0, "none"),  # a v31 encoder window
    (1010, 1010, True, 0, "some"),  # MaiMod's teacher-forced v31 decoder: self, then cross
    (1010, 2048, False, 0, "none"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def launches():
    """(fp32 forward, fp32 backward, bf16 forward, bf16 backward)."""
    return flash_fwd_fp32.launches, flash_bwd_fp32.launches, flash_fwd_sm90.launches, flash_bwd_sm90.launches


def route_step(dtype, fwd=1, bwd=0):
    """What one call at D 64 adds to :func:`launches`: fp32 runs the fp32
    pair, bf16 the tensor-core pair."""
    return {torch.float32: (fwd, bwd, 0, 0), torch.bfloat16: (0, 0, fwd, bwd)}[dtype]


def added(before, step):
    return tuple(b + s for b, s in zip(before, step))


def attention_inputs(device, t, s, masked, dtype, d=64, h=2):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, n, h, d), generator=gen).to(device, dtype) for n in (t, s, s))
    kvm = None
    if masked != "none":
        kvm = (torch.rand((2, s), generator=gen) > 0.2).to(device)
        if masked == "all-in-row-0":
            kvm[0] = False
    return q, k, v, kvm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, t, s, causal, window, masked):
    q, k, v, kvm = attention_inputs(cuda, t, s, masked, dtype)
    before = launches()
    got = flash_attention(q, k, v, kvm, causal=causal, window=window)
    assert launches() == added(before, route_step(dtype))
    want = attention_plain(q, k, v, kvm, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=ATTN_TOL[dtype])


def grad_tol(dtype, *want) -> float:
    return ATTN_TOL[dtype] * max(1.0, max(w.float().abs().max().item() for w in want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_flash_attention_backward_kernel_matches_plain(cuda, dtype, t, s, causal, window, masked):
    q, k, v, kvm = attention_inputs(cuda, t, s, masked, dtype)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    scale = q.shape[-1] ** -0.5
    out, lse = flash_attention_fwd(q, k, v, kvm, causal, window, scale, with_lse=True)
    assert lse.shape == (2, 2, t) and lse.dtype == torch.float32
    before = launches()
    got = flash_attention_bwd(q, k, v, kvm, out, lse, do, causal, window, scale)
    assert launches() == added(before, route_step(dtype, fwd=0, bwd=1))
    want = attention_backward_plain(q, k, v, kvm, do, causal=causal, window=window)
    tol = grad_tol(dtype, *want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    if masked == "all-in-row-0":  # no live key in batch row 0: the exact dq and dk there are 0
        assert got[0][0].abs().max().item() == 0 and got[1][0].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_differentiable_on_the_card(cuda, dtype):
    """The autograd Function: an output with a grad_fn, whose gradients are
    the plain version's, through a fused qkv read in place."""
    gen = torch.Generator().manual_seed(2)
    qkv = torch.randn((2, 96, 3 * 4, 64), generator=gen).to(cuda, dtype).requires_grad_()
    kvm = (torch.rand((2, 96), generator=gen) > 0.2).to(cuda)
    do = torch.randn((2, 96, 4, 64), generator=gen).to(cuda, dtype)
    before = launches()
    out = flash_attention(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], kvm, causal=True, window=32)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, qkv, do)
    assert launches() == added(before, route_step(dtype, fwd=1, bwd=1))
    plain = attention_plain(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], kvm, causal=True, window=32)
    (want,) = torch.autograd.grad(plain, qkv, do)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=grad_tol(dtype, want))
    with torch.no_grad():  # without a gradient: the forward kernel alone, no lse
        assert flash_attention(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]).grad_fn is None


@pytest.mark.cuda
def test_flash_attention_reads_strided_heads(cuda):
    """q, k, v as thirds of a fused qkv projection, read in place."""
    qkv = torch.randn((1, 96, 3 * 4, 64), generator=torch.Generator().manual_seed(0)).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:]
    torch.testing.assert_close(flash_attention(q, k, v, causal=True), attention_plain(q, k, v, causal=True),
                               rtol=0, atol=ATTN_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_fp32_kernels_match_both_plain_versions(cuda, t, s, causal, window, masked, d):
    """The fp32 pair at D 32, 64 and 128 against the plain versions that
    split as it does and the fp32 ones, at the fp32 bars."""
    q, k, v, kvm = attention_inputs(cuda, t, s, masked, torch.float32, d=d)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda)
    scale = d**-0.5
    before = launches()
    out, lse = flash_fwd_fp32(q, k, v, kvm, causal, window, scale, True)
    got = flash_bwd_fp32(q, k, v, kvm, out, lse, do, causal, window, scale)
    assert launches() == added(before, (1, 1, 0, 0))
    for fwd, bwd in ((attention_plain_fp32_tc, attention_backward_plain_fp32_tc),
                     (attention_plain, attention_backward_plain)):
        want = fwd(q, k, v, kvm, causal=causal, window=window)
        torch.testing.assert_close(out, want, rtol=0, atol=ATTN_TOL[torch.float32])
        want_grads = bwd(q, k, v, kvm, do, causal=causal, window=window)
        tol = grad_tol(torch.float32, *want_grads)
        for g, w in zip(got, want_grads):
            torch.testing.assert_close(g, w, rtol=0, atol=tol)
    if masked == "all-in-row-0":
        assert got[0][0].abs().max().item() == 0 and got[1][0].abs().max().item() == 0


@pytest.mark.cuda
def test_fp32_kernels_reject_misaligned_rows(cuda):
    """The fp32 pair loads 16 bytes a thread as well: a base address off the
    16-byte grid raises, and nothing falls back."""
    flat = torch.randn((1 * 64 * 2 * 64 + 1,), device=cuda)
    shifted = flat[1:].view(1, 64, 2, 64)  # base 4 bytes off
    good = torch.randn((1, 64, 2, 64), device=cuda)
    before = launches()
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(shifted, good, good)
    assert launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_sm90_kernels_match_the_rounding_faithful_plain_versions(cuda, t, s, causal, window, masked):
    """The tensor-core pair against the plain versions that round where it
    rounds (and, in test above, against the fp32 plain versions), with the
    row log-sum-exp equal to the fp32 forward's on the same values."""
    q, k, v, kvm = attention_inputs(cuda, t, s, masked, torch.bfloat16)
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, torch.bfloat16)
    mask = kvm if kvm is None else kvm.bool()
    before = launches()
    out, lse = flash_fwd_sm90(q, k, v, mask, causal, window, 64**-0.5, True)
    got = flash_bwd_sm90(q, k, v, mask, out, lse, do, causal, window, 64**-0.5)
    assert launches() == added(before, (0, 0, 1, 1))
    want = attention_plain_bf16_tc(q, k, v, kvm, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=ATTN_TOL[torch.bfloat16])
    _, lse_fp32 = flash_fwd_fp32(q.float(), k.float(), v.float(), mask, causal, window, 64**-0.5, True)
    torch.testing.assert_close(lse, lse_fp32, rtol=1e-6, atol=1e-5)
    want_grads = attention_backward_plain_bf16_tc(q, k, v, kvm, do, causal=causal, window=window)
    tol = grad_tol(torch.bfloat16, *want_grads)
    for g, w in zip(got, want_grads):
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    if masked == "all-in-row-0":
        assert got[0][0].abs().max().item() == 0 and got[1][0].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("t", [96, 300])
def test_sm90_kernels_read_fused_qkv_views(cuda, t):
    """q, k, v as thirds of a fused qkv projection and k, v as halves of a
    fused kv one, read in place by the tensor-core pair, ragged T included."""
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn((2, t, 3 * 4, 64), generator=gen).to(cuda, torch.bfloat16)
    kv = torch.randn((2, 200, 2 * 4, 64), generator=gen).to(cuda, torch.bfloat16)
    do = torch.randn((2, t, 4, 64), generator=gen).to(cuda, torch.bfloat16)
    for q, k, v, causal in ((qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], True),
                            (qkv[:, :, :4], kv[:, :, :4], kv[:, :, 4:], False)):
        out, lse = flash_fwd_sm90(q, k, v, None, causal, 0, 64**-0.5, True)
        torch.testing.assert_close(out.float(), attention_plain_bf16_tc(q, k, v, causal=causal).float(),
                                   rtol=0, atol=ATTN_TOL[torch.bfloat16])
        got = flash_bwd_sm90(q, k, v, None, out, lse, do, causal, 0, 64**-0.5)
        want = attention_backward_plain_bf16_tc(q, k, v, None, do, causal=causal)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=grad_tol(torch.bfloat16, *want))


@pytest.mark.cuda
def test_sm90_kernels_reject_misaligned_rows(cuda):
    """The tensor-core pair loads 16 bytes a thread: a base address or a
    row stride off the 16-byte grid raises, and nothing falls back."""
    wide = torch.randn((1, 64, 2, 68), device=cuda).to(torch.bfloat16)  # head stride 136 bytes
    flat = torch.randn((1 * 64 * 2 * 64 + 1,), device=cuda).to(torch.bfloat16)
    shifted = flat[1:].view(1, 64, 2, 64)  # base 2 bytes off
    good = torch.randn((1, 64, 2, 64), device=cuda).to(torch.bfloat16)
    before = launches()
    for q in (wide[..., :64], shifted):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention(q, good, good)
    assert launches() == before


@pytest.mark.cuda
def test_launch_counters_show_the_route(cuda):
    """fp32 takes the fp32 pair at any head dim and bf16 up to D 64 the
    tensor-core pair (a narrower head padded to 64), each call adding one
    to its own kernels' counters only; bf16 above D 64 raises and launches
    nothing."""
    for dtype, d, step in ((torch.float32, 64, (1, 1, 0, 0)), (torch.float32, 32, (1, 1, 0, 0)),
                           (torch.float32, 128, (1, 1, 0, 0)), (torch.float32, 36, (1, 1, 0, 0)),
                           (torch.bfloat16, 64, (0, 0, 1, 1)), (torch.bfloat16, 32, (0, 0, 1, 1)),
                           (torch.bfloat16, 52, (0, 0, 1, 1))):
        x = torch.randn((1, 40, 2, d), device=cuda).to(dtype).requires_grad_()
        before = launches()
        flash_attention(x, x, x, causal=True).sum().backward()
        assert launches() == added(before, step), (dtype, d)
    x = torch.randn((1, 40, 2, 96), device=cuda).to(torch.bfloat16).requires_grad_()
    before = launches()
    with pytest.raises(ValueError, match="no kernel takes"):
        flash_attention(x, x, x, causal=True)
    assert launches() == before


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn((1, 8, 2, 136), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.randn((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention(q, q, q)
    q = torch.randn((1, 8, 2, 36), device=cuda)  # the kernels' own entries take no padding
    with pytest.raises(RuntimeError, match="flash_fwd_fp32: CUDA error"):
        flash_attention_fwd(q, q, q, None, False, 0, 1.0)


# moonshine's head dims (tiny, base): padded to 40 / 56 on the fp32 route, 64 on the sm90 route
PADDED_HEAD_DIMS = (36, 52)
PADDED_CASES = [(681, 681, False, 0, "none"), (96, 96, True, 0, "some"), (50, 681, False, 0, "some")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
@pytest.mark.parametrize("t,s,causal,window,masked", PADDED_CASES)
def test_kernels_take_head_dims_that_are_padded(cuda, dtype, d, t, s, causal, window, masked):
    """B and C at moonshine's head dims through ``flash_attention`` (one
    launch of each kernel of the route, the scale from the unpadded D),
    held on the unpadded inputs against the plain versions that round as
    the route does and the fp32 ones: a moonshine encoder window (T = S =
    681), a causal self-attention with a key mask and a cross call."""
    q, k, v, kvm = attention_inputs(cuda, t, s, masked, dtype, d=d, h=8)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    before = launches()
    out = flash_attention(q, k, v, kvm, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert launches() == added(before, route_step(dtype, fwd=1, bwd=1))
    assert out.shape == q.shape and all(g.shape == x.shape for g, x in zip(got, (q, k, v)))
    faithful = {torch.float32: (attention_plain_fp32_tc, attention_backward_plain_fp32_tc),
                torch.bfloat16: (attention_plain_bf16_tc, attention_backward_plain_bf16_tc)}[dtype]
    for fwd, bwd in (faithful, (attention_plain, attention_backward_plain)):
        want = fwd(q.detach(), k.detach(), v.detach(), kvm, causal=causal, window=window)
        torch.testing.assert_close(out.detach().float(), want.float(), rtol=0, atol=ATTN_TOL[dtype])
        want_grads = bwd(q.detach(), k.detach(), v.detach(), kvm, do, causal=causal, window=window)
        tol = grad_tol(dtype, *want_grads)
        for g, w in zip(got, want_grads):
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_fused_mel_kernel_matches_plain(cuda):
    """Two v32 windows (2048 frames each, 1024 -> 128 mels) read in place
    from the padded signal."""
    mel = MelSpectrogram("pallas", True, 16000, 1024, 128, 128, 20, 8000, "reflect").to(cuda)
    x = torch.randn((2, 2047 * 128), generator=torch.Generator().manual_seed(0)).to(cuda) * 0.3
    padded = torch.nn.functional.pad(x[:, None], (512, 512), mode="reflect")[:, 0]
    frames = padded.unfold(1, 1024, 128)[:, :2048]
    before = fused_mel.launches
    got = fused_mel(frames, mel.w_re, mel.w_im, mel.fbanks, True)
    assert fused_mel.launches == before + 1
    want = mel_plain(frames, mel.w_re, mel.w_im, mel.fbanks, True)
    torch.testing.assert_close(got, want, rtol=MEL_TOL, atol=MEL_TOL)
    torch.testing.assert_close(mel(x), want, rtol=MEL_TOL, atol=MEL_TOL)


def mel_frames(device, batch, n_frames, n_fft=1024, hop=128, seed=0):
    """``batch`` items of seeded audio (a 440 Hz tone and noise, as
    chip_smoke.py's check_mel) padded by reflection and framed as
    ``MelSpectrogram`` frames them: ``n_frames`` frames of ``n_fft`` samples
    at ``hop``, a strided view into the padded signal."""
    n = (n_frames - 1) * hop
    t = torch.arange(n) / 16000
    noise = torch.randn((batch, n), generator=torch.Generator().manual_seed(seed))
    x = (0.5 * torch.sin(2 * torch.pi * 440 * t) + 0.1 * noise).to(device)
    padded = torch.nn.functional.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return padded.unfold(1, n_fft, hop)[:, :n_frames]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n_frames,n_mels,log_scale,n_fft,hop", [
    (1, 2048, 128, True, 1024, 128),   # one v32 window
    (1, 4096, 80, True, 1024, 128),    # one v31 window: 4 096 frames, 80 mels
    (2, 2048, 128, True, 1024, 128),   # two windows (CFG)
    (2, 2047, 128, True, 1024, 128),   # the last tile of item 0 is short: tiles stop at the batch boundary
    (1, 2048, 128, False, 1024, 128),
    (1, 2048, 388, True, 1024, 128),   # the default MelSpectrogram's 388 mels: four chunks of the projection
    (1, 300, 80, True, 1024, 128),
    (2, 500, 80, True, 400, 160),      # 201 bins, a cluster of 3; n_fft past the last whole k tile
    (1, 333, 64, True, 200, 80),       # 101 bins, a cluster of 2
])
def test_fused_mel_kernel_matches_both_plain_versions(cuda, batch, n_frames, n_mels, log_scale, n_fft, hop):
    """The kernel (split-TF32 tensor-core products) against the plain version
    that rounds as it does and the fp32 one, at 1e-4, on the unfold view
    that ``MelSpectrogram`` passes."""
    mel = MelSpectrogram("pallas", log_scale, 16000, n_fft, n_mels, hop, 20, 8000, "reflect").to(cuda)
    frames = mel_frames(cuda, batch, n_frames, n_fft=n_fft, hop=hop)
    assert frames.shape == (batch, n_frames, n_fft) and frames.stride(1) == hop
    args = (mel.w_re, mel.w_im, mel.fbanks, log_scale)
    before = fused_mel.launches
    got = fused_mel(frames, *args)
    assert fused_mel.launches == before + 1
    for plain in (mel_plain_tf32x3, mel_plain):
        torch.testing.assert_close(got, plain(frames, *args), rtol=MEL_TC_TOL, atol=MEL_TC_TOL)


@pytest.mark.cuda
def test_fused_mel_kernel_is_bit_equal_from_call_to_call(cuda):
    """The cluster adds its blocks' partial mels in rank order, without
    atomics: two calls give the same bits."""
    mel = MelSpectrogram("pallas", True, 16000, 1024, 128, 128, 20, 8000, "reflect").to(cuda)
    frames = mel_frames(cuda, 2, 2048)
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    assert torch.equal(fused_mel(frames, *args), fused_mel(frames, *args))


@pytest.mark.cuda
def test_fused_mel_kernel_takes_contiguous_frames_whose_span_fits(cuda):
    """Contiguous frames (frame stride n_fft): at n_fft 256 a tile's frames
    fit in shared memory and the kernel takes them; at v32's 1024 they do
    not, and neither does a frame stride that is not a multiple of 16."""
    mel = MelSpectrogram("pallas", True, 16000, 256, 40, 128, 20, 8000, "reflect").to(cuda)
    frames = mel_frames(cuda, 2, 500, n_fft=256).contiguous()
    assert frames.stride(1) == 256
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    got = fused_mel(frames, *args)
    for plain in (mel_plain_tf32x3, mel_plain):
        torch.testing.assert_close(got, plain(frames, *args), rtol=MEL_TC_TOL, atol=MEL_TC_TOL)
    mel = MelSpectrogram("pallas", True, 16000, 1024, 128, 128, 20, 8000, "reflect").to(cuda)
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mel(mel_frames(cuda, 1, 256).contiguous(), *args)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_mel(mel_frames(cuda, 1, 256, hop=120), *args)


def quantized(k, n, device, seed=0):
    """A (K, N) weight quantized per column as test_qmm_kernel.py:15-18 does."""
    w = torch.randn((k, n), generator=torch.Generator().manual_seed(seed)) * 0.05
    scale = w.abs().amax(0).clamp(min=1e-8) / 127
    q = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
    return q.to(device), scale.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [
    # the GEMV path: rows 1-4 at a decode step's widths, ragged K, N 16 and 48
    # (one column tile, and a ragged last one)
    *itertools.product(range(1, GEMV_ROWS + 1), (768, 3072), (768, 2304, 3072)),
    (3, 200, 128), (4, 256, 384), (1, 200, 16), (4, 201, 16), (2, 768, 48), (3, 1, 48), (1, 4096, 8192),
    (5, 128, 512), (70, 200, 128), (70, 201, 144), (256, 3072, 768), (1024, 768, 3072),
    # the tensor-core path at the encoder's and init_cache's widths, ragged rows and K
    *itertools.product((5, 64, 65, 70, 256, 1024), (200, 768), (768, 1536, 2304, 3072)),
    # a v31 encoder window's fc1, qkv and out
    (2048, 768, 3072), (2048, 768, 2304), (2048, 768, 768),
])
def test_qmm_kernel_matches_plain(cuda, dtype, rows, k, n):
    """Both of kernel D's paths (a GEMV up to 4 rows with K split across a
    cluster, the tensor cores above) at the v32 shapes, ragged K (201: the
    tensor-core path loads x element by element) and ragged column tiles,
    each counted by its own launch counter; the tensor-core path also against
    the plain version that rounds as it does."""
    wq, scale = quantized(k, n, cuda)
    x = torch.randn((rows, k), generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    before = qmm.launches, qmm.launches_gemv, qmm.launches_tc
    got = qmm(x, wq, scale)
    tc = rows > GEMV_ROWS
    assert (qmm.launches, qmm.launches_gemv, qmm.launches_tc) == (before[0] + 1, before[1] + (not tc), before[2] + tc)
    want = qmm_plain(x, wq, scale)
    assert got.dtype == want.dtype == dtype and got.shape == (rows, n)
    scale_out = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=QMM_TOL[dtype] * scale_out)
    if tc:
        torch.testing.assert_close(got.float(), qmm_plain_tf32x2(x, wq, scale).float(), rtol=0,
                                   atol=QMM_TC_TOL[dtype] * scale_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [(1, 768, 3072), (2, 768, 768), (4, 3072, 768), (3, 200, 48)])
def test_qmm_gemv_is_bit_equal_from_call_to_call(cuda, dtype, rows, k, n):
    """The cluster's first block adds the blocks' partial sums in rank order,
    with no atomics: two calls on the same inputs give the same bits."""
    wq, scale = quantized(k, n, cuda)
    x = torch.randn((rows, k), generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    first = qmm(x, wq, scale)
    assert all(torch.equal(first, qmm(x, wq, scale)) for _ in range(3))


@pytest.mark.cuda
def test_qmm_gemv_raises_on_a_refused_launch(cuda):
    """A plan the kernel does not take (a cluster of 9 blocks) comes back as a
    CUDA error, which the binding raises; nothing falls back."""
    import ctypes

    from mapperatorinator_tpu_torch.ops import _build
    from mapperatorinator_tpu_torch.ops.qmm_kernel import _GEMV_ARGTYPES

    wq, scale = quantized(768, 768, cuda)
    x = torch.randn((1, 768), device=cuda)
    out = torch.empty((1, 768), device=cuda)
    fn = _build.function("qmm", "qmm_gemv", _GEMV_ARGTYPES)
    assert fn is _build.function("qmm", "qmm_gemv", _GEMV_ARGTYPES) and fn.restype is ctypes.c_int
    err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), 1, 768, 768, 0, 32, 9, 96,
             torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(fn.lib, err, "qmm (GEMV)")


@pytest.mark.cuda
def test_qmm_is_differentiable_on_the_card(cuda):
    wq, scale = quantized(256, 384, cuda)
    x = torch.randn((3, 256), generator=torch.Generator().manual_seed(2)).to(cuda).requires_grad_()
    dy = torch.randn((3, 384), generator=torch.Generator().manual_seed(3)).to(cuda)
    before = qmm.launches
    (got,) = torch.autograd.grad(qmm(x, wq, scale), x, dy)
    assert qmm.launches == before + 1
    (want,) = torch.autograd.grad((x @ wq.float()) * scale, x, dy)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_qmm_rejects_what_the_kernel_does_not_take(cuda):
    wq, scale = quantized(64, 200, cuda)  # N not a multiple of 16
    with pytest.raises(ValueError, match="multiple of 16"):
        qmm_kernel(torch.randn((1, 64), device=cuda), wq, scale)
    wq, scale = quantized(64, 128, cuda)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        qmm_kernel(torch.randn((1, 64), device=cuda, dtype=torch.float16), wq, scale)
    with pytest.raises(ValueError, match="int8"):
        qmm_kernel(torch.randn((1, 64), device=cuda), wq.float(), scale)
    with pytest.raises(ValueError, match="fp32"):
        qmm_kernel(torch.randn((1, 64), device=cuda), wq, scale.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [(1, 768, 3072), (2, 768, 768), (1, 3072, 768)])
def test_qmm_gemv_in_a_cuda_graph_matches_plain_and_counts_replays(cuda, dtype, rows, k, n):
    """Kernel D's GEMV captured in a graph (a decode step's shapes): each
    replay computes what ``qmm_plain`` gives on the inputs it then finds, and
    the launch counters count the replays, not the capture."""
    from mapperatorinator_tpu_torch.ops.launches import Graph

    wq, scale = quantized(k, n, cuda)
    x = torch.zeros((rows, k), device=cuda, dtype=dtype)
    qmm(x, wq, scale)  # the warm-up a capture needs
    torch.cuda.synchronize()
    graph, out = Graph(), {}
    before = qmm.launches, qmm.launches_gemv, qmm.launches_tc
    graph.capture(lambda: out.setdefault("y", qmm(x, wq, scale)))
    assert (qmm.launches, qmm.launches_gemv, qmm.launches_tc) == before
    for seed in range(3):
        x.copy_(torch.randn((rows, k), generator=torch.Generator().manual_seed(seed)).to(cuda, dtype))
        graph.replay()
        want = qmm_plain(x, wq, scale)
        scale_out = max(1.0, want.float().abs().max().item())
        torch.testing.assert_close(out["y"].float(), want.float(), rtol=0, atol=QMM_TOL[dtype] * scale_out)
    assert (qmm.launches, qmm.launches_gemv, qmm.launches_tc) == (before[0] + 3, before[1] + 3, before[2])


@pytest.mark.cuda
def test_kernel_launches_outside_a_counted_graph_refuse_to_be_captured(cuda):
    wq, scale = quantized(768, 768, cuda)
    x = torch.randn((1, 768), device=cuda)
    qmm(x, wq, scale)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="would not be counted"):
        with torch.cuda.graph(graph):
            qmm(x, wq, scale)


def tiny_engine(device, int8: bool, bucket: int = 16, max_length: int = 96):
    """A seeded random fp32 port model at the v32 architecture, 2 + 2 layers
    of width 128 (lane-tileable, so int8 weights take kernel D), 2 heads,
    each cached read in buckets of ``bucket`` slots; its engine and
    vocabulary."""
    import dataclasses

    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.decode import DecodeEngine
    from mapperatorinator_tpu_torch.models.io import quantize_model
    from mapperatorinator_tpu_torch.models.mapperatorinator import build_config, build_model
    from mapperatorinator_tpu_torch.models.params import init_params
    from mapperatorinator_tpu_torch.osu import build_vocabulary

    train = load_config("v32", ["train.data.src_seq_len=256", f"train.data.tgt_seq_len={max_length}"]).train
    vocab = build_vocabulary(train)
    cfg = build_config(train, vocab)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, d_model=128, encoder_layers=2, decoder_layers=2, encoder_heads=2, decoder_heads=2,
        encoder_ffn=256, decoder_ffn=256, decode_attend_bucket=bucket, quantized_kv=int8, dtype=torch.float32))
    model = build_model(cfg, device)
    init_params(model, 0)
    if int8:
        model = quantize_model(model)
    return DecodeEngine(model.eval(), max_length, vocab.pad_id, device=device), vocab


@pytest.mark.cuda
@pytest.mark.parametrize("types_first", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("rows,cfg_scale,sampled", [(1, 1.0, False), (1, 1.0, True), (2, 2.0, True)])
def test_graphed_generate_equals_eager_generate(cuda, int8, rows, cfg_scale, sampled, types_first):
    """A tiny engine's ``generate`` replaying CUDA graphs (one a bucket)
    against the same engine stepping eagerly: the same tokens and end, with
    kernel D launched inside the replays where the weights are int8; with
    ``types_first`` (v31's chain), the temperature read from a table by the
    previous token inside the graph."""
    from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline
    from mapperatorinator_tpu_torch.osu import EventType

    engine, vocab = tiny_engine(cuda, int8)
    pipeline = build_logits_pipeline(vocab, do_sample=sampled, temperature=0.9, top_p=0.9, types_first=types_first,
                                     timing_temperature=0.1, mania_column_temperature=0.5, taiko_hit_temperature=0.5)
    frames = torch.randn((1, 255 * 128), generator=torch.Generator().manual_seed(0)).numpy() * 0.1
    enc = engine.encode_with_cond(frames)
    if cfg_scale > 1:
        enc = torch.cat([enc, enc])
    ids = torch.randint(vocab.event_start[EventType.TIME_SHIFT], vocab.vocab_size_out, (rows, 20),
                        generator=torch.Generator().manual_seed(1)).numpy()
    ids[:, -1] = vocab.sos_id
    results = {}
    for graphs in (True, False, True):  # capture, eager, replay
        engine.use_graphs = graphs
        before = qmm.launches_gemv
        tokens, end = engine.generate(enc, ids, pipeline, [], seed=7, cfg_scale=cfg_scale)  # no EOS: 76 steps
        results.setdefault(graphs, []).append((tokens, end, qmm.launches_gemv - before))
    (g1, g1_end, g1_gemv), (g2, g2_end, g2_gemv) = results[True]
    ((e, e_end, e_gemv),) = results[False]
    assert engine.captures == 5  # the buckets ending at 32, 48, 64, 80 and 96
    assert g1_end == e_end == g2_end == 96 and (g1 == e).all() and (g2 == e).all()
    # 2 layers x (self qkv and out, cross q and out, fc1, fc2) a step
    assert g1_gemv == e_gemv == g2_gemv == (12 * 76 if int8 else 0)


@pytest.mark.cuda
def test_noise_drawn_a_block_at_a_time_samples_what_multinomial_samples(cuda):
    """The decode step samples by ``torch.multinomial``'s own exponential
    race, its noise drawn outside the step one ``exponential_`` a step from
    the call's generator: on the card too, the same tokens as
    ``torch.multinomial`` from a generator with the same seed."""
    from mapperatorinator_tpu_torch.decode.engine import NOISE_BLOCK

    probs = torch.softmax(torch.randn((2, 4097), generator=torch.Generator().manual_seed(0)).to(cuda) * 3, dim=-1)
    gen = torch.Generator(device=cuda).manual_seed(5)
    want = torch.stack([torch.multinomial(probs, 1, generator=gen)[:, 0] for _ in range(2 * NOISE_BLOCK)])
    gen = torch.Generator(device=cuda).manual_seed(5)
    noise = torch.empty((2 * NOISE_BLOCK, 2, 4097), device=cuda)
    for row in noise:
        row.exponential_(generator=gen)
    assert torch.equal((probs / noise).argmax(dim=-1), want)


@pytest.mark.cuda
@pytest.mark.parametrize("t,t_len", [(1024, 700), (1024, 1024), (732, 732)],
                         ids=["bucket-keymask", "bucket-full", "refine-unbucketed"])
def test_fp32_kernels_at_the_dit_band_and_key_mask(cuda, t, t_len):
    """Kernel B as the DiT calls it (``models/dit.py``): B 2, H 12, D 64,
    fp32, the band |q - k| <= 128 as ``window`` 256, and on a power-of-two
    bucket the key mask ``arange(bucket) < t_len`` (its padded query rows far
    from every real key average v over all keys); the refine steps' chunk
    unbucketed, with no key mask. Both plain versions, at 2e-5."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((2, t, 12, 64), generator=gen).to(cuda) for _ in range(3))
    kvm = (torch.arange(t, device=cuda) < t_len).expand(2, t) if t_len < t else None
    before = launches()
    got = flash_attention(q, k, v, kvm, window=256)
    assert launches() == added(before, route_step(torch.float32))
    for plain in (attention_plain, attention_plain_fp32_tc):
        torch.testing.assert_close(got, plain(q, k, v, kvm, window=256), rtol=0, atol=ATTN_TOL[torch.float32])


@pytest.mark.cuda
def test_a_dit_b_block_through_the_kernel_matches_the_plain_path(cuda):
    """One DiT-B block (hidden 768, 12 heads) with every weight drawn from
    N(0, 0.02), on a padded bucket of 1 024 rows with 700 real, through
    kernel B and through the plain version: within 1e-4, one launch."""
    from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
    from mapperatorinator_tpu_torch.models.params import init_dit_params

    torch.backends.cuda.matmul.allow_tf32 = False
    model = DiT(DiTConfig.from_name("DiT-B", depth=1, class_size=48)).to(cuda)
    init_dit_params(model, 0, std=0.02)
    block = model.blocks[0]
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 1024, 768), generator=gen).to(cuda)
    cond = torch.randn((2, 768), generator=gen).to(cuda)
    valid = (torch.arange(1024, device=cuda) < 700).expand(2, 1024).contiguous()
    with torch.no_grad():
        before = launches()
        got = block(x, cond, 128, valid)
        assert launches() == added(before, route_step(torch.float32))
        block.use_flash = False
        want = block(x, cond, 128, valid)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [12, 8], ids=["v29-H12", "v28-H8"])
def test_fp32_forward_at_a_whisper_encoder_window(cuda, h):
    """Kernel B as a whisper_abs encoder layer calls it (v29: whisper-small,
    v28: whisper-base): B 1, T = S = 512, D 64, fp32, no mask; both plain
    versions at 2e-5, one launch."""
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((1, 512, h, 64), generator=gen).to(cuda) for _ in range(3))
    before = launches()
    got = flash_attention(q, k, v, None)
    assert launches() == added(before, route_step(torch.float32))
    for plain in (attention_plain, attention_plain_fp32_tc):
        torch.testing.assert_close(got, plain(q, k, v, None), rtol=0, atol=ATTN_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [
    # v28 (whisper-base, d 512): a decode step's qkv, out / cross q, fc1, fc2 on the GEMV path; an
    # encoder window's (512 rows) and a prefill's (64 rows) on the tensor cores, cross k/v included
    (1, 512, 1536), (1, 512, 512), (1, 512, 2048), (1, 2048, 512), (2, 512, 512),
    (512, 512, 1536), (512, 512, 512), (512, 512, 2048), (512, 2048, 512), (512, 512, 1024), (64, 512, 1536),
])
def test_qmm_kernel_at_the_v28_shapes(cuda, dtype, rows, k, n):
    """Kernel D at K 512 (and fc2's K 2 048), both paths against qmm_plain,
    the tensor cores also against the plain version that rounds as they do."""
    wq, scale = quantized(k, n, cuda)
    x = torch.randn((rows, k), generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    tc = rows > GEMV_ROWS
    before = qmm.launches_gemv, qmm.launches_tc
    got = qmm(x, wq, scale)
    assert (qmm.launches_gemv, qmm.launches_tc) == (before[0] + (not tc), before[1] + tc)
    want = qmm_plain(x, wq, scale)
    scale_out = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=QMM_TOL[dtype] * scale_out)
    if tc:
        torch.testing.assert_close(got.float(), qmm_plain_tf32x2(x, wq, scale).float(), rtol=0,
                                   atol=QMM_TC_TOL[dtype] * scale_out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s", [(512, 2048), (512, 512)], ids=["v32-window", "train-window"])
def test_unscaled_forward_at_t5_cross_attention(cuda, dtype, t, s):
    """Kernel B as T5-base's cross attention calls it: sm_scale 1.0, B 1, H
    12, D 64, T a teacher-forced pass's 512 tokens over S encoder frames (a
    -cn v32 window, 2 048; the training config's, 512), q, k and v projected
    from unit-RMS states by weights drawn as HF initialises T5's (q from
    N(0, (768 * 64)^-0.5), k and v from N(0, 768^-0.5)), so the logits have
    a T5 model's size: both routes against both of their plain versions at
    scale 1.0, one launch each."""
    gen = torch.Generator().manual_seed(7)
    x, enc = torch.randn((1, t, 768), generator=gen), torch.randn((1, s, 768), generator=gen)
    wq = torch.randn((768, 768), generator=gen) * (768 * 64) ** -0.5
    wk, wv = (torch.randn((768, 768), generator=gen) * 768**-0.5 for _ in range(2))
    q = (x @ wq).view(1, t, 12, 64).to(cuda, dtype)
    k, v = ((enc @ w).view(1, s, 12, 64).to(cuda, dtype) for w in (wk, wv))
    before = launches()
    got = flash_attention(q, k, v, None, sm_scale=1.0)
    assert launches() == added(before, route_step(dtype))
    faithful = attention_plain_fp32_tc if dtype == torch.float32 else attention_plain_bf16_tc
    for plain in (attention_plain, faithful):
        torch.testing.assert_close(got.float(), plain(q, k, v, None, sm_scale=1.0).float(), rtol=0,
                                   atol=ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,k,n", [
    # T5-base (d 768, 12 heads of 64, gated ffn 2 048): a decode step's qkv, out / cross q, fc1 / fc1_gate
    # and fc2, and out with CFG, on the GEMV path; a 512-frame window's qkv, out, fc1 / fc1_gate, fc2 and
    # init_cache's cross k/v, and a prefill's qkv, on the tensor cores
    (1, 768, 2304), (1, 768, 768), (1, 768, 2048), (1, 2048, 768), (2, 768, 768),
    (512, 768, 2304), (512, 768, 768), (512, 768, 2048), (512, 2048, 768), (512, 768, 1536), (64, 768, 2304),
])
def test_qmm_kernel_at_the_t5_base_shapes(cuda, dtype, rows, k, n):
    """Kernel D at T5-base's products, both paths against qmm_plain, the
    tensor cores also against the plain version that rounds as they do."""
    wq, scale = quantized(k, n, cuda)
    x = torch.randn((rows, k), generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
    tc = rows > GEMV_ROWS
    before = qmm.launches_gemv, qmm.launches_tc
    got = qmm(x, wq, scale)
    assert (qmm.launches_gemv, qmm.launches_tc) == (before[0] + (not tc), before[1] + tc)
    want = qmm_plain(x, wq, scale)
    scale_out = max(1.0, want.float().abs().max().item())
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=QMM_TOL[dtype] * scale_out)
    if tc:
        torch.testing.assert_close(got.float(), qmm_plain_tf32x2(x, wq, scale).float(), rtol=0,
                                   atol=QMM_TC_TOL[dtype] * scale_out)


# the mapper classifier's and CM3P's calls (fp32, H 8, D 64): (B, T, S, causal, key mask)
EVAL_CASES = [
    (4, 1024, 1024, False, "none"),  # the classifier's encoder, and its cross attention
    (4, 1024, 1024, True, "ragged, row 0 empty"),  # its decoder self-attention under the token mask
    (4, 512, 512, False, "ragged, row 0 empty"),  # CM3P's beatmap tower
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,causal,masked", EVAL_CASES)
def test_kernel_b_at_the_classifier_and_cm3p_calls(cuda, b, t, s, causal, masked):
    """Kernel B as the evaluation models call it, against both fp32 plain
    versions at 2e-5; in a window of pads only (row 0), every query row sees
    no key and averages v over all S keys, as the JAX ``_attend`` does."""
    gen = torch.Generator().manual_seed(13)
    q, k, v = (torch.randn((b, n, 8, 64), generator=gen).to(cuda) for n in (t, s, s))
    kvm = None
    if masked != "none":
        lengths = torch.randint(s // 4, s + 1, (b, 1), generator=gen)
        kvm = (torch.arange(s)[None] < lengths).to(cuda)
        kvm[0] = False
    before = launches()
    got = flash_attention(q, k, v, kvm, causal=causal)
    assert launches() == added(before, (1, 0, 0, 0))
    for plain in (attention_plain, attention_plain_fp32_tc):
        torch.testing.assert_close(got, plain(q, k, v, kvm, causal=causal), rtol=0, atol=ATTN_TOL[torch.float32])
    if kvm is not None:
        torch.testing.assert_close(got[0], v[0].mean(0, keepdim=True).expand(t, -1, -1), rtol=0,
                                   atol=ATTN_TOL[torch.float32])


@pytest.mark.cuda
def test_a_classifier_forward_through_kernel_b(cuda):
    """A small classifier (2 + 2 layers, d_model 512, 8 heads, 256 frames,
    128 tokens, one window all pads) on the card: each encoder layer, each
    decoder self and cross attention launches B once, and the outputs agree
    with the plain attention path within 2e-4 times their size."""
    from types import SimpleNamespace

    from mapperatorinator_tpu_torch.models.classifier import build_classifier
    from mapperatorinator_tpu_torch.models.params import init_params

    spect = SimpleNamespace(sample_rate=16000, n_fft=1024, n_mels=388, hop_length=128)
    model_args = SimpleNamespace(d_model=512, encoder_layers=2, decoder_layers=2, encoder_heads=8, decoder_heads=8,
                                 encoder_ffn=2048, decoder_ffn=2048, classifier_proj_size=256, input_features=False,
                                 spectrogram=spect)
    vocab = SimpleNamespace(vocab_size_out=4000, vocab_size_in=4100, num_mapper_classes=64)
    model = build_classifier(SimpleNamespace(model=model_args, data=SimpleNamespace(src_seq_len=256,
                                                                                    tgt_seq_len=128)), vocab)
    init_params(model, 0)
    model = model.to(cuda).eval()
    gen = torch.Generator().manual_seed(14)
    frames = torch.randn((2, 255 * 128), generator=gen).to(cuda)
    ids = torch.randint(1, 4100, (2, 128), generator=gen).to(cuda)
    mask = torch.ones((2, 128), dtype=torch.bool, device=cuda)
    mask[1] = False
    before = launches()
    with torch.inference_mode():
        got = model(frames, ids, mask)
        assert launches() == added(before, (2 + 2 * 2, 0, 0, 0))
        for module in model.modules():
            if hasattr(module, "use_flash"):
                module.use_flash = False
        want = model(frames, ids, mask)
    for key in ("encoder_last_hidden_state", "decoder_last_hidden_state", "feature_vector", "logits"):
        scale = max(1.0, want[key].abs().max().item())
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=2e-4 * scale)


# kernel C at the training calls (fp32, D 64): DiT-B at diffusion v1's batch
# (unmasked self-attention, H 12) and the mapper classifier at train_v1's
# widths (H 8) at a cut batch: (B, T, S, H, causal, key mask)
TRAIN_BWD_CASES = [
    (256, 128, 128, 12, False, "none"),  # DiT-B
    (4, 1024, 1024, 8, False, "none"),  # the classifier's encoder, and its cross attention
    (4, 1024, 1024, 8, True, "ragged, row 0 empty"),  # its decoder self-attention under the token mask
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,s,h,causal,masked", TRAIN_BWD_CASES)
def test_kernel_c_at_the_dit_and_classifier_training_calls(cuda, b, t, s, h, causal, masked):
    """Kernel C as DiT and classifier training call it, against both fp32
    plain backward versions at 2e-5 times the gradients' size; in a window of
    pads only (row 0) no key is live, so the exact dq and dk there are 0 and
    the kernel must write 0."""
    gen = torch.Generator().manual_seed(20)
    q, k, v = (torch.randn((b, n, h, 64), generator=gen).to(cuda) for n in (t, s, s))
    do = torch.randn((b, t, h, 64), generator=gen).to(cuda)
    kvm = None
    if masked != "none":
        lengths = torch.randint(s // 4, s + 1, (b, 1), generator=gen)
        kvm = (torch.arange(s)[None] < lengths).to(cuda)
        kvm[0] = False
    scale = 64**-0.5
    out, lse = flash_attention_fwd(q, k, v, kvm, causal, 0, scale, with_lse=True)
    before = launches()
    got = flash_attention_bwd(q, k, v, kvm, out, lse, do, causal, 0, scale)
    assert launches() == added(before, (0, 1, 0, 0))
    for plain in (attention_backward_plain, attention_backward_plain_fp32_tc):
        want = plain(q, k, v, kvm, do, causal=causal)
        tol = grad_tol(torch.float32, *want)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=tol)
    if kvm is not None:
        assert got[0][0].abs().max().item() == 0 and got[1][0].abs().max().item() == 0


@pytest.mark.cuda
def test_a_dit_training_step_through_kernels_b_and_c(cuda):
    """A DiT at DiT-B's head width (2 blocks, hidden 384, 6 heads of 64, 128
    positions, batch 8) from flax's initialisation with its zero adaLN
    perturbed, so that every block computes: the training loss and every
    gradient through B and C (one of each a block) against the plain
    attention path, within 2e-4 times each gradient's size."""
    from mapperatorinator_tpu_torch.diffusion import create_diffusion
    from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
    from mapperatorinator_tpu_torch.models.params import init_dit_flax

    model = DiT(DiTConfig(hidden_size=384, depth=2, num_heads=6, class_size=48)).to(cuda)
    init_dit_flax(model, 0)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.02, generator=torch.Generator(cuda).manual_seed(1))
    diffusion = create_diffusion("", noise_schedule="squaredcos_cap_v2", diffusion_steps=1000)
    gen = torch.Generator().manual_seed(21)
    x = (torch.rand((8, 128, 2), generator=gen) * 2 - 1).to(cuda)
    c = torch.randn((8, 128, 272), generator=gen).to(cuda)
    y = (torch.rand((8, 48), generator=gen) < 0.3).float().to(cuda)
    t = torch.randint(0, 100, (8,), generator=gen).to(cuda)
    noise = torch.randn((8, 128, 2), generator=gen).to(cuda)

    def loss_and_grads():
        loss = diffusion.training_losses(lambda xt, tt: model(xt, tt, c, y), x, t, lambda shape: noise)["loss"].mean()
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    before = launches()
    loss, grads = loss_and_grads()
    assert launches() == added(before, (2, 2, 0, 0))
    for block in model.blocks:
        block.use_flash = False
    want_loss, want = loss_and_grads()
    torch.testing.assert_close(loss, want_loss, rtol=2e-5, atol=0)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * max(w.abs().max().item(), 1e-30))


# kernel C (with B) on the bf16 route as the backbone families' training calls it: (label, B, T, S, H, D, causal,
# key mask, sm_scale); T 384 decoder tokens and S 511 encoder positions of the T5 / nGPT / moonshine training
# configs (512 source frames, 384 target positions)
BACKBONE_BWD_CASES = [
    ("t5-cross", 2, 384, 511, 12, 64, False, "none", 1.0),
    ("ngpt-decoder-self", 2, 384, 384, 8, 64, True, "ragged", 1.0),
    ("moonshine-decoder-self", 2, 384, 384, 8, 36, True, "ragged, row 0 empty", None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("label,b,t,s,h,d,causal,masked,sm_scale", BACKBONE_BWD_CASES,
                         ids=[case[0] for case in BACKBONE_BWD_CASES])
def test_bf16_kernel_c_at_the_backbone_training_calls(cuda, label, b, t, s, h, d, causal, masked, sm_scale):
    """B and C on the bf16 route through ``flash_attention`` under autograd,
    as bf16 training of T5, nGPT and moonshine calls them: unscaled
    (``sm_scale`` 1.0) at T5's cross attention, q and k drawn as HF draws
    T5-base's projections, and at an nGPT decoder self-attention, q and k
    unit vectors times sqrt(D) and 1; moonshine's D 36 zero-padded to 64,
    causal under a key mask whose row 0 holds no live key. One launch of
    each sm90 kernel; the output and dq, dk, dv against both bf16 plain
    versions (the one that rounds as the route does, and the fp32 one), and
    a row with no live key gets dq and dk of exactly 0."""
    gen = torch.Generator().manual_seed(36)
    if label == "t5-cross":  # unit-RMS states through projections of HF's T5 init
        x, enc = torch.randn((b, t, h * d), generator=gen), torch.randn((b, s, h * d), generator=gen)
        wq = torch.randn((h * d, h * d), generator=gen) * (h * d * d) ** -0.5
        wk, wv = (torch.randn((h * d, h * d), generator=gen) * (h * d) ** -0.5 for _ in range(2))
        q = (x @ wq).view(b, t, h, d)
        k, v = ((enc @ w).view(b, s, h, d) for w in (wk, wv))
    else:
        q, k, v = (torch.randn((b, n, h, d), generator=gen) for n in (t, s, s))
        if label.startswith("ngpt"):  # normalised heads, q scaled by sqrt(D)
            q, k = (torch.nn.functional.normalize(x, dim=-1) for x in (q, k))
            q = q * d**0.5
    do = torch.randn((b, t, h, d), generator=gen)
    kvm = None
    if masked != "none":
        lengths = torch.randint(s // 2, s + 1, (b, 1), generator=gen)
        kvm = torch.arange(s)[None] < lengths
        if "row 0 empty" in masked:
            kvm[0] = False
        kvm = kvm.to(cuda)
    q, k, v, do = (x.to(cuda, torch.bfloat16) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = launches()
    out = flash_attention(*leaves, kvm, causal=causal, sm_scale=sm_scale)
    got = torch.autograd.grad(out, leaves, do)
    assert launches() == added(before, (0, 0, 1, 1))
    for fwd, bwd in ((attention_plain_bf16_tc, attention_backward_plain_bf16_tc),
                     (attention_plain, attention_backward_plain)):
        want = fwd(q, k, v, kvm, causal=causal, sm_scale=sm_scale)
        torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=ATTN_TOL[torch.bfloat16])
        want_grads = bwd(q, k, v, kvm, do, causal=causal, sm_scale=sm_scale)
        tol = grad_tol(torch.bfloat16, *want_grads)
        for g, w in zip(got, want_grads):
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    if "row 0 empty" in masked:
        assert got[0][0].abs().max().item() == 0 and got[1][0].abs().max().item() == 0
