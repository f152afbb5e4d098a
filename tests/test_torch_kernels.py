"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips elsewhere (the kernels have no
CPU mode; the plain versions are held against the JAX package by
test_torch_attention.py, test_torch_attention_tc.py, test_torch_mel.py,
test_torch_mel_tc.py, test_torch_qmm.py and test_torch_qmm_tc.py).
Attention is checked on both routes: the fp32 kernels (split-TF32 products, against both the plain
versions that round as they do and the fp32 ones, at D 32, 64 and 128) and
the bf16 pair (D 64); qmm on both of its paths (its GEMV path also for
bit-equal repeats and a refused launch); the fused mel against both its
plain versions (the split-TF32 one and fp32), for bit-equal repeats, and
on the frame layouts it takes and refuses. The file imports only
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
    """fp32 takes the fp32 pair at any head dim and bf16 at D 64 the
    tensor-core pair, each call adding one to its own kernels' counters
    only; bf16 at another head dim raises and launches nothing."""
    for dtype, d, step in ((torch.float32, 64, (1, 1, 0, 0)), (torch.float32, 32, (1, 1, 0, 0)),
                           (torch.float32, 128, (1, 1, 0, 0)), (torch.bfloat16, 64, (0, 0, 1, 1))):
        x = torch.randn((1, 40, 2, d), device=cuda).to(dtype).requires_grad_()
        before = launches()
        flash_attention(x, x, x, causal=True).sum().backward()
        assert launches() == added(before, step), (dtype, d)
    x = torch.randn((1, 40, 2, 32), device=cuda).to(torch.bfloat16).requires_grad_()
    before = launches()
    with pytest.raises(ValueError, match="no kernel takes"):
        flash_attention(x, x, x, causal=True)
    assert launches() == before


@pytest.mark.cuda
def test_flash_attention_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn((1, 8, 2, 12), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.randn((1, 8, 2, 16), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        flash_attention(q, q, q)


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
