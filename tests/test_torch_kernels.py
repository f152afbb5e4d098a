"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA device and skips elsewhere (the kernels have no
CPU mode; the plain versions are held against the JAX package by
test_torch_attention.py and test_torch_mel.py). The file imports only torch
and the port, so it runs where the JAX package's test helpers do not:

    python -m pytest -m cuda tests/test_torch_kernels.py
"""

import pytest
import torch

from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
from mapperatorinator_tpu_torch.ops.attention_kernel import (
    attention_backward_plain,
    attention_plain,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
)
from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # fp32: test_attention_kernel.py:47
# the backward's bar is ATTN_TOL times the largest reference gradient (at
# least 1): gradients grow with the length, and dq is summed with atomics in
# an order that changes from run to run
MEL_TOL = 5e-3  # test_audio.py:80

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
    before = flash_attention.launches
    got = flash_attention(q, k, v, kvm, causal=causal, window=window)
    assert flash_attention.launches == before + 1
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
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, kvm, out, lse, do, causal, window, scale)
    assert flash_attention_bwd.launches == before + 1
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
    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    out = flash_attention(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:], kvm, causal=True, window=32)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, qkv, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (fwd + 1, bwd + 1)
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
