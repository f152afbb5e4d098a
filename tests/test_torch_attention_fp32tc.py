"""The fp32 attention kernels' rounding, on the CPU: split-TF32 products.

The fp32 kernels of ``csrc/flash_attention.cu`` take every product on the
tensor cores as three TF32 products: each fp32 operand is split into
``hi = tf32(x)`` and ``lo = tf32(x - hi)``, and a·b is taken as
hi·lo' + lo·hi' + hi·hi' with fp32 sums. :func:`attention_plain_fp32_tc`
and :func:`attention_backward_plain_fp32_tc` round the same way. Here they
are held, over the cases of test_torch_attention.py (causal, window, key
mask, a batch row whose keys are all masked) at D 32 and 64:

* against the model's own fp32 ``_attend`` and ``jax.vjp`` of it, at the
  reference's 2e-5 (test_attention_kernel.py:47; gradients times the
  largest reference gradient, at least 1, as on the card);
* against the same function in fp64, within 2e-6, a tenth of that bar: a
  single TF32 product misses it by two orders of magnitude, the split does
  not.

A row whose keys are all masked gets dq = dk = 0 exactly. The kernels are
held against these plain versions on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.transformer import _attend
from mapperatorinator_tpu_torch.ops.attention_kernel import (
    attention_backward_plain_fp32_tc,
    attention_plain_fp32_tc,
    tf32_split,
)
from tests.test_torch_attention import CASES, inputs, structural_mask
from tests.test_torch_attention_bwd import live_rows

TOL = 2e-5  # test_attention_kernel.py:47
FP64_TOL = 2e-6  # a tenth of the bar


def case_inputs(t, s, masked, d, seed=0):
    q, k, v, kvm = inputs(t, s, masked, d=d, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, kvm, do


def fp64_attention(q, k, v, mask, do):
    """Forward and exact gradient in fp64, from the fp32 inputs."""
    q, k, v, do = (torch.from_numpy(x).double().requires_grad_(x is not do) for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    logits = torch.where(torch.from_numpy(mask), logits, float(np.finfo(np.float32).min))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return out.detach().numpy(), [g.numpy() for g in grads]


def test_split_is_exact_to_fp32():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32)) * 3
    hi, lo = tf32_split(x)
    for part in (hi, lo):  # 10 mantissa bits: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    # hi + lo keeps 21 of fp32's 24 significant bits
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.double().abs() * 2.0**-21).all()
    # round to nearest, ties away from zero: 1 + 2^-11 + 2^-12 rounds up, 1 + 2^-11 (a tie) away from zero
    assert tf32_split(torch.tensor([1 + 2**-11 + 2**-12]))[0].item() == 1 + 2**-10
    assert tf32_split(torch.tensor([-(1 + 2**-11)]))[0].item() == -(1 + 2**-10)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_fp32_tc_forward(t, s, causal, window, masked, d):
    q, k, v, kvm, do = case_inputs(t, s, masked, d)
    tm = torch.from_numpy(kvm) if kvm is not None else None
    got = attention_plain_fp32_tc(*(torch.from_numpy(x) for x in (q, k, v)), tm, causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    mask = structural_mask(t, s, kvm, causal, window)
    want = _attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    exact, _ = fp64_attention(q, k, v, mask, do)
    np.testing.assert_allclose(got.numpy(), exact, atol=FP64_TOL)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_fp32_tc_backward(t, s, causal, window, masked, d):
    q, k, v, kvm, do = case_inputs(t, s, masked, d)
    tm = torch.from_numpy(kvm) if kvm is not None else None
    got = [g.numpy() for g in attention_backward_plain_fp32_tc(
        *(torch.from_numpy(x) for x in (q, k, v)), tm, torch.from_numpy(do), causal=causal, window=window)]

    mask = structural_mask(t, s, kvm, causal, window)
    _, vjp = jax.vjp(lambda q, k, v: _attend(q, k, v, jnp.asarray(mask), jnp.float32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    scale = max(1.0, max(np.abs(w).max() for w in want))
    _, exact = fp64_attention(q, k, v, mask, do)
    for g, w, e in zip(got, want, exact):
        np.testing.assert_allclose(g, w, atol=TOL * scale)
        np.testing.assert_allclose(g, e, atol=FP64_TOL * scale)

    live = live_rows(mask, 2, t)
    np.testing.assert_array_equal(got[0][~live], 0.0)  # a row with no live key: no dq
    if masked == "all-in-row-0":
        np.testing.assert_array_equal(got[1][0], 0.0)  # and nothing to its keys' dk
