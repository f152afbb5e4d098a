"""The tensor-core attention's plain versions against the JAX package, in bf16.

:func:`attention_plain_bf16_tc` and :func:`attention_backward_plain_bf16_tc`
round where the kernels of ``csrc/flash_attention_sm90.cu`` round: bf16
inputs, fp32 logits and softmax, P (and dS) rounded to bf16 before the
products that take them, fp32 sums. On the CPU they are held against the
model's own bf16 attention, ``_attend(..., jnp.bfloat16)`` and ``jax.vjp`` of
it, and against the Pallas ``_flash_forward`` / ``_flash_backward``
(interpreted), over the cases of test_torch_attention.py (one of them a batch
row whose keys are all masked) at D 64, at the port's bf16 bar: 2e-2, for
gradients times the largest reference gradient (at least 1). The Pallas
backward differs from the exact gradient in a row with no live key
(test_torch_attention_bwd.py), so there dq and dk are held to the exact
gradient alone. The kernels are held against these plain versions on the
card in test_torch_kernels.py. Last, the route rule of ``flash_attention``
for each (dtype, head dim), against a table of the expected routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.transformer import _attend
from mapperatorinator_tpu.ops.attention_kernel import _flash_backward
from mapperatorinator_tpu.ops.attention_kernel import flash_attention as jax_flash_attention
from mapperatorinator_tpu_torch.ops.attention_kernel import (
    SM90_HEAD_DIMS,
    attention_backward_plain_bf16_tc,
    attention_plain_bf16_tc,
    attention_route,
)
from tests.test_torch_attention import CASES, inputs, structural_mask
from tests.test_torch_attention_bwd import live_rows

TOL = 2e-2  # the port's bf16 bar (test_torch_kernels.py, chip_smoke.py)
D = 64  # v32's head dim, the one the tensor-core kernels take


def bf16_inputs(t, s, masked, seed=0):
    """The same values in both frameworks: fp32 from numpy, rounded to bf16
    (round to nearest even) by each."""
    q, k, v, kvm = inputs(t, s, masked, d=D, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    jx = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v, do)]
    tx = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    return jx, tx, kvm


def as_np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_tc_forward_matches_jax_bf16(t, s, causal, window, masked):
    (jq, jk, jv, _), (tq, tk, tv, _), kvm = bf16_inputs(t, s, masked)
    tm = torch.from_numpy(kvm) if kvm is not None else None
    got = attention_plain_bf16_tc(tq, tk, tv, tm, causal=causal, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape

    mask = jnp.asarray(structural_mask(t, s, kvm, causal, window))
    np.testing.assert_allclose(as_np(got), as_np(_attend(jq, jk, jv, mask, jnp.bfloat16)), atol=TOL)
    pallas = jax_flash_attention(jq, jk, jv, jnp.asarray(kvm) if kvm is not None else None,
                                 causal=causal, window=window, block_q=32)
    np.testing.assert_allclose(as_np(got), as_np(pallas), atol=TOL)


@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_tc_backward_matches_jax_bf16(t, s, causal, window, masked):
    (jq, jk, jv, jdo), (tq, tk, tv, tdo), kvm = bf16_inputs(t, s, masked)
    tm = torch.from_numpy(kvm) if kvm is not None else None
    got = [as_np(g) for g in attention_backward_plain_bf16_tc(tq, tk, tv, tm, tdo, causal=causal, window=window)]

    mask = structural_mask(t, s, kvm, causal, window)
    _, vjp = jax.vjp(lambda q, k, v: _attend(q, k, v, jnp.asarray(mask), jnp.bfloat16), jq, jk, jv)
    want = [as_np(g) for g in vjp(jdo)]
    tol = TOL * max(1.0, max(np.abs(w).max() for w in want))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=tol)

    kv_mask = jnp.asarray(kvm) if kvm is not None else jnp.ones((2, s), bool)
    pallas = [as_np(g) for g in _flash_backward(jq, jk, jv, kv_mask, jdo, causal, window, D**-0.5, 32)]
    live = live_rows(mask, 2, t)
    whole = live.all(axis=1)  # batch rows in which every query row has a live key
    np.testing.assert_allclose(got[2], pallas[2], atol=tol)
    np.testing.assert_allclose(got[0][live], pallas[0][live], atol=tol)
    np.testing.assert_allclose(got[1][whole], pallas[1][whole], atol=tol)
    np.testing.assert_array_equal(got[0][~live], 0.0)  # a row with no live key: no dq
    if masked == "all-in-row-0":
        np.testing.assert_array_equal(got[1][0], 0.0)  # and nothing to its keys' dk


# (dtype, head dim) -> route; a pair missing here has no kernel and raises
ROUTES = {(torch.float32, d): "fp32" for d in (8, 32, 64, 128)} | {(torch.bfloat16, 64): "sm90"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("head_dim", [8, 32, 64, 128])
def test_route_rule(dtype, head_dim):
    """fp32 goes to the fp32 kernels at any head dim, bf16 at D 64 to the
    tensor-core kernels; bf16 at another head dim, and fp16, raise."""
    assert SM90_HEAD_DIMS == (64,)
    if (dtype, head_dim) in ROUTES:
        assert attention_route(dtype, head_dim) == ROUTES[dtype, head_dim]
    else:
        with pytest.raises(ValueError, match="no kernel takes"):
            attention_route(dtype, head_dim)
