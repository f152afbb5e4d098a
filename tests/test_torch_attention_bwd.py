"""The port's attention gradient against the JAX package's.

On the CPU the port differentiates the plain attention: autograd through
:func:`attention_plain` (which :func:`flash_attention` runs there), and the
backward kernel's plain version :func:`attention_backward_plain`. Both are
held against ``jax.vjp`` of the model's ``_attend`` (the exact gradient of
the masked softmax) over the five cases of test_attention_kernel.py plus a
batch row whose keys are all masked, at that file's bar (2e-5).

Against the Pallas backward ``_flash_backward`` (interpreted on the CPU) the
port agrees at the same bar wherever a query row has a live key. A row whose
keys are all masked is where the two differ, by design: the Pallas kernel
computes dS = P (dP - delta) for every entry, while a masked logit gets no
gradient (``jnp.where`` passes none), so the exact dq row is 0 and the row
adds nothing to dk. dv agrees everywhere. The CUDA kernel is held against
the plain version in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.transformer import _attend
from mapperatorinator_tpu.ops.attention_kernel import _flash_backward
from mapperatorinator_tpu_torch.ops.attention_kernel import attention_backward_plain, flash_attention
from tests.test_torch_attention import CASES, inputs, structural_mask

TOL = 2e-5  # test_attention_kernel.py:47


def grads_inputs(t, s, masked, seed=0):
    q, k, v, kvm = inputs(t, s, masked, seed=seed)
    do = np.random.default_rng(seed + 1).normal(size=q.shape).astype(np.float32)
    return q, k, v, kvm, do


def jax_exact_grads(q, k, v, do, mask):
    _, vjp = jax.vjp(lambda q, k, v: _attend(q, k, v, jnp.asarray(mask), jnp.float32),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def live_rows(mask, b, t):
    """(B, T) bool: the query row has at least one key it may attend."""
    return np.broadcast_to(mask, (b, 1) + mask.shape[2:])[:, 0].any(-1)


@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_backward_is_the_exact_gradient(t, s, causal, window, masked):
    q, k, v, kvm, do = grads_inputs(t, s, masked)
    mask = structural_mask(t, s, kvm, causal, window)
    want = jax_exact_grads(q, k, v, do, mask)

    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tm = torch.from_numpy(kvm) if kvm is not None else None
    got = attention_backward_plain(tq, tk, tv, tm, torch.from_numpy(do), causal=causal, window=window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL)

    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    flash_attention(*leaves, tm, causal=causal, window=window).backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, atol=TOL)


@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_backward_matches_the_pallas_kernel_on_live_rows(t, s, causal, window, masked):
    q, k, v, kvm, do = grads_inputs(t, s, masked)
    mask = structural_mask(t, s, kvm, causal, window)
    live = live_rows(mask, q.shape[0], t)
    kv_mask = jnp.asarray(kvm) if kvm is not None else jnp.ones((2, s), bool)
    pallas = [np.asarray(g) for g in _flash_backward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_mask, jnp.asarray(do),
        causal, window, q.shape[-1] ** -0.5, 32)]
    got = [g.numpy() for g in attention_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(kvm) if kvm is not None else None,
        torch.from_numpy(do), causal=causal, window=window)]
    dq, dk, dv = got

    np.testing.assert_allclose(dv, pallas[2], atol=TOL)
    np.testing.assert_allclose(dq[live], pallas[0][live], atol=TOL)
    whole = live.all(axis=1)  # batch rows in which every query row has a live key
    np.testing.assert_allclose(dk[whole], pallas[1][whole], atol=TOL)

    # rows with no live key: the exact gradient gives their dq nothing and
    # their keys nothing through them; the Pallas kernel does
    np.testing.assert_array_equal(dq[~live], 0.0)
    if masked == "all-in-row-0":
        assert not live[0].any() and live[1].all()
        np.testing.assert_array_equal(dk[0], 0.0)
        assert np.abs(pallas[0][0]).max() > 0.1 and np.abs(pallas[1][0]).max() > 0.1
