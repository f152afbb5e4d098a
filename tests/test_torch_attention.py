"""The port's attention against the JAX flash kernel and ``_attend``.

On the CPU :func:`flash_attention` is the kernel's plain version; it is held
against the Pallas kernel (interpreted on the CPU) and against the model's
XLA ``_attend`` over the five cases of test_attention_kernel.py plus a row
whose keys are all masked, at that file's bar (2e-5), and against the JAX
chunked band (``_attend_banded_chunked``, which ``banded_local_attention``
selects) with the band as its ``window``. The CUDA kernel is held
against the plain version in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.transformer import _attend, _attend_banded_chunked
from mapperatorinator_tpu.ops.attention_kernel import flash_attention as jax_flash_attention
from mapperatorinator_tpu_torch.models.transformer import attend
from mapperatorinator_tpu_torch.ops.attention_kernel import flash_attention

TOL = 2e-5  # test_attention_kernel.py:47

CASES = [  # t, s, causal, window, masked (test_attention_kernel.py:26-35), + all keys masked
    (64, 64, False, 0, "some"),
    (64, 64, True, 0, "some"),
    (64, 64, False, 16, "some"),
    (50, 70, False, 0, "some"),
    (64, 64, True, 16, "none"),
    (64, 64, False, 0, "all-in-row-0"),
]


def inputs(t, s, masked, d=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, t, 2, d)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, d)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, d)).astype(np.float32)
    kvm = None
    if masked != "none":
        kvm = rng.random((2, s)) > 0.2
        if masked == "all-in-row-0":
            kvm[0] = False
    return q, k, v, kvm


def structural_mask(t, s, kvm, causal, window):
    q_pos, k_pos = np.arange(t)[:, None], np.arange(s)[None, :]
    m = np.ones((t, s), bool)
    if causal:
        m &= k_pos <= q_pos
    if window:
        m &= np.abs(q_pos - k_pos) <= window // 2
    m = m[None, None]
    return m & kvm[:, None, None, :] if kvm is not None else m


@pytest.mark.parametrize("t,s,causal,window,masked", CASES)
def test_plain_attention_matches_jax(t, s, causal, window, masked):
    q, k, v, kvm = inputs(t, s, masked)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(kvm) if kvm is not None else None, causal=causal, window=window).numpy()
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(kvm) if kvm is not None else None,
                               causal=causal, window=window, block_q=32)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    mask = structural_mask(t, s, kvm, causal, window)
    want_xla = _attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want_xla), atol=TOL)
    got_attend = attend(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(mask), torch.float32).numpy()
    np.testing.assert_allclose(got_attend, np.asarray(want_xla), atol=TOL)
    if masked == "all-in-row-0":  # masked logits are finfo.min, not -inf: v is averaged
        np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(0), got[0].shape), atol=TOL)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("causal", [False, True])
def test_banded_local_attention_matches_jax(causal, scaled):
    """``banded_local_attention``: the JAX package computes a local layer's
    band over chunks of window / 2 (each query chunk against its previous,
    own and next), the port with the band as ``flash_attention``'s window:
    the same function, with a key mask, causal or not, scaled or not."""
    q, k, v, kvm = inputs(64, 64, "some")
    want = _attend_banded_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=16, causal=causal,
                                  key_mask=jnp.asarray(kvm), dtype=jnp.float32, scaled=scaled)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(kvm),
                          causal=causal, window=16, sm_scale=None if scaled else 1.0).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
