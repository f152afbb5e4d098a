"""The moonshine family (``UsefulSensors/moonshine-*``) on the port against
the JAX package, from a published (HF-format) checkpoint that both packages
load (``tests/test_torch_convert.py`` writes it: ``-cn v32`` with
``train.model.name=UsefulSensors/moonshine-tiny``, raw samples into the
backbone, d_model 32, 2 + 2 layers of 2 heads, ffn 64, an untied head as
v32 sets it), through the helpers of ``tests/test_torch_ngpt.py``:

* the building blocks: the partial GPT-J style rotation at moonshine-tiny's
  and -base's head dims (36 and 52: 32 and 46 dims rotate) against the JAX
  function, the stem's one-group GroupNorm against flax's, and the stem's
  length (a v32 window of 262 144 samples -> 681 positions);
* encoder states, teacher-forced logits and cached-step logits at the
  reference's 2e-4 (``test_model.py:77``), in fp32, through
  ``flash_attention``'s plain version and plain attention;
* greedy decode token for token at B 1 and with a left-padded CFG pair, fp32
  and with int8 weights and KV (the gated decoder feed-forward stays a plain
  ``Dense``); ``generate_forced`` scores on the processed (sampled) logits;
* ``quantize_model`` bit-equal to the JAX ``quantize_checkpoint``, seeded
  weights through a native checkpoint into the JAX loader
  (``tests/test_torch_backbone_train.py`` trains the family);
* kernels B and C's head-dim padding (as ``flash_attention`` pads) at D 36
  and 52 on each route's widths (40 / 56 on the fp32 route, 64 on the sm90
  route) through the plain versions that round as each route does, forward
  and backward, equal to the unpadded plain attention at the explicit
  scale D^-0.5 of the unpadded D.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.transformer import apply_rope_interleaved_partial as jax_rope_partial
from mapperatorinator_tpu_torch.models.transformer import (Dense, GroupNorm, apply_rope_interleaved_partial,
                                                           moonshine_stem_length)
from mapperatorinator_tpu_torch.ops.attention_kernel import (attention_backward_plain,
                                                             attention_backward_plain_bf16_tc,
                                                             attention_backward_plain_fp32_tc, attention_plain,
                                                             attention_plain_bf16_tc, attention_plain_fp32_tc,
                                                             head_dim_width, pad_head_dim)
from tests.test_torch_convert import TINY
from tests.test_torch_ngpt import (check_cached_decode_logits, check_encoder_states, check_generate_forced,
                                   check_greedy_decode, check_quantize_model, check_seeded_round_trip,
                                   check_teacher_forced_logits, family_fixture)
from tests.test_torch_model import audio

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return family_fixture(tmp_path_factory, "moonshine")


def test_the_model_is_moonshine(tiny):
    _, jmodel, _, tmodel, _ = tiny
    b = tmodel.cfg.backbone
    assert tmodel.cfg.input_raw_wave and jmodel.config.input_raw_wave
    assert (b.stem_type, b.rope_partial_factor, b.norm, b.norm_bias, b.attention_bias, b.decoder_activation,
            b.decoder_ffn_gated_concat) == ("moonshine", 0.9, "layer", False, False, "silu", True)
    names = set(tmodel.state_dict())
    assert {"transformer.encoder.conv3.bias", "transformer.encoder.groupnorm.weight"} <= names
    assert not any(n.endswith(".bias") for n in names if "attn" in n or n.endswith(("_norm.bias", ".norm.bias")))
    fc1 = tmodel.transformer.decoder.layers[0].ffn.fc1
    assert type(fc1) is Dense and fc1.weight.shape == (2 * TINY["decoder_ffn_dim"], TINY["d_model"])


@pytest.mark.parametrize("head_dim", [16, 36, 52])
def test_partial_rotation_matches_jax(head_dim):
    rotary = int(head_dim * 0.9)
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 9, 3, head_dim)).astype(np.float32)
    positions = rng.integers(0, 3000, (2, 9))
    want = np.asarray(jax_rope_partial(jnp.asarray(x), jnp.asarray(positions), 10000.0, rotary))
    got = apply_rope_interleaved_partial(torch.from_numpy(x), torch.from_numpy(positions), 10000.0, rotary).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[..., rotary:], x[..., rotary:])  # the rest passes through


def test_groupnorm_matches_flax():
    rng = np.random.default_rng(0)
    x = (3 + rng.standard_normal((2, 50, 12))).astype(np.float32)  # (B, L, C), flax's layout
    flax_norm = fnn.GroupNorm(num_groups=1, epsilon=1e-5)
    params = flax_norm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.1, params)
    want = np.asarray(flax_norm.apply(params, jnp.asarray(x)))
    norm = GroupNorm(12)
    with torch.no_grad():
        norm.weight.copy_(torch.tensor(np.asarray(params["params"]["scale"])))
        norm.bias.copy_(torch.tensor(np.asarray(params["params"]["bias"])))
        got = norm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_stem_length(tiny):
    assert moonshine_stem_length(2048 * 128) == 681  # a v32 window
    tmodel = tiny[3]
    with torch.no_grad():
        states = tmodel.encode(torch.from_numpy(audio(1)))
    assert states.shape == (1, moonshine_stem_length(audio(1).shape[1]), TINY["d_model"])


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_states_match_jax(tiny, flash):
    check_encoder_states(tiny, flash, moonshine_stem_length(audio(1).shape[1]))


def test_teacher_forced_logits_match_jax_on_both_routes(tiny, monkeypatch):
    check_teacher_forced_logits(tiny, monkeypatch, None)


def test_cached_decode_logits_match_jax(tiny):
    check_cached_decode_logits(tiny)


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_greedy_decode_matches_jax(tiny, weights, rows, cfg_scale):
    # QDense: each encoder layer's wqkv, wo, fc1, fc2; each decoder layer's wqkv, wo, wq, wkv, wo; the head
    check_greedy_decode(tiny, weights, rows, cfg_scale, qdense=2 * 4 + 2 * 5 + 1)


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_forced_scores_match_jax(tiny, cfg_scale):
    check_generate_forced(tiny, cfg_scale)


def test_quantize_model_is_bit_equal_to_jax(tiny):
    got = check_quantize_model(tiny)
    assert got["transformer.encoder.layers.0.ffn.fc1.kernel_q"].dtype == torch.int8
    assert got["transformer.decoder.layers.0.ffn.fc1.weight"].dtype == torch.float32  # the gated MLP stays Dense
    assert "transformer.encoder.conv2.weight" in got


def test_seeded_weights_round_trip_through_a_native_checkpoint_jax_reads(tmp_path):
    state = check_seeded_round_trip(tmp_path, "moonshine")
    assert torch.equal(state["transformer.encoder.groupnorm.weight"], torch.ones(TINY["d_model"]))
    assert state["transformer.encoder.conv1.weight"].shape == (TINY["d_model"], 1, 127)


ROUTE_PLAIN = {"fp32": (torch.float32, attention_plain_fp32_tc, attention_backward_plain_fp32_tc),
               "sm90": (torch.bfloat16, attention_plain_bf16_tc, attention_backward_plain_bf16_tc)}


def padded(attend, q, k, v, width):
    """``attend`` on q, k, v zero-padded along D to ``width``, its output
    sliced back to D, as ``flash_attention`` runs its kernels."""
    return attend(*(pad_head_dim(x, width) for x in (q, k, v)))[..., :q.shape[-1]]


@pytest.mark.parametrize("route", sorted(ROUTE_PLAIN))
@pytest.mark.parametrize("head_dim", [36, 52])
def test_head_dim_padding_computes_the_unpadded_attention(head_dim, route):
    """Self attention (causal, key mask) and cross attention (key mask) at
    B 2, T 48, S 48 / 80, H 3: the padded call's output, and its dq, dk, dv
    (by each route's rounding-faithful backward, and by autograd through the
    padding), equal the unpadded ones; the padded columns of the gradients
    are exactly 0."""
    dtype, forward, backward = ROUTE_PLAIN[route]
    width = head_dim_width(route, head_dim)
    assert width == {"fp32": -(-head_dim // 8) * 8, "sm90": 64}[route]
    gen = torch.Generator().manual_seed(head_dim)
    scale = head_dim**-0.5
    tol = 1e-6 if dtype == torch.float32 else 2e-2  # bf16: the output rounds to bf16 after sums in another order
    for causal, s in ((True, 48), (False, 80)):
        q, k, v = (torch.randn((2, 48 if i == 0 else s, 3, head_dim), generator=gen).to(dtype) for i in range(3))
        do = torch.randn((2, 48, 3, head_dim), generator=gen).to(dtype)
        mask = torch.rand((2, s), generator=gen) > 0.2
        kw = dict(causal=causal, sm_scale=scale)
        want = forward(q, k, v, mask, **kw)
        got = padded(lambda *xs: forward(*xs, mask, **kw), q, k, v, width)
        assert got.shape == want.shape and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(got.float(), attention_plain(q, k, v, mask, **kw).float(), rtol=2e-2, atol=2e-2)
        pads = [pad_head_dim(x, width) for x in (q, k, v, do)]
        grads = backward(*pads[:3], mask, pads[3], **kw)
        for g, w in zip(grads, backward(q, k, v, mask, do, **kw)):
            assert torch.equal(g[..., head_dim:], torch.zeros_like(g[..., head_dim:]))
            torch.testing.assert_close(g[..., :head_dim].float(), w.float(), rtol=tol, atol=tol * max(1.0, w.abs().max()))
        leaves = [x.float().requires_grad_() for x in (q, k, v)]
        out = padded(lambda *xs: attention_plain(*xs, mask, **kw), *leaves, width)
        (out * do.float()).sum().backward()
        for leaf, w in zip(leaves, attention_backward_plain(q.float(), k.float(), v.float(), mask, do.float(), **kw)):
            torch.testing.assert_close(leaf.grad, w, rtol=1e-5, atol=1e-5)
