"""The port's int8 model against the JAX package's, on the tiny checkpoint at
the lane-tileable widths of test_quantize_checkpoint.py:19-23 (d_model 128,
4 heads, ffn 256), where the JAX ``QDense`` runs its Pallas qmm kernel in
interpret mode and the port's runs kernel D's plain version:

* teacher-forced logits with int8 weights, fp32, at the model bar (2e-4,
  test_model.py:77);
* stepwise cached logits with the int8 KV cache, and with int8 weights, at
  the same bar;
* greedy decode through both engines with int8 weights and KV, token for
  token;
* in bf16, where the two frameworks round at other places, the reference's
  own bars against the fp model (test_quantize_checkpoint.py:58-59).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.decode import logits as jax_logits
from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode import logits as torch_logits
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import quantize_model
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from tests.test_torch_decode import decode_prompt
from tests.test_torch_model import audio, prompt
from tests.test_torch_qmm import lane_tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)

TOL = 2e-4  # test_model.py:77
MAX_LEN = 96


def with_kv(cfg, quantized_kv: bool):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, quantized_kv=quantized_kv))


@pytest.fixture(scope="module")
def int8_models(lane_tiny):  # noqa: F811
    """(JAX fp model, params, JAX int8 model, int8 params, port fp model, port int8 model)."""
    _, jmodel, jparams, tmodel, _ = lane_tiny
    jq, jqparams = quantize_checkpoint(jmodel, jparams)
    return jmodel, jparams, jq, jqparams, tmodel, quantize_model(tmodel).eval()


def test_int8_teacher_forced_logits_match_jax(int8_models):
    _, _, jq, jqparams, _, tq = int8_models
    frames = audio(2)
    ids, mask = prompt(2, 40, tq.cfg.vocab_size_in)
    want, _ = jq.apply(jqparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                       decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tq(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                 decoder_attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("weights,kv", [("fp32", "int8"), ("int8", "fp32")])
def test_cached_decode_logits_match_jax(int8_models, weights, kv):
    """A chunked prefill of a left-padded prompt, then single steps: with the
    int8 KV cache, and with int8 weights. The two together are held token for
    token by the greedy test below, not logit for logit: an int8 cache value
    flips where the two frameworks' fp32 values straddle a rounding boundary
    (with int8 weights the encoder states agree to about 2e-6, which flips 3
    of the 32 768 cross-cache values), and one flipped step moves a logit by
    about 1e-3."""
    jmodel, jparams, jq, jqparams, tmodel, tq = int8_models
    jm, jp, tm = (jq, jqparams, tq) if weights == "int8" else (jmodel, jparams, tmodel)
    jm = JaxMapperatorinator(with_kv(jm.config, kv == "int8"))
    tm_kv = Mapperatorinator(with_kv(tm.cfg, kv == "int8"))
    tm_kv.load_state_dict(tm.state_dict())
    tm_kv.eval()
    frames = audio(2)
    ids, mask = prompt(2, 12, tm.cfg.vocab_size_in)
    steps = np.random.default_rng(2).integers(3, tm.cfg.vocab_size_in, (2, 6)).astype(np.int32)

    apply = lambda method, *a, **kw: jm.apply(jp, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    step = jax.jit(functools.partial(apply, "decode_step"))
    cache = apply("init_cache", 2, MAX_LEN, apply("encode", jnp.asarray(frames)))
    assert (cache[0]["self"]["k"].dtype == jnp.int8) == (kv == "int8")
    attn = np.zeros((2, MAX_LEN), bool)
    attn[:, :12] = mask
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    n_valid = mask.sum(1)
    logits, cache = step(apply("embed_tokens", jnp.asarray(ids)), cache, 0,
                         self_mask=jnp.asarray(attn)[:, None, None, :], positions=jnp.asarray(positions))
    want = [np.asarray(logits)[:, -1]]
    for i in range(steps.shape[1]):
        attn[:, 12 + i] = True
        logits, cache = step(apply("embed_tokens", jnp.asarray(steps[:, i:i + 1])), cache, 12 + i,
                             self_mask=jnp.asarray(attn)[:, None, None, :],
                             positions=jnp.asarray(n_valid + i)[:, None])
        want.append(np.asarray(logits)[:, -1])

    with torch.no_grad():
        cache_t = tm_kv.init_cache(2, MAX_LEN, tm_kv.encode(torch.from_numpy(frames)))
        assert (cache_t[0]["self"]["k"].dtype == torch.int8) == (kv == "int8")
        attn_t = torch.zeros((2, MAX_LEN), dtype=torch.bool)
        attn_t[:, :12] = torch.from_numpy(mask)
        logits, _ = tm_kv.decode_step(tm_kv.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0,
                                      self_mask=attn_t[:, None, None, :], positions=torch.from_numpy(positions))
        got = [logits[:, -1].numpy()]
        for i in range(steps.shape[1]):
            attn_t[:, 12 + i] = True
            logits, _ = tm_kv.decode_step(tm_kv.embed_tokens(torch.from_numpy(steps[:, i:i + 1]).long()), cache_t,
                                          12 + i, self_mask=attn_t[:, None, None, :],
                                          positions=torch.from_numpy(n_valid + i)[:, None])
            got.append(logits[:, -1].numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=TOL, atol=TOL)


def test_int8_greedy_generate_matches_jax_engine(int8_models, lane_tiny):  # noqa: F811
    vocab = lane_tiny[4]
    _, _, jq, jqparams, _, tq = int8_models
    jm = JaxMapperatorinator(with_kv(jq.config, True))
    tm = Mapperatorinator(with_kv(tq.cfg, True))
    tm.load_state_dict(tq.state_dict())
    jeng = JaxDecodeEngine(jm, jqparams, MAX_LEN, vocab.pad_id)
    teng = DecodeEngine(tm.eval(), MAX_LEN, vocab.pad_id, device="cpu")
    frames = audio(2)
    ids = decode_prompt(vocab, 2)
    jp = jax_logits.build_logits_pipeline(vocab, do_sample=False)
    tp = torch_logits.build_logits_pipeline(PortVocabulary.from_state_dict(vocab.state_dict()), do_sample=False)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)
    want, want_end = jeng.generate(jeng.encode_with_cond(frames), ids, jp, eos, seed=0)
    got, got_end = teng.generate(teng.encode_with_cond(frames), ids, tp, eos, seed=0)
    assert (got[:, ids.shape[1]:] != vocab.pad_id).sum() > 0
    np.testing.assert_array_equal(got, want)
    assert got_end == int(want_end)


def test_bf16_int8_meets_the_reference_bars(int8_models):
    """bf16 rounds at other places in the two frameworks, so the int8 model
    is held to the fp model as test_quantize_checkpoint.py:58-59 does."""
    _, _, _, _, tmodel, tq = int8_models
    bf16 = Mapperatorinator(dataclasses.replace(tq.cfg, backbone=dataclasses.replace(tq.cfg.backbone,
                                                                                     dtype=torch.bfloat16)))
    bf16.load_state_dict(tq.state_dict())
    bf16 = bf16.to(torch.bfloat16).eval()
    bf16.spectrogram.float()
    assert bf16.transformer.proj_out.scale.dtype == torch.float32
    frames = torch.from_numpy(audio(1))
    ids = torch.from_numpy(prompt(1, 24, tq.cfg.vocab_size_in)[0]).long()
    with torch.no_grad():
        out = tmodel(frames, decoder_input_ids=ids)
        outq = bf16(frames, decoder_input_ids=ids).float()
    rel = float((out - outq).abs().max() / (out.abs().max() + 1e-9))
    assert rel < 0.06
    assert float((out.argmax(-1) == outq.argmax(-1)).float().mean()) > 0.8
