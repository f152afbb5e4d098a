"""The port's logits chain and decode engine against the JAX ones.

* processed logits of the chain, for each processor, on the same scores and
  state, and the state update;
* greedy decode on the tiny checkpoint, token for token, plain and as a CFG
  ``[negative; positive]`` dual batch;
* sampled decode: the two frameworks' random streams differ
  (``decode/engine.py:26-29``), so the JAX engine is forced along the port's
  sampled tokens and the processed logits are compared at every step.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.decode import logits as jax_logits
from mapperatorinator_tpu.osu import EventType, Vocabulary
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode import logits as torch_logits
from mapperatorinator_tpu_torch.osu import ContextType as PortContextType
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.test_torch_model import audio, tiny  # noqa: F401  (module fixture)

# tiny shapes: one thread each, since several test workers share the CPU
torch.set_num_threads(1)

LOGITS_TOL = 2e-4  # model-level bar (test_model.py:77); the chain adds fp32 rounding only
MAX_LEN = 256

PIPELINES = {
    "greedy": dict(do_sample=False),
    "sampled-v32": dict(temperature=0.9, top_p=0.9),
    "top-k-bias-lookback": dict(top_k=20, timeshift_bias=0.5, lookback_max_time=300.0, temperature=1.3),
    "types-first-lookback": dict(types_first=True, lookback_max_time=500.0, temperature=0.9,
                                 timing_temperature=0.1, top_p=0.95),
}


@pytest.fixture(scope="module")
def vocab():
    """The JAX package's copy of the port's v32 vocabulary (the two packages'
    enum classes differ, so each side reads its own)."""
    return Vocabulary.from_state_dict(build_vocabulary(load_config("v32").train).state_dict())


def port_vocab(vocab) -> PortVocabulary:
    return PortVocabulary.from_state_dict(vocab.state_dict())


def both_pipelines(vocab, **kw):
    return (jax_logits.build_logits_pipeline(vocab, **kw),
            torch_logits.build_logits_pipeline(port_vocab(vocab), **kw))


def assert_scores_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_logits_chain_matches_jax(vocab, name):
    jp, tp = both_pipelines(vocab, **PIPELINES[name])
    assert dataclasses.astuple(jp) == dataclasses.astuple(tp)
    rng = np.random.default_rng(0)
    V = vocab.vocab_size_out
    ts0 = vocab.event_start[EventType.TIME_SHIFT]
    beat = vocab.event_start[EventType.BEAT]
    scores = (rng.standard_normal((3, V)) * 3).astype(np.float32)
    last_ts = np.array([-1, 40, 300], np.int32)
    last_token = np.array([beat, ts0 + 40, vocab.event_start[EventType.CIRCLE]], np.int32)
    last_scores = (rng.standard_normal((3, V)) * 3).astype(np.float32)

    jstate = jax_logits.LogitsState(jnp.asarray(last_ts), jnp.asarray(last_token), jnp.asarray(last_scores))
    tstate = torch_logits.LogitsState(torch.from_numpy(last_ts), torch.from_numpy(last_token),
                                      torch.from_numpy(last_scores))
    jstate, want = jp(jstate, jnp.asarray(scores))
    tstate, got = tp(tstate, torch.from_numpy(scores))
    assert_scores_close(got, want, 1e-5)

    tokens = np.array([ts0 + 12, vocab.sos_id, beat], np.int32)
    jstate = jp.update_state(jstate, jnp.asarray(tokens))
    tstate = tp.update_state(tstate, torch.from_numpy(tokens))
    for a, b in zip(tstate, jstate):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eos_token_ids_match_jax(vocab):
    from mapperatorinator_tpu.osu import ContextType

    tvocab = port_vocab(vocab)
    for kw, port_kw in (({}, {}), ({"lookback_time": 3276.0}, {"lookback_time": 3276.0}),
                        ({"lookahead_time": 6552.0, "context_type": ContextType.MAP},
                         {"lookahead_time": 6552.0, "context_type": PortContextType.MAP})):
        assert torch_logits.get_eos_token_ids(tvocab, **port_kw) == jax_logits.get_eos_token_ids(vocab, **kw)


def engines(tiny):  # noqa: F811
    _, jmodel, jparams, tmodel, vocab = tiny
    return (JaxDecodeEngine(jmodel, jparams, MAX_LEN, vocab.pad_id),
            DecodeEngine(tmodel, MAX_LEN, vocab.pad_id, device="cpu"), vocab)


def decode_prompt(vocab, rows: int):
    """Left-padded prompts that end in SOS, as the processor builds them."""
    rng = np.random.default_rng(3)
    lengths = [20, 14, 20, 9][:rows]
    ids = np.zeros((rows, max(lengths)), np.int32)
    for r, n in enumerate(lengths):
        ids[r, -n:] = rng.integers(vocab.event_start[EventType.TIME_SHIFT], vocab.vocab_size_out, n)
        ids[r, -1] = vocab.sos_id
    return ids


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_greedy_tokens_match_jax(tiny, cfg_scale):  # noqa: F811
    jeng, teng, vocab = engines(tiny)
    rows = 2
    frames = audio(1 if cfg_scale > 1 else rows)
    ids = decode_prompt(vocab, rows)
    jp, tp = both_pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)

    jenc = jeng.encode_with_cond(frames)
    tenc = teng.encode_with_cond(frames)
    if cfg_scale > 1:  # [negative; positive] rows over one window
        jenc = jnp.concatenate([jenc, jenc])
        tenc = torch.cat([tenc, tenc])
    want, _ = jeng.generate(jenc, ids, jp, eos, seed=0, cfg_scale=cfg_scale)
    got, _ = teng.generate(tenc, ids, tp, eos, seed=0, cfg_scale=cfg_scale)
    assert (got[:, ids.shape[1]:] != vocab.pad_id).sum() > 0
    np.testing.assert_array_equal(got, want)


def test_sampled_processed_logits_match_jax(tiny):  # noqa: F811
    jeng, teng, vocab = engines(tiny)
    frames = audio(1)
    ids = decode_prompt(vocab, 1)
    jp, tp = both_pipelines(vocab, **PIPELINES["sampled-v32"])
    steps = []
    tokens, end = teng.generate(teng.encode_with_cond(frames), ids, tp, [vocab.eos_id], seed=5,
                                step_logits=steps)
    forced = tokens[:, ids.shape[1]:end]
    assert forced.shape[1] == len(steps) > 8
    want = jeng.generate_forced(jeng.encode_with_cond(frames), ids, jp, forced)
    assert_scores_close(torch.stack(steps, dim=1).numpy(), want, LOGITS_TOL)


def test_unported_engine_paths_raise(tiny):  # noqa: F811
    """A condition the model does not embed is ignored, as the JAX encode
    ignores it (v32 embeds none); a model that embeds one raises when it is
    missing, where the JAX model fails on ``None``."""
    jeng, teng, _ = engines(tiny)
    frames = audio(1)
    cond = {"difficulty": np.full((1,), 4.5, np.float32)}
    plain = teng.encode_with_cond(frames)
    assert torch.equal(teng.encode_with_cond(frames, cond), plain)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jeng.encode_with_cond(frames, cond)), rtol=0,
                               atol=LOGITS_TOL)
    model = teng.model
    # v32 projects the mel and its conditions onto d_model, so the stem is unchanged
    conditioned = type(model)(dataclasses.replace(model.cfg, do_difficulty_embed=True, cond_size=model.cfg.cond_dim))
    with pytest.raises(ValueError, match="difficulty"):
        DecodeEngine(conditioned.eval(), MAX_LEN, 0, device="cpu").encode_with_cond(frames)
