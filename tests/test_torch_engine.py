"""The decode engine's other entry points against the JAX engine on the tiny
checkpoint: ``forward`` and ``forward_stats`` (at the model bar, 2e-4,
test_model.py:77, with the argmax equal), ``generate_forced`` (the processed
scores at the same bar) and ``generate_beams`` (greedy beams token for token,
with equal lengths; sampled beams from a seeded generator).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.decode import logits as jax_logits
from mapperatorinator_tpu.osu import EventType
from tests.test_torch_decode import assert_scores_close, both_pipelines, decode_prompt, engines
from tests.test_torch_model import audio, tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)

TOL = 2e-4  # test_model.py:77


def encoded(jeng, teng, rows: int, cfg_scale: float):
    """Both engines' encoder states for ``rows`` prompt rows (one window each,
    or one window under both halves of a CFG fold)."""
    frames = audio(rows // 2 if cfg_scale > 1 else rows)
    jenc, tenc = jeng.encode_with_cond(frames), teng.encode_with_cond(frames)
    if cfg_scale > 1:
        jenc, tenc = jnp.concatenate([jenc, jenc]), torch.cat([tenc, tenc])
    return jenc, tenc


def teacher_forced_ids(vocab, rows: int):
    """Right-padded token rows (lengths 40 and 33, then again), T = 40, with
    one context token of the input vocabulary, which has no output
    probability (its surprisal is NaN in both engines)."""
    rng = np.random.default_rng(6)
    ids = rng.integers(vocab.event_start[EventType.TIME_SHIFT], vocab.vocab_size_out, (rows, 40)).astype(np.int32)
    ids[1::2, 33:] = vocab.pad_id
    ids[:, 5] = vocab.vocab_size_out + 3
    assert vocab.vocab_size_out + 3 < vocab.vocab_size_in
    return ids


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_forward_and_forward_stats_match_jax(tiny, cfg_scale):  # noqa: F811
    """Three rows (four under CFG, whose halves differ) pad to a row bucket of
    4 (2) and T = 40 to a bucket of 64."""
    jeng, teng, vocab = engines(tiny)
    rows = 4 if cfg_scale > 1 else 3
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = teacher_forced_ids(vocab, rows)
    want = jeng.forward(jenc, ids, cfg_scale=cfg_scale)
    got = teng.forward(tenc, ids, cfg_scale=cfg_scale)
    assert got.dtype == np.float32 and got.shape == want.shape == (rows // (2 if cfg_scale > 1 else 1), 40,
                                                                     vocab.vocab_size_out)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    for name, g, w in zip(("surprisal", "entropy", "argmax"), teng.forward_stats(tenc, ids, cfg_scale=cfg_scale),
                          jeng.forward_stats(jenc, ids, cfg_scale=cfg_scale)):
        assert g.shape == w.shape == got.shape[:2], name
        if name == "argmax":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, got.argmax(-1))
        else:
            assert np.isnan(g).sum() == np.isnan(w).sum() == (name == "surprisal") * got.shape[0]
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_forced_scores_match_jax(tiny, cfg_scale):  # noqa: F811
    jeng, teng, vocab = engines(tiny)
    rows = 2
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = decode_prompt(vocab, rows)
    jp, tp = both_pipelines(vocab, temperature=0.9, top_p=0.9, lookback_max_time=300.0, cfg_scale=cfg_scale)
    forced = np.random.default_rng(7).integers(vocab.event_start[EventType.TIME_SHIFT], vocab.vocab_size_out,
                                               (rows // 2 if cfg_scale > 1 else rows, 12)).astype(np.int32)
    want = jeng.generate_forced(jenc, ids, jp, forced, cfg_scale=cfg_scale)
    got = teng.generate_forced(tenc, ids, tp, forced, cfg_scale=cfg_scale)
    assert got.shape == want.shape == (forced.shape[0], 12, vocab.vocab_size_out)
    assert_scores_close(got, want, TOL)


@pytest.mark.parametrize("num_beams,cfg_scale", [(1, 1.0), (3, 1.0), (2, 3.0)])
def test_greedy_beams_match_jax(tiny, num_beams, cfg_scale):  # noqa: F811
    jeng, teng, vocab = engines(tiny)
    rows = 2
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = decode_prompt(vocab, rows)
    jp, tp = both_pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)
    kw = dict(num_beams=num_beams, max_length=72, length_penalty=1.0, cfg_scale=cfg_scale)
    want, want_len = jeng.generate_beams(jenc, ids, jp, eos, **kw)
    got, got_len = teng.generate_beams(tenc, ids, tp, eos, **kw)
    assert got.shape == want.shape == (rows // (2 if cfg_scale > 1 else 1), 64 + 72)
    assert (got[:, 64:] != vocab.pad_id).sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)


def test_greedy_single_beam_is_greedy_generate(tiny):  # noqa: F811
    """One beam follows the argmax: the tokens of ``generate``, left-padded by
    the beam path's prompt bucket."""
    _, teng, vocab = engines(tiny)
    tenc = teng.encode_with_cond(audio(2))
    ids = decode_prompt(vocab, 2)
    _, tp = both_pipelines(vocab, do_sample=False)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)
    greedy, end = teng.generate(tenc, ids, tp, eos, max_length=96)
    beams, lengths = teng.generate_beams(tenc, ids, tp, eos, num_beams=1, max_length=96)
    P = ids.shape[1]
    for row in range(2):
        n = int(lengths[row]) - int((ids[row] != vocab.pad_id).sum())
        assert n > 0
        np.testing.assert_array_equal(beams[row, 64:64 + n], greedy[row, P:P + n])


def test_sampled_beams_run_and_follow_the_seed(tiny):  # noqa: F811
    _, teng, vocab = engines(tiny)
    tenc = teng.encode_with_cond(audio(2))
    ids = decode_prompt(vocab, 2)
    _, tp = both_pipelines(vocab, temperature=1.5)
    eos = [vocab.eos_id]
    runs = [teng.generate_beams(tenc, ids, tp, eos, num_beams=2, max_length=80, seed=s) for s in (0, 0, 1)]
    for tokens, lengths in runs:
        assert tokens.shape == (2, 64 + 80) and np.all(lengths > (ids != vocab.pad_id).sum(1))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert not np.array_equal(runs[0][0], runs[2][0])
