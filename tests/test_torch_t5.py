"""The T5 v1.1 family (``t5_relpos``) on the port against the JAX package,
from a published (HF-format) checkpoint that both packages load
(``tests/test_torch_convert.py`` writes it: ``-cn v32`` with
``train.model.name=google/t5-v1_1-base``, a projected encoder input, d_model
32, 2 + 2 layers of 2 heads of d_kv 64, gated tanh-GELU ffn 64, 256 source
frames and no conv stem):

* the relative-position buckets, by the JAX formula and through the port's
  CPU-built table as the device gathers it, exactly equal to the JAX
  package's for every distance in +-4 096, bidirectional and not;
* encoder states, teacher-forced logits and cached-step logits (a
  left-padded prompt, ``k_positions``) at the reference's 2e-4
  (``test_convert.py:156``), in fp32, with the cross attention through
  ``flash_attention``'s plain version at ``sm_scale`` 1.0 and through
  ``attend(scaled=False)``;
* greedy decode token for token at B 1 and with a left-padded CFG pair, fp32
  and with int8 weights and KV, across the port's 16-slot read buckets;
  ``generate_forced`` scores and ``generate_beams`` tokens;
* bf16 logits against the JAX package in bf16 at the bars of
  ``tests/test_torch_bf16_parity.py``;
* ``quantize_model`` bit-equal to the JAX ``quantize_checkpoint`` (every
  dense site, ``fc1_gate`` included), seeded weights through a native
  checkpoint into the JAX loader (``tests/test_torch_backbone_train.py``
  trains the family).
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
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu.models.transformer import relative_position_bucket as jax_bucket
from mapperatorinator_tpu.osu import EventType
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model, save_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config, build_model
from mapperatorinator_tpu_torch.models.params import init_params, params_from_flax
from mapperatorinator_tpu_torch.models.transformer import (Attention, QDense, RelativePositionBias, RMSNorm,
                                                           TransformerConfig, relative_position_bucket)
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.test_torch_bf16_parity import ARGMAX_AGREEMENT, REL_TOL
from tests.test_torch_convert import FAMILY_OVERRIDES, SRC_LEN, TINY, tiny_args, write_hf_checkpoint
from tests.test_torch_decode import assert_scores_close, both_pipelines, decode_prompt
from tests.test_torch_model import audio, prompt

torch.set_num_threads(1)

TOL = 2e-4  # test_convert.py:156
T5 = FAMILY_OVERRIDES["t5"]
MAX_LEN = 64


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    directory, _, _ = write_hf_checkpoint(tmp_path_factory.mktemp("t5"), "v32", overrides=T5)
    jmodel, jparams, vocab = jax_load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


def with_flash(tmodel, flash: bool, **backbone):
    tm = Mapperatorinator(dataclasses.replace(tmodel.cfg, backbone=dataclasses.replace(tmodel.cfg.backbone,
                                                                                         **backbone)))
    tm.load_state_dict(tmodel.state_dict())
    for m in tm.modules():
        if isinstance(m, Attention):
            m.use_flash = flash
    return tm.eval()


@pytest.mark.parametrize("num_buckets,max_distance", [(32, 128), (16, 64)])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_buckets_equal_jax_over_4096(bidirectional, num_buckets, max_distance):
    rel = np.arange(-4096, 4097, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, num_buckets, max_distance))
    got = relative_position_bucket(torch.from_numpy(rel).long(), bidirectional, num_buckets, max_distance)
    np.testing.assert_array_equal(got.numpy(), want)
    # the table the device gathers from: a one-head bias whose row b holds b returns each distance's bucket
    cfg = TransformerConfig(relative_attention_num_buckets=num_buckets, relative_attention_max_distance=max_distance)
    bias = RelativePositionBias(cfg, 1, bidirectional)
    assert bias.buckets.device.type == "cpu" and "buckets" not in bias.state_dict()
    with torch.no_grad():
        bias.embedding.weight.copy_(torch.arange(num_buckets, dtype=torch.float32)[:, None])
        table = bias(torch.zeros(1, dtype=torch.long), torch.from_numpy(rel).long(), torch.float32)
        rows = bias(torch.zeros((2, 1), dtype=torch.long), torch.from_numpy(np.stack([rel, -rel])).long(),
                    torch.float32)
    assert table.shape == (1, 1, 1, rel.size) and rows.shape == (2, 1, 1, rel.size)
    np.testing.assert_array_equal(table[0, 0, 0].long().numpy(), want)
    np.testing.assert_array_equal(rows[1, 0, 0].long().numpy(), want[::-1])


def test_the_model_is_t5(tiny):
    _, jmodel, _, tmodel, _ = tiny
    b = tmodel.cfg.backbone
    assert (b.position_scheme, b.norm, b.norm_eps, b.activation, b.head_dim, b.ffn_gated, b.attention_scale,
            b.attention_bias, b.mlp_bias, b.conv_stem) == ("t5_relpos", "rms", 1e-6, "gelu_tanh", 64, True, False,
                                                           False, False, False)
    assert dataclasses.asdict(jmodel.config.backbone)["position_scheme"] == "t5_relpos"
    names = set(tmodel.state_dict())
    assert not any("conv" in n for n in names) and not any(n.endswith(".bias") for n in names if "transformer" in n)
    assert {"transformer.encoder.rel_bias.embedding.weight", "transformer.decoder.rel_bias.embedding.weight",
            "transformer.decoder.layers.1.ffn.fc1_gate.weight"} <= names
    assert all(m.eps == 1e-6 for m in tmodel.modules() if isinstance(m, RMSNorm))
    assert tmodel.transformer.decoder.layers[0].self_attn.wqkv.weight.shape == (3 * 2 * 64, TINY["d_model"])
    assert tmodel.transformer.position_table is None


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_states_match_jax(tiny, flash):
    _, jmodel, jparams, tmodel, _ = tiny
    frames = audio(2)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(frames), method=JaxMapperatorinator.encode))
    with torch.no_grad():
        got = with_flash(tmodel, flash).encode(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, SRC_LEN, TINY["d_model"])  # no conv stem: every frame a position
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_teacher_forced_logits_match_jax_on_both_cross_attention_routes(tiny, monkeypatch):
    """The cross attention through ``flash_attention`` (its plain version on
    the CPU) at ``sm_scale`` 1.0 and through ``attend(scaled=False)``: both
    within 2e-4 of JAX, and of each other."""
    _, jmodel, jparams, tmodel, _ = tiny
    frames = audio(2)
    ids, mask = prompt(2, 40, tmodel.cfg.vocab_size_in)
    want, _ = jmodel.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                           decoder_attention_mask=jnp.asarray(mask))
    from mapperatorinator_tpu_torch.models import transformer

    scales = []
    flash = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention", lambda *a, **kw: scales.append(kw["sm_scale"]) or
                        flash(*a, **kw))
    got = {}
    for route in (True, False):
        with torch.no_grad():
            got[route] = with_flash(tmodel, route)(
                torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                decoder_attention_mask=torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got[route], np.asarray(want), rtol=TOL, atol=TOL)
    assert scales == [1.0, 1.0]  # one unscaled cross call a decoder layer, on the flash route only
    np.testing.assert_allclose(got[True], got[False], rtol=TOL, atol=TOL)


def test_cached_decode_logits_match_jax(tiny):
    """A chunked prefill of a left-padded prompt, then single steps: the bias
    from each token's logical position to each slot's (``k_positions``), over
    the port's 16-slot read prefix."""
    _, jm, jparams, tm, _ = tiny
    tm = with_flash(tm, True, decode_attend_bucket=16)
    frames = audio(2)
    ids, mask = prompt(2, 12, tm.cfg.vocab_size_in)
    steps = np.random.default_rng(2).integers(3, tm.cfg.vocab_size_in, (2, 22)).astype(np.int32)
    n_valid = mask.sum(1)
    k_positions = np.maximum(np.arange(MAX_LEN)[None] - (12 - n_valid)[:, None], 0)
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None)

    apply = lambda method, *a, **kw: jm.apply(jparams, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    step = jax.jit(functools.partial(apply, "decode_step"))
    enc = apply("encode", jnp.asarray(frames))
    cache = apply("init_cache", 2, MAX_LEN, enc)
    attn = np.zeros((2, MAX_LEN), bool)
    attn[:, :12] = mask
    want = []
    logits, cache = step(apply("embed_tokens", jnp.asarray(ids)), cache, 0, self_mask=jnp.asarray(attn)[:, None, None],
                         positions=jnp.asarray(positions), k_positions=jnp.asarray(k_positions))
    want.append(np.asarray(logits)[:, -1])
    for i in range(steps.shape[1]):
        attn[:, 12 + i] = True
        logits, cache = step(apply("embed_tokens", jnp.asarray(steps[:, i:i + 1])), cache, 12 + i,
                             self_mask=jnp.asarray(attn)[:, None, None], positions=jnp.asarray(n_valid + i)[:, None],
                             k_positions=jnp.asarray(k_positions))
        want.append(np.asarray(logits)[:, -1])

    got = []
    kp = torch.from_numpy(k_positions)
    with torch.no_grad():
        enc_t = tm.encode(torch.from_numpy(frames))
        cache_t = tm.init_cache(2, MAX_LEN, enc_t)
        attn_t = torch.zeros((2, MAX_LEN), dtype=torch.bool)
        attn_t[:, :12] = torch.from_numpy(mask)
        logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0,
                                   self_mask=attn_t[:, None, None, :], positions=torch.from_numpy(positions),
                                   k_positions=kp)
        got.append(logits[:, -1].numpy())
        for i in range(steps.shape[1]):
            attn_t[:, 12 + i] = True
            logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(steps[:, i:i + 1]).long()), cache_t,
                                       12 + i, self_mask=attn_t[:, None, None, :],
                                       positions=torch.from_numpy(n_valid + i)[:, None], k_positions=kp,
                                       limit=min((12 + i) // 16 * 16 + 16, MAX_LEN))
            got.append(logits[:, -1].numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=TOL, atol=TOL)
    # the left-padded row's bias follows its logical positions, not its slots
    assert not np.allclose(np.stack(got)[:, 0], np.stack(got)[:, 1], atol=1e-3)


def models(tiny, weights: str):
    """Both packages' models, in fp32 or with int8 weights and KV cache, the
    port's read in 16-slot buckets."""
    _, jmodel, jparams, tmodel, _ = tiny
    if weights == "int8":
        jmodel, jparams = quantize_checkpoint(jmodel, jparams)
        jmodel = JaxMapperatorinator(dataclasses.replace(
            jmodel.config, backbone=dataclasses.replace(jmodel.config.backbone, quantized_kv=True)))
        tmodel = quantize_model(tmodel)
    return jmodel, jparams, with_flash(tmodel, True, decode_attend_bucket=16, quantized_kv=weights == "int8")


def engines(tiny, weights: str = "fp32"):
    jmodel, jparams, tmodel = models(tiny, weights)
    vocab = tiny[4]
    return (JaxDecodeEngine(jmodel, jparams, MAX_LEN, vocab.pad_id),
            DecodeEngine(tmodel, MAX_LEN, vocab.pad_id, device="cpu"), vocab)


def encoded(jeng, teng, rows: int, cfg_scale: float):
    frames = audio(rows // 2 if cfg_scale > 1 else rows)
    jenc, tenc = jeng.encode_with_cond(frames), teng.encode_with_cond(frames)
    if cfg_scale > 1:
        jenc, tenc = jnp.concatenate([jenc, jenc]), torch.cat([tenc, tenc])
    return jenc, tenc


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_greedy_decode_matches_jax(tiny, weights, rows, cfg_scale):
    """Greedy to the end of the buffer, with no EOS; the CFG pair's prompts
    are left-padded to different lengths (14 and 20 tokens)."""
    jeng, teng, vocab = engines(tiny, weights)
    if weights == "int8":
        assert sum(isinstance(m, QDense) for m in teng.model.modules()) == 2 * 5 + 2 * 8 + 1  # + proj_out
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = decode_prompt(vocab, 2)[::-1][:rows].copy()
    jp, tp = both_pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    want, want_end = jeng.generate(jenc, ids, jp, [], seed=0, cfg_scale=cfg_scale)
    got, got_end = teng.generate(tenc, ids, tp, [], seed=0, cfg_scale=cfg_scale)
    assert got_end == int(want_end) == MAX_LEN and got.shape == (rows, MAX_LEN)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(got[0, ids.shape[1]:].tolist())) > 1


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_forced_scores_match_jax(tiny, cfg_scale):
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
    assert_scores_close_but_nucleus_ties(got, want, TOL)


def assert_scores_close_but_nucleus_ties(got, want, tol):
    """``assert_scores_close``, but for a near tie at a step's top-p cut: two
    tokens whose scores agree within ``tol`` may trade places there, so
    where the kept sets differ, each step keeps as many tokens and every
    token kept by one side only scores within ``tol`` of the other side's
    lowest kept score."""
    got, want = np.asarray(got), np.asarray(want)
    flips = np.argwhere(np.isneginf(got) != np.isneginf(want))
    for row, step in {tuple(f[:2]) for f in flips}:
        g, w = got[row, step], want[row, step]
        assert np.isfinite(g).sum() == np.isfinite(w).sum(), (row, step)
        for mine, other in ((g, w), (w, g)):
            only = np.isfinite(mine) & np.isneginf(other)
            assert np.abs(mine[only] - other[np.isfinite(other)].min()).max() <= tol, (row, step)
        both = np.isfinite(g) & np.isfinite(w)
        np.testing.assert_allclose(g[both], w[both], rtol=tol, atol=tol)
        got = got.copy()
        got[row, step] = w  # compared above
    assert_scores_close(got, want, tol)


@pytest.mark.parametrize("num_beams,cfg_scale", [(3, 1.0), (2, 3.0)])
def test_greedy_beams_match_jax(tiny, num_beams, cfg_scale):
    jeng, teng, vocab = engines(tiny)
    rows = 2
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = decode_prompt(vocab, rows)
    jp, tp = both_pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)
    kw = dict(num_beams=num_beams, max_length=40, length_penalty=1.0, cfg_scale=cfg_scale)
    want, want_len = jeng.generate_beams(jenc, ids, jp, eos, **kw)
    got, got_len = teng.generate_beams(tenc, ids, tp, eos, **kw)
    assert got.shape == want.shape == (rows // (2 if cfg_scale > 1 else 1), 64 + 40)
    assert (got[:, 64:] != vocab.pad_id).sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_logits_match_jax_bf16(tiny, flash):
    _, jmodel, jparams, tmodel, _ = tiny
    jm = JaxMapperatorinator(dataclasses.replace(jmodel.config, backbone=dataclasses.replace(
        jmodel.config.backbone, dtype=jnp.bfloat16)))
    tm = with_flash(tmodel, flash, dtype=torch.bfloat16)
    frames = audio(2)
    ids, mask = prompt(2, 40, tm.cfg.vocab_size_in)
    want, _ = jm.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                       decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                 decoder_attention_mask=torch.from_numpy(mask)).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert rel < REL_TOL, rel
    assert agree > ARGMAX_AGREEMENT, agree


def test_quantize_model_is_bit_equal_to_jax(tiny):
    _, jmodel, jparams, tmodel, _ = tiny
    _, jq = quantize_checkpoint(jmodel, jparams)
    want = params_from_flax(jq)
    got = quantize_model(tmodel).state_dict()
    del want["transformer.decoder.embed_tokens.weight"]  # the HF token table: the port's decoder holds none
    assert set(got) == set(want)
    gates = [n for n in got if n.endswith("fc1_gate.kernel_q")]
    assert len(gates) == 4 and all(got[n].dtype == torch.int8 for n in gates)
    for name in got:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name


def test_seeded_weights_round_trip_through_a_native_checkpoint_jax_reads(tmp_path):
    """``init_params`` covers a T5 model: the relative-position tables (unit
    normal), the gate, RMSNorm scales of 1; written with
    ``save_checkpoint``, the JAX ``load_checkpoint`` restores them into its
    own init's tree."""
    args = tiny_args("v32", T5)
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    model = build_model(cfg, "cpu")
    init_params(model, 3)
    state = model.state_dict()
    rel = state["transformer.encoder.rel_bias.embedding.weight"]
    assert rel.shape == (32, 2) and abs(float(rel.std()) - 1) < 0.3
    assert state["transformer.decoder.layers.0.ffn.fc1_gate.weight"].std() > 0
    save_checkpoint(tmp_path, cfg, state, vocab)
    _, jparams, _ = jax_load_checkpoint(tmp_path)
    assert "rel_bias" in jparams["params"]["transformer"]["decoder"]
    want = params_from_flax(jparams)
    assert set(want) == set(state) and all(torch.equal(want[k], state[k]) for k in state)
