"""The nGPT family (NWhisper, ``norm_scheme="ngpt"``) on the port against the
JAX package, from a published (HF-format) checkpoint that both packages
load (``tests/test_torch_convert.py`` writes it: ``-cn v32`` with
``train.model.name=OliBomby/nwhisper-base``, the backbone embedding the
decoder ids itself, a projected encoder input, d_model 32, 2 + 2 layers of 2
heads, ffn 64, 256 source frames, 128 target positions; each ``NormLinear``
weight drawn at one of its two storage keys, the scales near their inits):

* the building blocks: ``l2norm`` (0 stays 0), ``NormDense`` along each
  axis against the flax module, ``HyperResidual`` against the flax module;
* encoder states, teacher-forced logits and cached-step logits at the
  reference's 2e-4 (``test_model.py:77``), in fp32, with every attention
  call through ``flash_attention``'s plain version at ``sm_scale`` 1.0 and
  through ``attend(scaled=False)``; the cached path reads unwritten slots
  (raw zeros, normalised to 0);
* greedy decode token for token at B 1 and with a left-padded CFG pair, fp32
  and with int8 KV (``quantized_weights`` leaves nGPT's ``NormDense`` sites
  fp32, as in JAX), across the port's 16-slot read buckets;
  ``generate_forced`` scores on the processed (sampled) logits, with and
  without CFG;
* ``quantize_model`` bit-equal to the JAX ``quantize_checkpoint`` (no
  ``QDense`` anywhere), seeded weights through a native checkpoint into the
  JAX loader (``tests/test_torch_backbone_train.py`` trains the family).

The helpers here (``family_fixture`` and the ``check_*`` functions, on
``tests/test_torch_t5.py``'s engines) serve ``tests/test_torch_moonshine.py``
too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models import transformer as jax_transformer
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu.osu import EventType
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model, save_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config, build_model
from mapperatorinator_tpu_torch.models.params import init_params, params_from_flax
from mapperatorinator_tpu_torch.models.transformer import HyperResidual, NormDense, QDense, l2norm
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.test_torch_convert import FAMILY_OVERRIDES, TINY, tiny_args, write_hf_checkpoint
from tests.test_torch_decode import both_pipelines, decode_prompt
from tests.test_torch_model import audio, prompt
from tests.test_torch_t5 import MAX_LEN, assert_scores_close_but_nucleus_ties, encoded, engines, with_flash

torch.set_num_threads(1)

TOL = 2e-4  # test_model.py:77


def family_fixture(tmp_path_factory, family: str):
    """(directory, JAX model, JAX params, port model, vocab) of a tiny
    published checkpoint of ``family``."""
    directory, _, _ = write_hf_checkpoint(tmp_path_factory.mktemp(family), "v32", overrides=FAMILY_OVERRIDES[family])
    jmodel, jparams, vocab = jax_load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return family_fixture(tmp_path_factory, "nwhisper")


def check_encoder_states(tiny, flash: bool, positions: int) -> None:
    _, jmodel, jparams, tmodel, _ = tiny
    frames = audio(2)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(frames), method=JaxMapperatorinator.encode))
    with torch.no_grad():
        got = with_flash(tmodel, flash).encode(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, positions, TINY["d_model"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def check_teacher_forced_logits(tiny, monkeypatch, scale) -> None:
    """Both attention routes within 2e-4 of JAX and of each other; each
    flash call (self and cross, in every layer, on the flash route only)
    passes ``sm_scale`` ``scale``."""
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
    b = tmodel.cfg.backbone
    assert scales == [scale] * (b.encoder_layers + 2 * b.decoder_layers)
    np.testing.assert_allclose(got[True], got[False], rtol=TOL, atol=TOL)


def check_cached_decode_logits(tiny) -> None:
    """A chunked prefill of a left-padded prompt, then single steps over the
    port's 16-slot read prefix (slots past the write read as zeros)."""
    _, jm, jparams, tm, _ = tiny
    tm = with_flash(tm, True, decode_attend_bucket=16)
    frames = audio(2)
    ids, mask = prompt(2, 12, tm.cfg.vocab_size_in)
    steps = np.random.default_rng(2).integers(3, tm.cfg.vocab_size_in, (2, 22)).astype(np.int32)
    n_valid = mask.sum(1)
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None)

    apply = lambda method, *a, **kw: jm.apply(jparams, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    step = jax.jit(functools.partial(apply, "decode_step"))
    enc = apply("encode", jnp.asarray(frames))
    cache = apply("init_cache", 2, MAX_LEN, enc)
    attn = np.zeros((2, MAX_LEN), bool)
    attn[:, :12] = mask
    want = []
    logits, cache = step(apply("embed_tokens", jnp.asarray(ids)), cache, 0, self_mask=jnp.asarray(attn)[:, None, None],
                         positions=jnp.asarray(positions))
    want.append(np.asarray(logits)[:, -1])
    for i in range(steps.shape[1]):
        attn[:, 12 + i] = True
        logits, cache = step(apply("embed_tokens", jnp.asarray(steps[:, i:i + 1])), cache, 12 + i,
                             self_mask=jnp.asarray(attn)[:, None, None], positions=jnp.asarray(n_valid + i)[:, None])
        want.append(np.asarray(logits)[:, -1])

    got = []
    with torch.no_grad():
        enc_t = tm.encode(torch.from_numpy(frames))
        cache_t = tm.init_cache(2, MAX_LEN, enc_t)
        attn_t = torch.zeros((2, MAX_LEN), dtype=torch.bool)
        attn_t[:, :12] = torch.from_numpy(mask)
        logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0,
                                   self_mask=attn_t[:, None, None, :], positions=torch.from_numpy(positions))
        got.append(logits[:, -1].numpy())
        for i in range(steps.shape[1]):
            attn_t[:, 12 + i] = True
            logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(steps[:, i:i + 1]).long()), cache_t,
                                       12 + i, self_mask=attn_t[:, None, None, :],
                                       positions=torch.from_numpy(n_valid + i)[:, None],
                                       limit=min((12 + i) // 16 * 16 + 16, MAX_LEN))
            got.append(logits[:, -1].numpy())
    got = np.stack(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.stack(want), rtol=TOL, atol=TOL)


def check_greedy_decode(tiny, weights: str, rows: int, cfg_scale: float, qdense: int) -> None:
    """Greedy to the end of the buffer, with no EOS; the CFG pair's prompts
    are left-padded to different lengths (14 and 20 tokens). The int8 model
    holds ``qdense`` QDense sites."""
    jeng, teng, vocab = engines(tiny, weights)
    if weights == "int8":
        assert sum(isinstance(m, QDense) for m in teng.model.modules()) == qdense
    jenc, tenc = encoded(jeng, teng, rows, cfg_scale)
    ids = decode_prompt(vocab, 2)[::-1][:rows].copy()
    jp, tp = both_pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    want, want_end = jeng.generate(jenc, ids, jp, [], seed=0, cfg_scale=cfg_scale)
    got, got_end = teng.generate(tenc, ids, tp, [], seed=0, cfg_scale=cfg_scale)
    assert got_end == int(want_end) == MAX_LEN and got.shape == (rows, MAX_LEN)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(set(got[0, ids.shape[1]:].tolist())) > 1


def check_generate_forced(tiny, cfg_scale: float) -> None:
    """The sampled path's processed logits (temperature 0.9, top-p 0.9, the
    lookback window), step by step on forced tokens."""
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


def check_quantize_model(tiny) -> dict:
    """The port's int8 state dict, held bit for bit to the JAX one."""
    _, jmodel, jparams, tmodel, _ = tiny
    _, jq = quantize_checkpoint(jmodel, jparams)
    want = params_from_flax(jq)
    got = quantize_model(tmodel).state_dict()
    if "transformer.decoder.embed_tokens.weight" not in got:  # the HF token table: the port's decoder holds none
        del want["transformer.decoder.embed_tokens.weight"]
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == want[name].dtype and torch.equal(got[name], want[name]), name
    return got


def check_seeded_round_trip(tmp_path, family: str) -> dict:
    """``init_params`` on a model ``build_config`` makes (its stem's input
    width made the projected one, as an HF config.json states it), written
    with ``save_checkpoint``: the JAX ``load_checkpoint`` restores it into
    its own init's tree."""
    args = tiny_args("v32", FAMILY_OVERRIDES[family])
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, num_mel_bins=cfg.backbone.d_model))
    model = build_model(cfg, "cpu")
    init_params(model, 3)
    state = model.state_dict()
    save_checkpoint(tmp_path, cfg, state, vocab)
    _, jparams, _ = jax_load_checkpoint(tmp_path)
    want = params_from_flax(jparams)
    assert set(want) == set(state) and all(torch.equal(want[k], state[k]) for k in state)
    return state


def test_the_model_is_ngpt(tiny):
    _, jmodel, _, tmodel, _ = tiny
    b = tmodel.cfg.backbone
    assert (b.norm_scheme, b.position_scheme, b.input_vocab_size, b.head_dim) == (
        "ngpt", "whisper_abs", tmodel.cfg.vocab_size_in, 16)
    assert jmodel.config.backbone.norm_scheme == "ngpt" and not tmodel.cfg.embed_decoder_input
    names = set(tmodel.state_dict())
    assert not any("norm" in n for n in names if n.startswith("transformer."))  # slerps, no norms
    assert {"transformer.encoder.embed_positions", "transformer.logit_scale.weight",
            "transformer.decoder.layers.1.cross_residual.branch_scale.weight",
            "transformer.encoder.layers.0.self_attn.qk_scale.weight"} <= names
    assert tmodel.transformer.position_table == b.max_target_positions


def test_building_blocks_match_flax():
    """``l2norm`` of a zero vector is 0; ``NormDense`` normalises the flax
    kernel's axis 0 (``norm_dim_in``) or 1, which are the weight's axes 1
    and 0; ``HyperResidual`` is the flax slerp."""
    rng = np.random.default_rng(0)
    assert torch.equal(l2norm(torch.zeros(3, 8)), torch.zeros(3, 8))
    x = rng.standard_normal((3, 5, 12)).astype(np.float32)
    for norm_dim_in in (True, False):
        flax_dense = jax_transformer.NormDense(7, norm_dim_in=norm_dim_in, use_bias=True)
        params = flax_dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
        params = jax.tree.map(lambda a: a + 0.1, params)
        want = np.asarray(flax_dense.apply(params, jnp.asarray(x)))
        dense = NormDense(12, 7, True, torch.float32, norm_dim_in=norm_dim_in)
        with torch.no_grad():
            dense.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).T))
            dense.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
            got = dense(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    branch = rng.standard_normal((3, 5, 12)).astype(np.float32)
    flax_res = jax_transformer.HyperResidual(12, 0.05)
    params = flax_res.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(branch))
    params = jax.tree.map(lambda a: a * 1.5, params)
    want = np.asarray(flax_res.apply(params, jnp.asarray(x), jnp.asarray(branch)))
    res = HyperResidual(12, 0.05)
    with torch.no_grad():
        res.branch_scale.weight.copy_(torch.from_numpy(np.asarray(params["params"]["branch_scale"]["scale"])))
        got = res(torch.from_numpy(x), torch.from_numpy(branch)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_states_match_jax(tiny, flash):
    check_encoder_states(tiny, flash, 128)


def test_teacher_forced_logits_match_jax_on_both_routes(tiny, monkeypatch):
    check_teacher_forced_logits(tiny, monkeypatch, 1.0)


def test_cached_decode_logits_match_jax(tiny):
    check_cached_decode_logits(tiny)


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_greedy_decode_matches_jax(tiny, weights, rows, cfg_scale):
    check_greedy_decode(tiny, weights, rows, cfg_scale, qdense=0)


@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_forced_scores_match_jax(tiny, cfg_scale):
    check_generate_forced(tiny, cfg_scale)


def test_quantize_model_is_bit_equal_to_jax(tiny):
    got = check_quantize_model(tiny)
    assert not any(n.endswith("kernel_q") for n in got)  # every nGPT site is a NormDense: fp32
    assert all(t.dtype == torch.float32 for t in got.values())


def test_seeded_weights_round_trip_through_a_native_checkpoint_jax_reads(tmp_path):
    state = check_seeded_round_trip(tmp_path, "nwhisper")
    d = TINY["d_model"]
    np.testing.assert_allclose(state["transformer.encoder.layers.0.attn_residual.branch_scale.weight"], d**-0.5)
    np.testing.assert_allclose(state["transformer.encoder.layers.0.self_attn.qk_scale.weight"], 1 / d)
    assert state["transformer.encoder.embed_positions"][1, 0] == pytest.approx(np.sin(1.0))
