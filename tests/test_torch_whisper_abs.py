"""The whisper_abs family (stock whisper: v28, v29) on the port against the
JAX package, from a published (HF-format) checkpoint that both packages load
(``tests/test_torch_convert.py`` writes it: 2 + 2 layers, d 32, 128 source
and 128 target positions, ``-cn v28``'s vocabulary):

* encoder states (fixed sinusoids after the conv stem, LayerNorm),
  teacher-forced logits and cached-step logits (the learned position table
  at each token's logical position) at the reference's 2e-4
  (``test_convert.py:156``), on both attention routes;
* seeded weights (``init_params``: the position table, each LayerNorm)
  written as a native checkpoint that the JAX loader restores into its own
  tree;
* a greedy decode that never finishes, to the end of the position table, in
  fp32 and with int8 weights and KV: the same tokens; past that end the
  port's engine stops at the table's reach (a CUDA lookup past it would
  assert on the device), where the JAX gather returns NaN rows.

``tests/test_torch_whisper_abs_serving.py`` serves the v28 and v29 presets.
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
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode import logits as torch_logits
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model, save_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config, build_model
from mapperatorinator_tpu_torch.models.params import init_params, params_from_flax
from mapperatorinator_tpu_torch.models.transformer import Attention, LayerNorm
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.test_torch_convert import SRC_LEN, TGT_LEN, TINY, tiny_args, write_hf_checkpoint
from tests.test_torch_decode import decode_prompt
from tests.test_torch_model import audio, prompt

torch.set_num_threads(1)

TOL = 2e-4  # test_convert.py:156
TABLE = TGT_LEN  # rows of the learned decoder position table


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    directory, _, _ = write_hf_checkpoint(tmp_path_factory.mktemp("v28"), "v28")
    jmodel, jparams, vocab = jax_load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


def with_flash(tmodel, flash: bool):
    tm = Mapperatorinator(tmodel.cfg)
    tm.load_state_dict(tmodel.state_dict())
    for m in tm.modules():
        if isinstance(m, Attention):
            m.use_flash = flash
    return tm.eval()


def test_the_model_is_whisper_abs(tiny):
    _, jmodel, _, tmodel, _ = tiny
    b = tmodel.cfg.backbone
    assert (b.position_scheme, b.norm, b.d_model, b.encoder_layers, b.max_target_positions) == (
        "whisper_abs", "layer", TINY["d_model"], 2, TABLE)
    assert jmodel.config.backbone.position_scheme == "whisper_abs"
    assert sum(isinstance(m, LayerNorm) for m in tmodel.modules()) == 2 * 2 + 2 * 3 + 2  # layers' and stacks'
    assert tmodel.transformer.position_table == TABLE
    assert tmodel.transformer.decoder.embed_positions.weight.shape == (TABLE, b.d_model)


def test_seeded_weights_round_trip_through_a_native_checkpoint_jax_reads(tmp_path):
    """``-cn v28`` with no checkpoint: ``init_params`` covers the learned
    position table (unit normal) and each LayerNorm (scale 1, bias 0); the
    weights, written with ``save_checkpoint``, are what the JAX
    ``load_checkpoint`` restores into its own init's tree (the LayerNorms
    nested under ``LayerNorm_0``)."""
    args = tiny_args("v28")
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, num_mel_bins=TINY["d_model"]))
    model = build_model(cfg, "cpu")
    init_params(model, 3)
    state = model.state_dict()
    table = state["transformer.decoder.embed_positions.weight"]
    assert table.shape == (TABLE, TINY["d_model"]) and abs(float(table.std()) - 1) < 0.05
    norms = [name for name, m in model.named_modules() if isinstance(m, LayerNorm)]
    assert len(norms) == 12 and all(not state[f"{n}.bias"].any() and bool((state[f"{n}.weight"] == 1).all())
                                    for n in norms)
    save_checkpoint(tmp_path, cfg, state, vocab)
    _, jparams, _ = jax_load_checkpoint(tmp_path)
    assert "LayerNorm_0" in jparams["params"]["transformer"]["encoder"]["norm"]
    want = params_from_flax(jparams)
    assert set(want) == set(state) and all(torch.equal(want[k], state[k]) for k in state)


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_states_match_jax(tiny, flash):
    _, jmodel, jparams, tmodel, _ = tiny
    frames = audio(2)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(frames), method=JaxMapperatorinator.encode))
    with torch.no_grad():
        got = with_flash(tmodel, flash).encode(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, SRC_LEN // 2, TINY["d_model"])
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flash", [True, False])
def test_teacher_forced_logits_match_jax(tiny, flash):
    _, jmodel, jparams, tmodel, _ = tiny
    frames = audio(2)
    ids, mask = prompt(2, 40, tmodel.cfg.vocab_size_in)
    want, _ = jmodel.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                           decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = with_flash(tmodel, flash)(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                                        decoder_attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="target positions"):
        tmodel(torch.from_numpy(frames[:1]), decoder_input_ids=torch.ones((1, TABLE + 1), dtype=torch.long))


def test_cached_decode_logits_match_jax(tiny):
    """A chunked prefill of a left-padded prompt, then single steps, each at
    its logical position in the learned table."""
    _, jm, jparams, tm, _ = tiny
    max_len = 64
    frames = audio(2)
    ids, mask = prompt(2, 12, tm.cfg.vocab_size_in)
    steps = np.random.default_rng(2).integers(3, tm.cfg.vocab_size_in, (2, 8)).astype(np.int32)

    apply = lambda method, *a, **kw: jm.apply(jparams, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    step = jax.jit(functools.partial(apply, "decode_step"))
    enc = apply("encode", jnp.asarray(frames))
    cache = apply("init_cache", 2, max_len, enc)
    attn = np.zeros((2, max_len), bool)
    attn[:, :12] = mask
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    n_valid = mask.sum(1)
    want = []
    logits, cache = step(apply("embed_tokens", jnp.asarray(ids)), cache, 0,
                         self_mask=jnp.asarray(attn)[:, None, None, :], positions=jnp.asarray(positions))
    want.append(np.asarray(logits)[:, -1])
    for i in range(steps.shape[1]):
        attn[:, 12 + i] = True
        logits, cache = step(apply("embed_tokens", jnp.asarray(steps[:, i:i + 1])), cache, 12 + i,
                             self_mask=jnp.asarray(attn)[:, None, None, :],
                             positions=jnp.asarray(n_valid + i)[:, None])
        want.append(np.asarray(logits)[:, -1])

    got = []
    with torch.no_grad():
        enc_t = tm.encode(torch.from_numpy(frames))
        cache_t = tm.init_cache(2, max_len, enc_t)
        attn_t = torch.zeros((2, max_len), dtype=torch.bool)
        attn_t[:, :12] = torch.from_numpy(mask)
        logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0,
                                   self_mask=attn_t[:, None, None, :], positions=torch.from_numpy(positions))
        got.append(logits[:, -1].numpy())
        for i in range(steps.shape[1]):
            attn_t[:, 12 + i] = True
            logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(steps[:, i:i + 1]).long()), cache_t,
                                       12 + i, self_mask=attn_t[:, None, None, :],
                                       positions=torch.from_numpy(n_valid + i)[:, None])
            got.append(logits[:, -1].numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=TOL, atol=TOL)
    # a position's own row: a row left-padded by 5 steps at 5 positions less
    assert not np.allclose(np.stack(got)[:, 0], np.stack(got)[:, 1], atol=1e-3)


@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_a_decode_to_the_end_of_the_position_table_matches_jax(tiny, weights):
    """Greedy, with no EOS: the last step feeds the token at slot TABLE - 1 at
    logical position TABLE - 1, the table's last row (row 1's prompt is
    left-padded, so its positions lag its slots). Asked for more, the port
    stops there; the token buffer is the table's reach."""
    _, jmodel, jparams, tmodel, vocab = tiny
    if weights == "int8":
        jmodel, jparams = quantize_checkpoint(jmodel, jparams)
        jmodel = JaxMapperatorinator(dataclasses.replace(
            jmodel.config, backbone=dataclasses.replace(jmodel.config.backbone, quantized_kv=True)))
        qmodel = quantize_model(tmodel)
        tmodel = Mapperatorinator(dataclasses.replace(
            qmodel.cfg, backbone=dataclasses.replace(qmodel.cfg.backbone, quantized_kv=True)))
        tmodel.load_state_dict(qmodel.state_dict())
    jeng = JaxDecodeEngine(jmodel, jparams, TABLE, vocab.pad_id)
    teng = DecodeEngine(tmodel.eval(), TABLE, vocab.pad_id, device="cpu")
    ids = decode_prompt(vocab, 2)
    jp = jax_logits.build_logits_pipeline(vocab, do_sample=False)
    tp = torch_logits.build_logits_pipeline(PortVocabulary.from_state_dict(vocab.state_dict()), do_sample=False)
    jenc, tenc = jeng.encode_with_cond(audio(2)), teng.encode_with_cond(audio(2))
    for max_length in (TABLE, TABLE + 1):
        want, want_end = jeng.generate(jenc, ids, jp, [], seed=0, max_length=max_length)
        got, got_end = teng.generate(tenc, ids, tp, [], seed=0, max_length=max_length)
        assert got_end == int(want_end) == max_length and got.shape == (2, max_length)
        np.testing.assert_array_equal(got, want)
    longer, end = teng.generate(tenc, ids, tp, [], seed=0, max_length=TABLE + 40)
    assert end == TABLE + 1 and longer.shape == (2, TABLE + 1)
    np.testing.assert_array_equal(longer, got)
    with pytest.raises(ValueError, match="position table"):
        teng.forward(tenc, np.ones((1, TABLE + 1), np.int32))
