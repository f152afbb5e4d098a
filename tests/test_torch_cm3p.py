"""The port's CM3P against the JAX package's, at tiny widths (2 layers a
tower, d_model 64, 4 heads, 64 source frames, 32 beatmap tokens).

Seeded numpy inputs go through the JAX ``Cm3p`` (initialised by flax) and
the port's (the same weights through the parameter bridge):
``encode_beatmap`` (ids int32 and int64, a ragged mask and an empty window,
whose embedding is the zero vector), ``encode_audio``, the logits and the
symmetric InfoNCE loss, within 2e-4 (tests/test_model.py:77), with the
towers at ``Cm3pConfig``'s defaults (RoPE, RMSNorm) and as the torch
layout's twin has them (no positions, LayerNorm). Also: a bundle written by
the JAX ``save_cm3p`` read by the port's ``load_cm3p``, and the port's read
by the JAX one; both converters on one ``pytorch_model.bin``;
``extract_cm3p_features`` against the JAX function on a song longer than
the map (its last windows hold only pads); and the parser defaults the port
keeps for it against the JAX ``DataConfig()``.
"""

import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.audio.io import load_audio_file
from mapperatorinator_tpu.config import schema
from mapperatorinator_tpu.models import cm3p as jax_cm3p
from mapperatorinator_tpu.models.transformer import TransformerConfig as JaxTransformerConfig
from mapperatorinator_tpu.osu import Beatmap as JaxBeatmap
from mapperatorinator_tpu.osu.vocab import Vocabulary as JaxVocabulary
from mapperatorinator_tpu_torch.config import PARSER_DATA_DEFAULTS
from mapperatorinator_tpu_torch.models.cm3p import (
    Cm3p,
    config_from_dict,
    convert_cm3p_state_dict,
    extract_cm3p_features,
    load_cm3p,
    save_cm3p,
)
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.osu import Beatmap
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint
from tests.test_cm3p import _torch_style_state_dict
from tests.test_torch_data import write_ors

torch.set_num_threads(1)

TOL = 2e-4
HOP = 64
TOWERS = {
    "rope": dict(position_scheme="rope", norm="rms"),
    "none": dict(position_scheme="none", norm="layer"),
}


def tiny_config(tower="rope", vocab_size=128, projection_dim=16):
    tower_cfg = JaxTransformerConfig(d_model=64, encoder_layers=2, encoder_heads=4, encoder_ffn=128,
                                     max_source_positions=64, conv_stem=False, **TOWERS[tower])
    return jax_cm3p.Cm3pConfig(beatmap_backbone=tower_cfg, audio_backbone=tower_cfg, vocab_size=vocab_size,
                               projection_dim=projection_dim, n_mels=16, n_fft=256, hop_length=HOP,
                               src_seq_len=64, tgt_seq_len=32)


def jax_model(config, seed=0):
    model = jax_cm3p.Cm3p(config)
    params = model.init(jax.random.PRNGKey(seed), input_ids=jnp.ones((2, 32), jnp.int32),
                        frames=jnp.zeros((2, HOP * 63), jnp.float32))
    return model, params


def port_model(config, params):
    model = Cm3p(config_from_dict(jax_cm3p._config_to_dict(config)))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params))))
    return model


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def inputs(vocab_size, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab_size, (3, 32)).astype(np.int32)
    mask = np.ones((3, 32), np.int32)
    mask[1, 12:] = 0
    mask[2] = 0  # an empty window: the beatmap tower sees no key, the pool divides by max(0, 1)
    ids[mask == 0] = 0
    frames = (rng.standard_normal((3, HOP * 63)) * 0.5).astype(np.float32)
    return ids, mask, frames


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_forward_matches_jax(tower):
    config = tiny_config(tower)
    jmodel, params = jax_model(config, seed=2)
    model = port_model(config, params)
    ids, mask, frames = inputs(config.vocab_size)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(frames), attention_mask=jnp.asarray(mask),
                        return_loss=True)
    for dtype in (np.int32, np.int64):
        with torch.no_grad():
            got = model(torch.tensor(ids.astype(dtype)), torch.tensor(frames), torch.tensor(mask), return_loss=True)
        for key in ("beatmap_embeds", "audio_embeds", "logits_per_beatmap", "loss"):
            close(got[key].numpy(), want[key])
    assert not got["beatmap_embeds"][2].any()
    np.testing.assert_allclose(np.linalg.norm(got["beatmap_embeds"][:2].numpy(), axis=-1), 1.0, atol=1e-5)
    with torch.no_grad():
        close(model.encode_audio(torch.tensor(frames)).numpy(),
              jmodel.apply(params, jnp.asarray(frames), method=jax_cm3p.Cm3p.encode_audio))


def test_bundles_cross_between_the_packages(tmp_path):
    """The JAX ``save_cm3p`` bundle (with a tokenizer) read by the port, and
    the port's read by the JAX ``load_cm3p``: the same embeddings."""
    config = tiny_config()
    jmodel, params = jax_model(config, seed=3)
    vocab = JaxVocabulary.from_pretrained(make_tiny_checkpoint(tmp_path / "ckpt"))
    jax_cm3p.save_cm3p(tmp_path / "jax", config, params, vocab)
    model, port_config, port_vocab = load_cm3p(tmp_path / "jax")
    assert port_config == config_from_dict(jax_cm3p._config_to_dict(config))
    assert port_vocab.vocab_size_in == vocab.vocab_size_in and not model.training
    ids, mask, frames = inputs(config.vocab_size, seed=4)
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(frames), attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.tensor(ids), torch.tensor(frames), torch.tensor(mask))
    for key in ("beatmap_embeds", "audio_embeds", "logits_per_beatmap"):
        close(got[key].numpy(), want[key])

    save_cm3p(tmp_path / "port", model, port_vocab)
    jmodel2, params2, config2, vocab2 = jax_cm3p.load_cm3p(tmp_path / "port")
    assert config2 == config and vocab2 is not None
    again = jmodel2.apply(params2, jnp.asarray(ids), jnp.asarray(frames), attention_mask=jnp.asarray(mask))
    close(again["logits_per_beatmap"], want["logits_per_beatmap"])


def test_both_converters_read_one_pytorch_model_bin(tmp_path, capsys):
    """A torch dual-tower state dict in the converter's layout (LayerNorm
    with biases, no positions), saved as ``pytorch_model.bin``: the JAX
    loader's params and the port's state dict are the same tensors, and the
    two models the same function. Leftover keys raise in both."""
    config = tiny_config("none")
    rng = np.random.default_rng(7)
    sd = _torch_style_state_dict(config, rng)
    for key in [k for k in sd if k.endswith("layer_norm.weight")]:
        sd[key.replace(".weight", ".bias")] = rng.standard_normal(sd[key].shape[0]).astype(np.float32) * 0.1
    sd = {k: v * 0.25 if k.endswith("weight") and v.ndim == 2 else v for k, v in sd.items()}
    (tmp_path / "cm3p_config.json").write_text(json.dumps(jax_cm3p._config_to_dict(config)))
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")

    jmodel, jparams, _, _ = jax_cm3p.load_cm3p(tmp_path)
    model, _, vocab = load_cm3p(tmp_path)
    assert vocab is None
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    got = model.state_dict()
    assert set(got) == set(want)
    for name in got:
        torch.testing.assert_close(got[name], want[name].reshape(got[name].shape), rtol=0, atol=0)
    ids, mask, frames = inputs(config.vocab_size, seed=8)
    with torch.no_grad():
        out = model(torch.tensor(ids), torch.tensor(frames), torch.tensor(mask))
    close(out["logits_per_beatmap"].numpy(),
          jmodel.apply(jparams, jnp.asarray(ids), jnp.asarray(frames),
                       attention_mask=jnp.asarray(mask))["logits_per_beatmap"])

    extra = {**sd, "mystery.weight": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="unconverted"):
        convert_cm3p_state_dict(extra, config_from_dict(jax_cm3p._config_to_dict(config)))
    assert load_cm3p(tmp_path / "nope") is None
    assert "skipping fid_cm3p" in capsys.readouterr().out


def test_extract_features_matches_jax(tmp_path):
    """Every window of a song that outlasts its map: those past the last
    object hold only pads and embed to zero in both packages."""
    ors = write_ors(tmp_path / "ors", tracks=1, seconds=9.0, maps=1)
    vocab = JaxVocabulary.from_pretrained(make_tiny_checkpoint(tmp_path / "ckpt"))
    config = tiny_config(vocab_size=vocab.vocab_size_in)
    jmodel, params = jax_model(config, seed=5)
    jax_cm3p.save_cm3p(tmp_path / "cm3p", config, params, vocab)
    path = ors / "Track00000" / "beatmaps" / "map0.osu"
    audio = load_audio_file(ors / "Track00000" / "audio.wav", config.sample_rate)
    want = jax_cm3p.extract_cm3p_features(JaxBeatmap.from_path(path), audio,
                                          jax_cm3p.load_cm3p(tmp_path / "cm3p"), batch_size=4)
    got = extract_cm3p_features(Beatmap.from_path(path), audio, load_cm3p(tmp_path / "cm3p"), batch_size=4)
    assert got.shape == want.shape == (35, config.projection_dim)  # 0.252 s windows over 9 s
    close(got, want)
    assert not got[-8:].any() and got[:26].any(axis=1).sum() >= 10  # the objects end at 6.5 s


def test_parser_defaults_are_the_jax_data_config():
    defaults = schema.DataConfig()
    assert PARSER_DATA_DEFAULTS == {k: getattr(defaults, k) for k in PARSER_DATA_DEFAULTS}
