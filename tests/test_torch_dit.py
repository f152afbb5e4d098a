"""The port's DiT (``models/dit.py``) against the JAX one, at tiny widths.

Both packages run the same weights: a flax parameter tree whose every leaf
(the adaLN modulations and the final projection, which flax initialises to
zero, included) is drawn from a seeded numpy normal, bridged into the port
by ``dit_params_from_flax``. On the CPU the port's attention is the plain
version of kernel B, which the kernel tests hold the kernel to on a card.

* ``forward`` and ``forward_with_cfg`` against ``model.apply`` at atol 1e-5,
  with no mask, and with the pipeline's ``banded_attention_mask & key_valid``
  given to the port as ``(band, key_valid)``;
* the padded-keys contract of ``tests/test_diffusion.py::
  test_dit_padded_keys_do_not_affect_real_rows`` on the port;
* the parameter bridge both ways, ``init_dit_params``, and bundles: one the
  JAX package writes (``flax.serialization.to_bytes``) read by the port's
  ``load_diffusion_model``, and one the port writes read by the JAX one.
"""

import dataclasses
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.models.dit import DiT as JaxDiT
from mapperatorinator_tpu.models.dit import DiTConfig as JaxDiTConfig
from mapperatorinator_tpu.models.dit import banded_attention_mask
from mapperatorinator_tpu.models.dit import timestep_embedding as jax_timestep_embedding
from mapperatorinator_tpu_torch.inference import load_diffusion_model
from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig, timestep_embedding
from mapperatorinator_tpu_torch.models.io import save_dit_bundle
from mapperatorinator_tpu_torch.models.params import (dit_params_from_flax, dit_params_to_flax, flatten,
                                                      init_dit_params)

TOL = 1e-5
TINY = dict(in_channels=2, hidden_size=32, depth=2, num_heads=2, class_size=8)


def jax_model(context_size=20, seed=0, **kw):
    """(JAX DiT, port DiT, flax params) with every leaf drawn N(0, 0.05)."""
    cfg = {**TINY, "context_size": context_size, **kw}
    model = JaxDiT(JaxDiTConfig(**cfg))
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 8, cfg["in_channels"])),
                                 jnp.zeros((2,), jnp.int32), jnp.zeros((2, 8, context_size)),
                                 jnp.zeros((2, cfg["class_size"])))
    rng = np.random.default_rng(1 + seed)
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(0.0, 0.05, p.shape), jnp.float32), params)
    port = DiT(DiTConfig(**cfg))
    port.load_state_dict(dit_params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return model, port.eval(), params


def inputs(n, t_len, context_size=20, class_size=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, (n, t_len, 2)).astype(np.float32)
    t = rng.integers(0, 1000, n).astype(np.int32)
    c = rng.standard_normal((n, t_len, context_size)).astype(np.float32)
    y = (rng.random((n, class_size)) < 0.3).astype(np.float32)
    return x, t, c, y


def as_torch(*xs):
    return [torch.as_tensor(x) for x in xs]


def test_timestep_embedding_matches_jax():
    """Within 1e-6 + 2^-23 |t|: XLA's fp32 ``exp`` of the frequencies is off
    by an ulp in 10 of 64 (torch's in 1 of 64, against float64 rounded), and
    an ulp of a frequency (at most 2^-24, the frequencies being at most 1)
    moves the argument t * freq by up to 2^-24 |t| (3e-5 at t = 1024, where
    ``FirstLayer`` embeds x * 512 with x in [-2, 2]); the bar is twice
    that."""
    t = np.array([0, 1, 7, 99, 999, 312.5, 1024.0, -817.3, 1800.0], np.float32)
    for dim in (128, 256, 7):
        want = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.as_tensor(t), dim).numpy()
        assert (np.abs(got - want) <= 1e-6 + 2.0**-23 * np.abs(t)[:, None]).all()


@pytest.mark.parametrize("band,t_len,bucket", [(None, 12, 12), (4, 12, 12), (4, 12, 16), (3, 20, 32), (64, 9, 16)],
                         ids=["dense", "band", "band-padded", "band-padded-2", "wide-band-padded"])
def test_forward_and_cfg_match_jax(band, t_len, bucket):
    model, port, params = jax_model()
    x, t, c, y = inputs(4, bucket)
    key_valid = np.arange(bucket) < t_len
    mask = None
    if band is not None:
        mask = jnp.asarray(np.asarray(banded_attention_mask(bucket, band)) & key_valid[None, None, None, :])
    kv = None if band is None else torch.as_tensor(key_valid)
    want = model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(y), mask)
    got = port(*as_torch(x, t, c, y), band=band, key_valid=kv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1  # every layer computed something

    want = model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(c), jnp.asarray(y), 1.7, mask,
                       method=JaxDiT.forward_with_cfg)
    got = port.forward_with_cfg(*as_torch(x, t, c, y), 1.7, band=band, key_valid=kv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_band_and_key_mask_equal_the_dense_mask():
    """``(band, key_valid)`` on the port is the JAX pipeline's dense
    ``banded_attention_mask(bucket, band) & key_valid``, per batch row."""
    model, port, params = jax_model(context_size=272)
    x, t, c, y = inputs(2, 32, context_size=272)
    band, lengths = 5, [32, 19]
    key_valid = np.arange(32)[None] < np.array(lengths)[:, None]
    mask = np.asarray(banded_attention_mask(32, band)) & key_valid[:, None, None, :]
    want = model.apply(params, *map(jnp.asarray, (x, t, c, y)), jnp.asarray(mask))
    got = port(*as_torch(x, t, c, y), band=band, key_valid=torch.as_tensor(key_valid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_padded_keys_do_not_affect_real_rows():
    """The bucket padding contract of the JAX test of the same name: a padded
    chunk with its padded keys masked gives the unpadded rows' outputs."""
    _, port, _ = jax_model()
    x, t, c, y = inputs(2, 12)
    band, bucket = 4, 16
    ref = port(*as_torch(x, t, c, y), band=band)
    pad = ((0, 0), (0, bucket - 12), (0, 0))
    out = port(*as_torch(np.pad(x, pad), t, np.pad(c, pad), y), band=band,
               key_valid=torch.arange(bucket) < 12)
    np.testing.assert_allclose(out[:, :12].detach().numpy(), ref.detach().numpy(), rtol=0, atol=TOL)


def test_band_below_one_raises():
    _, port, _ = jax_model()
    with pytest.raises(ValueError, match="band"):
        port(*as_torch(*inputs(2, 8)), band=0)


def test_bridge_round_trip_and_names():
    model, port, params = jax_model()
    tree = jax.tree_util.tree_map(np.asarray, params)
    back = flatten(dit_params_to_flax(port.state_dict()))
    want = flatten(tree)
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], leaf)
    names = set(port.state_dict())
    assert {"context_embedder.proj.weight", "t_embedder.fc1.weight", "y_embedder.fc2.bias", "blocks.1.adaln.weight",
            "blocks.0.qkv.weight", "blocks.1.out_proj.bias", "blocks.0.mlp_fc1.weight", "blocks.1.mlp_fc2.weight",
            "final_layer.adaln.weight", "final_layer.proj.bias"} <= names
    assert port.blocks[0].qkv.weight.shape == (96, 32)
    np.testing.assert_array_equal(port.blocks[0].qkv.weight.detach().numpy(),
                                  tree["params"]["blocks_0"]["qkv"]["kernel"].T)


def test_init_dit_params():
    """Every tensor drawn from N(0, std), so every path computes something
    (flax's zero adaLN would make eps = 0); seeded."""
    port = DiT(DiTConfig(**TINY, context_size=20))
    x, t, c, y = as_torch(*inputs(2, 8))
    init_dit_params(port, 0, std=0.02)
    first = {k: v.clone() for k, v in port.state_dict().items()}
    assert all(v.abs().max() > 0 for v in first.values())
    assert 0.015 < port.blocks[0].qkv.weight.std() < 0.025
    assert port(x, t, c, y).abs().max() > 0
    init_dit_params(port, 0, std=0.02)
    assert all(torch.equal(first[k], v) for k, v in port.state_dict().items())
    init_dit_params(port, 1, std=0.02)
    assert not torch.equal(first["blocks.0.qkv.weight"], port.blocks[0].qkv.weight)


def test_load_diffusion_model_reads_a_jax_bundle(tmp_path):
    """A bundle as the JAX ``diffusion_train.py`` exports it (flax
    ``to_bytes`` of the params, the config without its dtype), read by the
    port's loader; the port's own bundle read by the JAX loader; a missing
    one is None in both."""
    model, port, params = jax_model(context_size=272, class_size=48)
    bundle = tmp_path / "jax_bundle"
    bundle.mkdir()
    (bundle / "params.msgpack").write_bytes(flax.serialization.to_bytes(params))
    cfg = model.config
    (bundle / "dit_config.json").write_text(json.dumps({k: v for k, v in dataclasses.asdict(cfg).items()
                                                        if k != "dtype"}))
    loaded = load_diffusion_model(str(bundle), torch.device("cpu"))
    assert loaded.cfg == DiTConfig(**{**TINY, "context_size": 272, "class_size": 48})
    x, t, c, y = inputs(2, 16, context_size=272, class_size=48)
    want = model.apply(params, *map(jnp.asarray, (x, t, c, y)))
    np.testing.assert_allclose(loaded(*as_torch(x, t, c, y)).detach().numpy(), np.asarray(want), rtol=0, atol=TOL)

    save_dit_bundle(tmp_path / "port_bundle", loaded)
    jax_model_back, jax_params = jax_inference.load_diffusion_model(str(tmp_path / "port_bundle"))
    again = jax_model_back.apply(jax_params, *map(jnp.asarray, (x, t, c, y)))
    np.testing.assert_array_equal(np.asarray(again), np.asarray(want))

    assert load_diffusion_model(str(tmp_path / "missing"), torch.device("cpu")) is None
    assert load_diffusion_model("", torch.device("cpu")) is None
