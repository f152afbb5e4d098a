"""The port's ``python -m mapperatorinator_tpu_torch.diffusion_sample``
against the repo's ``diffusion_sample.py`` on ``SIMPLE_OSU``: one DiT
bundle that the JAX package writes (every leaf drawn from a seeded normal),
read by both, as the sampler and as the refine model, at CFG 1.5, two
variants; the port's keyed noise source replays the JAX script's key tree
(``PRNGKey(seed)``, one split for the starting noise, one for the loop,
whose steps split along it, then one a refine step). The sampled sequences
must agree within 1e-4 (in the sampler's [-1, 1] units) and the written
.osu files, variants and refined variants under the same names, be equal.

The script respaces the 1 000-step process to ``--num-sampling-steps`` over
its whole length, whose noisiest step multiplies eps by about 10^3 in
``pred_xstart``; at 2 steps this test keeps that step and the last one (t =
0), so both the clip of a noise-dominated prediction and a step near the
data run, without the long noisy loop over which the random DiT's
sensitivity to x grows the frameworks' one-step differences beyond any
fp32 bar (see ``tests/test_torch_diffusion_pipeline.py``).
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_sample as jax_diffusion_sample
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.diffusion import export as jax_export
from mapperatorinator_tpu.diffusion.vocab import DiffusionVocab as JaxDiffusionVocab
from mapperatorinator_tpu_torch import diffusion_sample
from mapperatorinator_tpu_torch.config import load_diffusion_config
from mapperatorinator_tpu_torch.diffusion.vocab import DiffusionVocab
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_beatmap import SIMPLE_OSU
from tests.test_torch_config import plain
from tests.test_torch_dit import jax_model

SEED = 4


def sample_noise(seed):
    """The port's keyed noise source, giving the JAX script's draws."""

    def noise(shape, where):
        rng, init = jax.random.split(jax.random.PRNGKey(seed))
        rng, loop = jax.random.split(rng)
        kind, k = where
        if kind == "init":
            return np.asarray(jax.random.normal(init, shape, jnp.float32))
        key = loop if kind == "sample" else rng
        for _ in range(k + 1):
            key, step = jax.random.split(key)
        return np.asarray(jax.random.normal(jax.random.split(step)[0], shape, jnp.float32))

    return noise


def record(sink, export):
    def wrapped(seq, ref_beatmap, version):
        sink.append(np.array(seq))
        return export(seq, ref_beatmap, version)

    return wrapped


def test_diffusion_config_is_the_jax_composition():
    """``--config-name v1``: the port's composition of
    ``configs/diffusion/v1.yaml`` is what the JAX loader composes, and gives
    the bundles' 48 classes."""
    composed = compose(REPO_ROOT / "configs" / "diffusion", "v1", schema_cls=schema.DiffusionTrainConfig)
    loaded = load_diffusion_config("v1")
    assert plain(loaded) == plain(composed)
    assert DiffusionVocab.from_args(loaded).num_tokens == JaxDiffusionVocab.from_args(composed).num_tokens == 48
    with pytest.raises(ValueError, match="v2"):
        load_diffusion_config("v2")


def test_diffusion_sample_matches_the_jax_script(tmp_path, monkeypatch):
    _, _, params = jax_model(context_size=272, class_size=48)
    bundle = tmp_path / "bundle"
    bundle.mkdir()
    (bundle / "params.msgpack").write_bytes(flax.serialization.to_bytes(params))
    (bundle / "dit_config.json").write_text(
        '{"in_channels": 2, "context_size": 272, "hidden_size": 32, "depth": 2, "num_heads": 2, '
        '"mlp_ratio": 4.0, "class_size": 48, "learn_sigma": true}')
    osu = tmp_path / "toy.osu"
    osu.write_text(SIMPLE_OSU, encoding="utf-8")
    argv = ["--beatmap", str(osu), "--ckpt", str(bundle), "--num-sampling-steps", "2", "--num-variants", "2",
            "--refine-ckpt", str(bundle), "--refine-iters", "2", "--cfg-scale", "1.5", "--difficulty", "4.5",
            "--seed", str(SEED), "--seq-len", "3"]

    want_seqs, got_seqs = [], []
    monkeypatch.setattr(jax_export, "sequence_to_beatmap", record(want_seqs, jax_export.sequence_to_beatmap))
    monkeypatch.setattr(diffusion_sample, "sequence_to_beatmap", record(got_seqs, diffusion_sample.sequence_to_beatmap))
    want = jax_diffusion_sample.main(jax_diffusion_sample.parse_args([*argv, "--output-dir", str(tmp_path / "jax")]))
    got = diffusion_sample.main(diffusion_sample.parse_args([*argv, "--output-dir", str(tmp_path / "torch"),
                                                             "--device", "cpu"]), noise=sample_noise(SEED))

    assert len(got) == len(want) == 4  # 2 variants + 2 refined
    assert len(got_seqs) == 4
    half_field = np.array([256.0, 192.0])[:, None]
    for got_seq, want_seq in zip(got_seqs, want_seqs):  # positions in the sampler's [-1, 1] units, the rest equal
        np.testing.assert_allclose(got_seq[:2] / half_field, want_seq[:2] / half_field, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got_seq[2:], want_seq[2:])
    assert np.abs(got_seqs[0][:2] - got_seqs[1][:2]).max() > 1.0  # the variants differ
    for got_path, want_path in zip(got, want):
        assert got_path.name == want_path.name
        assert got_path.read_text(encoding="utf-8") == want_path.read_text(encoding="utf-8")
    orig_types = [type(h).__name__ for h in Beatmap.from_string(SIMPLE_OSU).hit_objects()]
    assert [type(h).__name__ for h in Beatmap.from_path(got[-1]).hit_objects()] == orig_types


def test_diffusion_sample_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    args = diffusion_sample.parse_args(["--beatmap", "x.osu", "--ckpt", str(tmp_path)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        diffusion_sample.main(args)
