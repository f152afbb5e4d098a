"""The port's mapper classifier against the JAX package's, at tiny widths (2 +
2 layers, d_model 64, 4 heads, 64 source frames, 32 target tokens).

Seeded numpy inputs go through the JAX ``OsuClassifier`` (initialised by
flax) and the port's (the same weights through the parameter bridge): the
logits, the feature vector, both towers' hidden states and the loss must
agree within 2e-4 times the largest value (at least 1), with the conv stem
(``input_features``) off and on, ids int64 and int32, and a row whose
tokens are all pads (its decoder self-attention rows see no key). The
audio is loud, as a song is: the classifier embeds the unlogged power mel,
so its activations run large, and the bar is relative to them.

Also: ``transfer_from_pretrained`` on the tiny generation checkpoint (the
same tensors grafted as the JAX function grafts, and the same errors); a
bundle written by the JAX package read by ``load_classifier_bundle``, and
one written by the port read by the JAX ``calc_fid.load_classifier``; and
``classifier_classify`` / ``classifier_test`` against the JAX scripts'
``main`` on a small ORS set: the same top-100 order, the confidences and
the test metrics within the bar.
"""

import dataclasses
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calc_fid as jax_calc_fid
import classifier_classify as jax_classify
import classifier_test as jax_classifier_test
import classifier_train as jax_classifier_train
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.classifier import OsuR as JaxOsuR
from mapperatorinator_tpu.models.classifier import OsuRConfig as JaxOsuRConfig
from mapperatorinator_tpu.models.classifier import transfer_from_pretrained as jax_transfer
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu_torch import classifier_classify, classifier_test
from mapperatorinator_tpu_torch.config import load_classifier_config
from mapperatorinator_tpu_torch.models.classifier import (
    OsuR,
    OsuRConfig,
    build_classifier,
    load_classifier_bundle,
    save_classifier_bundle,
    transfer_from_pretrained,
)
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint
from tests.test_torch_data import write_ors

torch.set_num_threads(1)

TOL = 2e-4  # tests/test_model.py:77
HOP = 128
TINY = ["model.d_model=64", "model.encoder_layers=2", "model.decoder_layers=2", "model.encoder_heads=4",
        "model.decoder_heads=4", "model.encoder_ffn=128", "model.decoder_ffn=128", "model.classifier_proj_size=8",
        "data.src_seq_len=64", "data.tgt_seq_len=32", "model.spectrogram.n_mels=32", "data.dt_augment_prob=0"]


def close(got, want, tol=TOL):
    """Within ``tol`` times the largest |want| (at least 1)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, bar = np.abs(got - want).max(), tol * max(1.0, np.abs(want).max())
    assert err <= bar, (err, bar)


def write_tiny_ors(root, tracks: int = 2, seconds: float = 4.0):
    """``write_ors``'s tracks (one map each, 16 objects 400 ms apart from
    0.5 s, so the windows after 6.5 s hold none) and a mappers table that
    gives each map its own mapper."""
    write_ors(root, tracks=tracks, seconds=seconds, maps=1)
    (root / "mappers.json").write_text(json.dumps({str(10 * i): 1000 + i for i in range(tracks)}))
    return root


def tiny_overrides(ors, *extra):
    return [*TINY, f"data.mappers_path={ors / 'mappers.json'}", f"data.train_dataset_path={ors}",
            f"data.test_dataset_path={ors}", "data.train_dataset_start=0", "data.train_dataset_end=2",
            "data.test_dataset_start=0", "data.test_dataset_end=2", *extra]


def jax_classifier(overrides, seed: int = 0):
    """(args, vocab, model, params) of the JAX classifier, flax-initialised."""
    args = compose(REPO_ROOT / "configs" / "classifier", "train_v1", overrides=list(overrides),
                   schema_cls=schema.ClassifierConfig)
    vocab = jax_build_vocabulary(args)
    model = jax_classifier_train.build_classifier(args, vocab)
    params = model.init(jax.random.PRNGKey(seed), frames=jnp.zeros((1, HOP * (args.data.src_seq_len - 1))),
                        decoder_input_ids=jnp.ones((1, 8), jnp.int32))
    return args, vocab, model, params


def to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params))


def write_jax_bundle(directory, args, vocab, params):
    """The bundle ``classifier_train.py`` exports (its last lines)."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "params.msgpack").write_bytes(flax.serialization.to_bytes(params))
    with open(directory / "classifier_config.json", "w", encoding="utf-8") as f:
        json.dump({"model": dataclasses.asdict(args.model), "data": dataclasses.asdict(args.data)}, f,
                  default=lambda o: getattr(o, "value", str(o)))
    vocab.save_pretrained(directory)
    return directory


@pytest.fixture(scope="module")
def ors(tmp_path_factory):
    return write_tiny_ors(tmp_path_factory.mktemp("clf_ors"))


@pytest.mark.parametrize("input_features", [False, True])
def test_forward_matches_jax(ors, input_features):
    overrides = tiny_overrides(ors, f"model.input_features={str(input_features).lower()}")
    jargs, jvocab, jmodel, params = jax_classifier(overrides, seed=1)
    args = load_classifier_config("train_v1", overrides)
    vocab = build_vocabulary(args)
    model = build_classifier(args, vocab)
    model.load_state_dict(params_from_flax(to_numpy(params)))
    backbone = model.transformer.cfg
    assert (backbone.position_scheme, backbone.norm, backbone.conv_stem) == ("whisper_abs", "layer", input_features)
    assert backbone.max_source_positions == (32 if input_features else 64)
    assert backbone.max_target_positions == 32 and model.cfg.num_classes == jvocab.num_mapper_classes == 2
    # flax creates no decoder token table and no LM head for the classifier
    assert not hasattr(model.transformer, "proj_out") and not hasattr(model.transformer.decoder, "embed_tokens")

    rng = np.random.default_rng(2)
    frames = rng.standard_normal((3, HOP * 63)).astype(np.float32)
    ids = rng.integers(1, vocab.vocab_size_in, (3, 32))
    mask = np.ones((3, 32), bool)
    mask[1, 12:] = False
    mask[2] = False  # an empty window: every decoder self-attention row sees no key
    ids[~mask] = vocab.pad_id
    labels = np.array([0, 1, 1])
    want = jmodel.apply(params, jnp.asarray(frames), jnp.asarray(ids), decoder_attention_mask=jnp.asarray(mask),
                        labels=jnp.asarray(labels))
    for dtype in (np.int64, np.int32):
        with torch.no_grad():
            got = model(torch.tensor(frames), torch.tensor(ids.astype(dtype)), torch.tensor(mask),
                        torch.tensor(labels))
        for key in ("logits", "feature_vector", "decoder_last_hidden_state", "encoder_last_hidden_state", "loss"):
            close(got[key].numpy(), want[key])
    assert np.abs(np.asarray(want["encoder_last_hidden_state"])).max() > 1.0


def test_osur_zero_transfer_and_shape_mismatch_raise_as_in_jax(ors):
    overrides = tiny_overrides(ors, "model.position_scheme=rope", "model.norm=rms")
    _, _, _, params = jax_classifier(overrides)
    classifier = build_classifier(load_classifier_config("train_v1", overrides),
                                  build_vocabulary(load_classifier_config("train_v1", overrides)))
    osur_cfg = dict(vocab_size_in=16, vocab_size_out=8, src_seq_len=4, hidden_size=8)
    osur_params = JaxOsuR(JaxOsuRConfig(**osur_cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    with pytest.raises(ValueError, match="no transferable"):
        jax_transfer(params, osur_params)
    with pytest.raises(ValueError, match="no transferable"):
        transfer_from_pretrained(classifier, OsuR(OsuRConfig(**osur_cfg)))
    small = [*overrides, "model.d_model=32", "model.encoder_heads=2", "model.decoder_heads=2"]
    _, _, _, small_params = jax_classifier(small)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_transfer(small_params, params)
    args = load_classifier_config("train_v1", small)
    with pytest.raises(ValueError, match="shape mismatch"):
        transfer_from_pretrained(build_classifier(args, build_vocabulary(args)), classifier)


def test_transfer_from_pretrained_matches_jax(ors, tmp_path):
    """The tiny v32-architecture checkpoint's towers into a classifier of its
    family and dims (rope, RMSNorm, 128 mels): the same tensors grafted."""
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    overrides = [*tiny_overrides(ors, "model.position_scheme=rope", "model.norm=rms", "model.encoder_ffn=128",
                                 "model.decoder_ffn=128"), "model.spectrogram.n_mels=128", "data.src_seq_len=128"]
    # another seed than the checkpoint's: flax derives each leaf's init from
    # its path, which the two models share
    _, _, _, fresh = jax_classifier(overrides, seed=7)
    _, pre_params, _ = jax_load_checkpoint(ckpt)
    want = params_from_flax(to_numpy(jax_transfer(fresh, pre_params)))

    args = load_classifier_config("train_v1", overrides)
    classifier = build_classifier(args, build_vocabulary(args))
    classifier.load_state_dict(params_from_flax(to_numpy(fresh)))
    pretrained, _ = load_checkpoint(ckpt)
    got = transfer_from_pretrained(classifier, pretrained)
    assert set(got) == set(want)
    grafted = [name for name in got if not torch.equal(got[name], classifier.state_dict()[name])]
    assert len(grafted) >= 10 and all(name.startswith("transformer.") for name in grafted)
    for name in got:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_bundles_cross_between_the_packages(ors, tmp_path):
    """A bundle the JAX package writes, read by ``load_classifier_bundle``;
    one the port writes, read by the JAX ``calc_fid.load_classifier``: the
    same features."""
    jargs, jvocab, jmodel, params = jax_classifier(tiny_overrides(ors), seed=3)
    directory = write_jax_bundle(tmp_path / "jax_bundle", jargs, jvocab, params)
    model, clf_args, vocab = load_classifier_bundle(directory)
    assert (clf_args.data.src_seq_len, clf_args.data.tgt_seq_len, clf_args.model.d_model) == (64, 32, 64)
    assert clf_args.data.position_precision == jargs.data.position_precision

    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, HOP * 63)).astype(np.float32)
    ids = rng.integers(1, vocab.vocab_size_in, (2, 32))
    mask = np.ones((2, 32), bool)
    want = jmodel.apply(params, jnp.asarray(frames), jnp.asarray(ids), decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = model(torch.tensor(frames), torch.tensor(ids), torch.tensor(mask))
    close(got["feature_vector"].numpy(), want["feature_vector"])

    save_classifier_bundle(tmp_path / "port_bundle", model, load_classifier_config("train_v1", tiny_overrides(ors)),
                           vocab)
    jax_bundle = jax_calc_fid.load_classifier(type("A", (), {"classifier_ckpt": str(tmp_path / "port_bundle")}))
    again = jax_bundle[0].apply(jax_bundle[1], jnp.asarray(frames), jnp.asarray(ids),
                                decoder_attention_mask=jnp.asarray(mask))
    close(again["feature_vector"], want["feature_vector"])


def test_classify_and_test_scripts_match_jax(ors, tmp_path):
    jargs, jvocab, _, params = jax_classifier(tiny_overrides(ors), seed=5)
    directory = write_jax_bundle(tmp_path / "bundle", jargs, jvocab, params)
    beatmap = ors / "Track00001" / "beatmaps" / "map0.osu"
    base = [*tiny_overrides(ors), f"model_path={directory}", f"beatmap_path={beatmap}",
            f"audio_path={ors / 'Track00001' / 'audio.wav'}"]
    for time_s in ("time=1.5", "time=3.6"):  # the second window lies past the map's last object
        want = jax_classify.main(["-cn", "train_v1", *base, time_s])
        got = classifier_classify.main(["-cn", "train_v1", *base, time_s, "device=cpu"])
        assert [(name, mapper) for name, mapper, _ in got] == [(name, mapper) for name, mapper, _ in want]
        close([c for *_, c in got], [c for *_, c in want])

    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card and no device=cpu: no CPU fallback
        classifier_classify.main(["-cn", "train_v1", *base])

    argv = ["-cn", "train_v1", *tiny_overrides(ors), f"model_path={directory}", "optim.batch_size=2"]
    want = jax_classifier_test.main(argv)
    got = classifier_test.main([*argv, "device=cpu"])
    assert set(got) == set(want) == {"test_loss", "test_accuracy", "test_top_10_accuracy", "test_top_100_accuracy"}
    for key in want:
        close(got[key], want[key])
