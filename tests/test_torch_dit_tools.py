"""The port's DiT and embedding tools against the repo's JAX ``utils/``
scripts, on the CPU:

* ``dit_test_toy``: the last position in-painted by a tiny DiT (seeded
  N(0, 0.02), written as a bundle both packages read) on the committed toy
  map and on a map of 140 objects (the band |q - k| <= 128), the port's
  sampler fed the draws the JAX key schedule makes (as the DDPM parity
  tests do), within the sampling bar of test_torch_diffusion_pipeline.py
  (1e-4 of the normalised position); and smoke mode end to end.
* ``plot_embeddings``: the style table and its PCA coordinates, equal up to
  each axis's sign; t-SNE falls back to PCA without ``sklearn``, and the
  plot is skipped, the points printed, without matplotlib.
* ``find_similar_beatmaps``: the same neighbours at the same distances.
* ``plot_self_similarity``: both self-similarity matrices and their RMSE,
  with CM3P and with the classifier, within CM3P's parity bar (2e-4,
  test_torch_cm3p.py).
"""

import importlib.util
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.audio.io import load_audio_file
from mapperatorinator_tpu.models import cm3p as jax_cm3p
from mapperatorinator_tpu.osu.beatmap import Beatmap as JaxBeatmap
from mapperatorinator_tpu.osu.vocab import Vocabulary as JaxVocabulary
from mapperatorinator_tpu_torch.diffusion.data import PLAYFIELD
from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
from mapperatorinator_tpu_torch.models.io import load_dit_bundle, save_dit_bundle
from mapperatorinator_tpu_torch.models.params import init_dit_params
from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
from mapperatorinator_tpu_torch.utils import dit_test_toy, find_similar_beatmaps, plot_embeddings, plot_self_similarity
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint
from tests.test_torch_classifier import jax_classifier, tiny_overrides, write_jax_bundle, write_tiny_ors
from tests.test_torch_cm3p import tiny_config
from tests.test_torch_diffusion import loop_draws, replay

torch.set_num_threads(1)

SAMPLE_TOL = 1e-4  # test_torch_diffusion_pipeline.py: a sample's normalised position
CM3P_TOL = 2e-4  # test_torch_cm3p.py
TOY = REPO_ROOT / "utils" / "toy_datasets" / "square_jumps.osu"


def jax_script(relative: str):
    """A script of the repo loaded by path, under a name of its own."""
    spec = importlib.util.spec_from_file_location("jax_" + relative.replace("/", "_")[:-3], REPO_ROOT / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny DiT bundle with 48 classes, every tensor from N(0, 0.02)."""
    model = DiT(DiTConfig(hidden_size=32, depth=2, num_heads=2, class_size=48))
    init_dit_params(model, 3, std=0.02)
    directory = tmp_path_factory.mktemp("dit") / "bundle"
    save_dit_bundle(directory, model)
    return directory


def dense_map(path, objects: int = 140):
    head = TOY.read_text().partition("[HitObjects]")[0]
    rng = np.random.default_rng(8)
    lines = [f"{int(rng.integers(0, 512))},{int(rng.integers(0, 384))},{1000 + 150 * k},1,0,0:0:0:0:"
             for k in range(objects)]
    path.write_text(head + "[HitObjects]\n" + "\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("toy", ["square_jumps", "dense"])
def test_dit_toy_predictions_match_jax(bundle, tmp_path, toy):
    jax_tool = jax_script("utils/dit_test_toy.py")
    jax_inference = jax_script("inference.py")
    path = TOY if toy == "square_jumps" else dense_map(tmp_path / "dense.osu")
    jmodel, jparams = jax_inference.load_diffusion_model(str(bundle))
    n, steps, seed = 4, 6, 5
    want, want_actual = jax_tool.predict_last_position(jmodel, jparams, JaxBeatmap.from_path(path),
                                                       num_predictions=n, num_sampling_steps=steps, seed=seed)
    beatmap = Beatmap.from_path(path)
    seq_len = len(beatmap.hit_objects())
    assert (seq_len > dit_test_toy.BAND) == (toy == "dense")
    source = replay(loop_draws(jax.random.PRNGKey(seed), (n, seq_len, 2), steps, with_start=True))
    got, actual = dit_test_toy.predict_last_position(load_dit_bundle(bundle).eval(), beatmap, num_predictions=n,
                                                     num_sampling_steps=steps, source=source)
    assert source.left() == 0
    np.testing.assert_array_equal(actual, want_actual)
    scale = np.asarray(PLAYFIELD) / 2
    np.testing.assert_allclose(got / scale, np.asarray(want) / scale, rtol=0, atol=SAMPLE_TOL)
    assert np.isfinite(got).all() and got.std(axis=0).min() > 0  # the draws move the predictions apart


def test_dit_toy_runs_from_the_command_line(bundle, capsys):
    args = dit_test_toy.parse_args(["--ckpt", str(bundle), "--num-predictions", "3", "--num-sampling-steps", "4",
                                    "--device", "cpu"])
    results = dit_test_toy.run(args)
    smoke = dit_test_toy.run(dit_test_toy.parse_args(["--num-predictions", "2", "--num-sampling-steps", "3",
                                                      "--smoke-hidden", "32", "--device", "cpu"]))
    assert [r["toy"] for r in results] == [r["toy"] for r in smoke] == ["square_jumps.osu"]
    assert all(np.isfinite(r["mean_err_px"]) for r in results + smoke)
    assert "smoke mode" in capsys.readouterr().out
    again = dit_test_toy.run(args)
    assert again == results  # the seed fixes the draws


def test_plot_embeddings_match_jax(bundle, tmp_path, monkeypatch, capsys):
    jax_tool = jax_script("utils/plot_embeddings.py")
    want_emb = jax_tool.load_style_embeddings(str(bundle), num_classes=40)
    got_emb = plot_embeddings.load_style_embeddings(str(bundle), num_classes=40)
    np.testing.assert_array_equal(got_emb, want_emb)
    assert got_emb.shape == (40, 32)
    want = jax_tool.reduce_2d(want_emb, "pca")
    args = plot_embeddings.parse_args(["--ckpt", str(bundle), "--num-classes", "40", "--method", "pca",
                                       "--out", str(tmp_path / "emb.png")])
    got = plot_embeddings.run(args)
    assert (tmp_path / "emb.png").exists()
    signs = np.sign((got * want).sum(axis=0))
    np.testing.assert_allclose(got * signs, want, rtol=1e-5, atol=1e-6)

    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    fallback = plot_embeddings.run(plot_embeddings.parse_args(["--ckpt", str(bundle), "--num-classes", "40",
                                                               "--out", str(tmp_path / "tsne.png")]))
    out = capsys.readouterr().out
    assert "falling back to PCA" in out and "matplotlib is not installed" in out
    np.testing.assert_array_equal(fallback, got)
    assert not (tmp_path / "tsne.png").exists()


def test_find_similar_beatmaps_matches_jax(bundle):
    jax_script("utils/plot_embeddings.py")  # the JAX script imports it by name from utils/
    jax_tool = jax_script("utils/find_similar_beatmaps.py")
    argv = ["--ckpt", str(bundle), "--idx", "7", "-k", "5", "--num-classes", "40"]
    want = jax_tool.run(jax_tool.parse_args(argv))
    got = find_similar_beatmaps.run(find_similar_beatmaps.parse_args(argv))
    assert [i for i, _ in got] == [i for i, _ in want] and len(got) == 5 and 7 not in [i for i, _ in got]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want], rtol=1e-6)


@pytest.fixture(scope="module")
def embedders(tmp_path_factory):
    """The maps, the song, and a tiny CM3P and classifier bundle that the
    JAX package writes."""
    root = tmp_path_factory.mktemp("ssm")
    ors = write_tiny_ors(root / "ors", seconds=9.0)
    vocab = JaxVocabulary.from_pretrained(make_tiny_checkpoint(root / "ckpt"))
    config = tiny_config(vocab_size=vocab.vocab_size_in)
    params = jax_cm3p.Cm3p(config).init(jax.random.PRNGKey(6), input_ids=jnp.ones((1, 8), jnp.int32),
                                        frames=jnp.zeros((1, 64 * 63), jnp.float32))
    cm3p = jax_cm3p.save_cm3p(root / "cm3p", config, params, vocab)
    jargs, jvocab, _, clf_params = jax_classifier(tiny_overrides(ors), seed=13)
    classifier = write_jax_bundle(root / "classifier", jargs, jvocab, clf_params)
    maps = [ors / f"Track0000{i}" / "beatmaps" / "map0.osu" for i in range(2)]
    return maps, ors / "Track00000" / "audio.wav", {"--cm3p": cm3p, "--classifier": classifier}


@pytest.mark.parametrize("flag", ["--cm3p", "--classifier"])
def test_self_similarity_matches_jax(embedders, tmp_path, flag, monkeypatch, capsys):
    import calc_fid as jax_calc_fid

    (real, generated), wav, bundles = embedders
    jax_tool = jax_script("utils/plot_self_similarity.py")
    argv = [str(real), str(generated), str(wav), flag, str(bundles[flag])]
    want_rmse = jax_tool.main(argv)
    if flag == "--cm3p":
        jbundle = jax_cm3p.load_cm3p(bundles[flag])
        audio = load_audio_file(wav, jbundle[2].sample_rate)
        feats = [jax_cm3p.extract_cm3p_features(JaxBeatmap.from_path(p), audio, jbundle, batch_size=8)
                 for p in (real, generated)]
    else:
        jbundle = jax_calc_fid.load_classifier(types.SimpleNamespace(classifier_ckpt=str(bundles[flag])))
        audio = load_audio_file(wav, jbundle[2].model.spectrogram.sample_rate)
        feats = [jax_calc_fid.extract_features(p, audio, jbundle, batch_size=8) for p in (real, generated)]
    want = [np.clip((jax_calc_fid.compute_self_similarity(f) + 1) / 2, 0, 1) for f in feats]

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = plot_self_similarity.main([*argv, "--device", "cpu", "-o", str(tmp_path / "ssm.png")])
    assert "matplotlib is not installed" in capsys.readouterr().out
    for key, matrix in zip(("real", "generated"), want):
        assert got[key].shape == matrix.shape and matrix.shape[0] > 4
        np.testing.assert_allclose(got[key], matrix, rtol=CM3P_TOL, atol=CM3P_TOL, err_msg=key)
    assert abs(got["ssm_rmse"] - want_rmse) <= CM3P_TOL and want_rmse > 0
