"""The port's rhythm-complexity estimator against the JAX package's.

OsuR at small widths (a window of 8 tokens, hidden 16): its logits and its
loss, unweighted and weighted by ``sample_weights``, from the same flax
weights and seeded numpy inputs, within 2e-4 (tests/test_model.py:77);
``calc_rhythm_complexity`` against the JAX script's function on every map
of a small ORS set; ``rcomplexion_inference`` and ``rcomplexion_test``
against the JAX scripts' ``main`` (the CSV they write, the entropy grid and
its summary), and the message that replaces the plot where matplotlib is
not installed.
"""

import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rcomplexion_inference as jax_rc_inference
import rcomplexion_test as jax_rc_test
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.classifier import OsuR as JaxOsuR
from mapperatorinator_tpu.models.classifier import OsuRConfig as JaxOsuRConfig
from mapperatorinator_tpu.osu import Beatmap as JaxBeatmap
from mapperatorinator_tpu.rcomplexion import RParser as JaxRParser
from mapperatorinator_tpu.rcomplexion import RTokenizer as JaxRTokenizer
from mapperatorinator_tpu_torch import rcomplexion_inference, rcomplexion_test
from mapperatorinator_tpu_torch.config import load_rcomplexion_config
from mapperatorinator_tpu_torch.models.classifier import OsuR, OsuRConfig
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.osu import Beatmap
from mapperatorinator_tpu_torch.rcomplexion import RParser, RTokenizer
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_torch_data import write_ors

torch.set_num_threads(1)

TOL = 2e-4


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(ORS root, OsuR weights dir, overrides, JAX model, its params)."""
    root = tmp_path_factory.mktemp("rc")
    ors = write_ors(root / "ors", tracks=2, seconds=8.0, maps=2, objects=24)
    overrides = [f"data.train_dataset_path={ors}", "data.train_dataset_start=0", "data.train_dataset_end=2",
                 "data.src_seq_len=8", "model.hidden_size=16", f"model_path={root / 'osur'}"]
    args = compose(REPO_ROOT / "configs" / "rcomplexion", "inference_v1", overrides=overrides,
                   schema_cls=schema.RcomplexionConfig)
    tokenizer = JaxRTokenizer(args)
    model = JaxOsuR(JaxOsuRConfig(vocab_size_in=tokenizer.vocab_size_in, vocab_size_out=tokenizer.vocab_size_out,
                                  src_seq_len=8, hidden_size=16))
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    (root / "osur").mkdir()
    (root / "osur" / "params.msgpack").write_bytes(flax.serialization.to_bytes(params))
    return ors, overrides, model, params


def port_osur(params, vocab_in, vocab_out):
    model = OsuR(OsuRConfig(vocab_size_in=vocab_in, vocab_size_out=vocab_out, src_seq_len=8, hidden_size=16))
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params))))
    return model


def test_osur_logits_and_weighted_loss_match_jax(setup):
    _, _, jmodel, params = setup
    cfg = jmodel.config
    model = port_osur(params, cfg.vocab_size_in, cfg.vocab_size_out)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size_in, (6, 8))
    labels = rng.integers(0, cfg.vocab_size_out, 6)
    weights = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    for w in (None, weights):
        want = jmodel.apply(params, jnp.asarray(ids), labels=jnp.asarray(labels),
                            sample_weights=None if w is None else jnp.asarray(w))
        for dtype in (np.int64, np.int32):
            with torch.no_grad():
                got = model(torch.tensor(ids.astype(dtype)), torch.tensor(labels),
                            None if w is None else torch.tensor(w))
            close(got["logits"].numpy(), want["logits"])
            close(got["loss"].item(), want["loss"])


def test_calc_rhythm_complexity_matches_jax(setup):
    ors, overrides, jmodel, params = setup
    jargs = compose(REPO_ROOT / "configs" / "rcomplexion", "inference_v1", overrides=overrides,
                    schema_cls=schema.RcomplexionConfig)
    args = load_rcomplexion_config("inference_v1", overrides)
    tokenizer, jtokenizer = RTokenizer(args), JaxRTokenizer(jargs)
    assert (tokenizer.vocab_size_in, tokenizer.vocab_size_out) == (jtokenizer.vocab_size_in, jtokenizer.vocab_size_out)
    model = port_osur(params, tokenizer.vocab_size_in, tokenizer.vocab_size_out)
    apply_fn = rcomplexion_inference.osur_logits(model, torch.device("cpu"))
    paths = sorted(ors.glob("Track*/beatmaps/*.osu"))
    assert len(paths) == 4
    for path in paths:
        want = jax_rc_inference.calc_rhythm_complexity(
            JaxBeatmap.from_path(path), lambda ids: jmodel.apply(params, jnp.asarray(ids))["logits"], jtokenizer,
            JaxRParser(jargs.data), jargs)
        got = rcomplexion_inference.calc_rhythm_complexity(Beatmap.from_path(path), apply_fn, tokenizer,
                                                           RParser(args.data), args)
        assert want > 0
        close(got, want)


def test_inference_and_test_scripts_match_jax(setup, tmp_path, monkeypatch, capsys):
    ors, overrides, _, _ = setup
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card and no device=cpu: no CPU fallback
        rcomplexion_inference.main(["-cn", "inference_v1", *overrides])
    want = jax_rc_inference.main(["-cn", "inference_v1", *overrides])
    want_csv = (tmp_path / "rhythm_complexities.csv").read_text().splitlines()
    got = rcomplexion_inference.main(["-cn", "inference_v1", *overrides, "device=cpu"])
    got_csv = (tmp_path / "rhythm_complexities.csv").read_text().splitlines()
    assert list(got) == list(want) and len(got) == 4
    close(list(got.values()), list(want.values()))
    assert [line.split(",")[0] for line in got_csv] == [line.split(",")[0] for line in want_csv]
    assert "4/4 beatmaps scored" in capsys.readouterr().out

    want = jax_rc_test.main(["-cn", "inference_v1", *overrides, "-o", str(tmp_path / "jax.png")])
    want_summary = capsys.readouterr().out.splitlines()[0]
    got = rcomplexion_test.main(["-cn", "inference_v1", *overrides, "-o", str(tmp_path / "port.png"), "device=cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == want_summary and (tmp_path / "port.png").exists()
    close(got, want)
    # where matplotlib is not installed (the GPU machine), a message takes the plot's place
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    again = rcomplexion_test.main(["-cn", "inference_v1", *overrides, "-o", str(tmp_path / "none.png"), "device=cpu"])
    assert "matplotlib is not installed" in capsys.readouterr().out and not (tmp_path / "none.png").exists()
    close(again, want)
