"""The port's held-out eval harness (``python -m mapperatorinator_tpu_torch.test``)
against the repo's JAX ``test.py``, on the CPU.

* The port's eval step and the JAX one on the same batch of the tiny
  checkpoint: the loss and the logits within the model bar (2e-4,
  test_model.py:77), with sample weights and ignored labels.
* Both ``Analysis`` accumulators fed the same predictions and labels (and
  rhythm complexities): every table equal.
* Both ``main``s on the two-map ORS set of test_eval_harness.py with
  ``eval.steps=1``, from the same ``random`` / ``np.random`` seeds: both
  passes, the same ``test_results.json`` keys, the same stats (the losses
  within the model bar) and analysis tables.
* ``make_batch_factory`` against ``build_model_and_data``'s factory: the
  same batches of both splits from the same seeds.
"""

import importlib.util
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.train.step import make_eval_step as jax_make_eval_step
from mapperatorinator_tpu_torch import test as harness
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
from mapperatorinator_tpu_torch.osu.vocab import Vocabulary
from mapperatorinator_tpu_torch.train.main import build_model_and_data, make_batch_factory
from mapperatorinator_tpu_torch.train.step import make_eval_step
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN, TGT_SEQ_LEN, make_tiny_checkpoint
from tests.test_eval_harness import _make_ors
from tests.test_torch_data import TINY_MODEL, data_overrides, write_ors
from tests.test_torch_train import batch_arrays

torch.set_num_threads(1)

MODEL_TOL = 2e-4  # test_model.py:77


def jax_harness():
    """The repo's ``test.py``, loaded by path: the name ``test`` is also the
    standard library's package."""
    spec = importlib.util.spec_from_file_location("jax_eval_harness", REPO_ROOT / "test.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("harness")
    ckpt = make_tiny_checkpoint(root / "ckpt")
    return root, ckpt, _make_ors(root / "ors")


def test_eval_step_matches_jax(tiny):
    _, ckpt, _ = tiny
    jmodel, jparams, _ = jax_load_checkpoint(ckpt)
    model, _ = load_checkpoint(ckpt)
    batch = batch_arrays(model.cfg.vocab_size_in)
    want_loss, want_logits = jax_make_eval_step(jmodel)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, logits = make_eval_step()(model, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=MODEL_TOL, atol=MODEL_TOL)


def test_analysis_tables_equal_the_jax_ones(tiny):
    _, ckpt, _ = tiny
    jax_module = jax_harness()
    jvocab = jax_load_checkpoint(ckpt)[2]
    vocab = Vocabulary.from_pretrained(ckpt)
    rng = np.random.default_rng(4)
    ts = (jvocab.event_start[jax_module.EventType.TIME_SHIFT], jvocab.event_end[jax_module.EventType.TIME_SHIFT])
    want, got = jax_module.Analysis(2048.0), harness.Analysis(2048.0)
    for _ in range(3):
        labels = rng.integers(0, jvocab.vocab_size_out, (4, 64))
        labels = np.where(rng.random(labels.shape) < 0.5, rng.integers(*ts, labels.shape), labels)
        labels[:, -5:] = -100
        labels[1, 20] = jvocab.eos_id
        preds = np.where(rng.random(labels.shape) < 0.6, labels + rng.integers(-2, 3, labels.shape),
                         rng.integers(0, jvocab.vocab_size_out, labels.shape))
        rhythm = rng.uniform(0, 4.5, 4)
        want.update(preds, labels, jvocab, rhythm)
        got.update(preds, labels, vocab, rhythm)
    want_tables, got_tables = want.tables(), got.tables()
    assert json.dumps(got_tables) == json.dumps(want_tables)
    assert np.isfinite(got_tables["timing_precision"]["acc"]).all()


def harness_argv(root, ckpt, ors):
    return ["-cn", "v32", f"checkpoint_path={ckpt}", "data.dataset_type=ors",
            "data.descriptors_path=datasets/beatmap_descriptors.csv", f"data.train_dataset_path={ors}",
            f"data.test_dataset_path={ors}", "data.train_dataset_start=0", "data.train_dataset_end=1",
            "data.test_dataset_start=0", "data.test_dataset_end=1", f"data.src_seq_len={SRC_SEQ_LEN}",
            f"data.tgt_seq_len={TGT_SEQ_LEN}", "data.mappers_path=", "data.tags_metadata_path=",
            "optim.batch_size=2", "eval.steps=1", "optim.grad_acc=1", "dataloader.num_workers=0"]


def seeded(fn, *args):
    random.seed(0)
    np.random.seed(0)
    return fn(*args)


def test_main_matches_jax(tiny, tmp_path, monkeypatch, capsys):
    root, ckpt, ors = tiny
    argv = harness_argv(root, ckpt, ors)
    monkeypatch.chdir(tmp_path)
    want = seeded(jax_harness().main, argv)
    want_saved = json.loads((tmp_path / "test_results.json").read_text())
    (tmp_path / "test_results.json").unlink()
    capsys.readouterr()
    got = seeded(harness.main, [*argv, "device=cpu"])
    got_saved = json.loads((tmp_path / "test_results.json").read_text())
    out = capsys.readouterr().out
    assert "timing precision (offset in 10 ms steps)" in out and "wrote" in out

    assert list(got) == list(want) == ["test_noise", "test"]
    assert got_saved.keys() == want_saved.keys()
    for prefix in want:
        stats, want_stats = got[prefix]["stats"], want[prefix]["stats"]
        assert list(stats) == list(want_stats)
        assert any(key.endswith("/loss") for key in stats)
        for key, value in want_stats.items():
            if key.endswith("/time"):
                continue
            tol = MODEL_TOL if key.endswith("loss") else 0
            np.testing.assert_allclose(stats[key], value, rtol=tol, atol=tol, err_msg=f"{prefix} {key}")
        assert json.dumps(got[prefix]["analysis"]) == json.dumps(want[prefix]["analysis"])
        assert got_saved[prefix].keys() == want_saved[prefix].keys() == {"stats", "analysis"}
        for tables in got[prefix]["analysis"].values():
            assert len(tables["timing_precision"]["offset_steps"]) == 7
            assert len(tables["acc_over_time"]["acc"]) == 100
            assert len(tables["timing_acc_over_rhythm_complexity"]["acc"]) == 20


@pytest.mark.parametrize("test_split", [True, False])
def test_batch_factory_equals_the_training_one(tmp_path, test_split):
    ors = write_ors(tmp_path / "ors", seconds=4.0, objects=8)
    args = load_train_config("v32", ["device=cpu", "mixed_precision=no", *data_overrides(ors, src=128, tgt=192),
                                     *TINY_MODEL, "optim.batch_size=2", "dataloader.num_workers=0",
                                     "dataloader.balancer_buffer_size=4", "dataloader.drop_last=true"])
    _, _, trained = build_model_and_data(args, torch.device("cpu"))
    vocab = build_vocabulary(args)
    alone = make_batch_factory(args, BeatmapParser(args, vocab), vocab)
    want = seeded(lambda: list(trained(test=test_split)))
    got = seeded(lambda: list(alone(test=test_split)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)
