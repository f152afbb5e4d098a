"""The port's evaluation harness (``python -m mapperatorinator_tpu_torch.calc_fid``)
against the JAX script.

On a small ORS set whose generated maps are already in place
(``skip_generation``), both ``main``s run every metric: the training-set
overlap, the rhythm report, the extra stats (drain, BPM and star-rating
errors), the classifier FID with its self-similarity RMSE (a tiny
classifier bundle the JAX package writes) and the CM3P FID with its own (a
tiny CM3P bundle the JAX package writes). The JSON keys must be equal, the
host metrics equal, and the FID figures within 2e-4 of each other, relative
to their size. Then the inline generation path (``num_processes=0``) on the
tiny checkpoint with ``inference.device=cpu``, which writes each map's
regeneration under ``generated/`` and reports on the pairs. The ``mmrs``
scan is held to the JAX one in ``test_torch_mmrs_web.py``.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import calc_fid as jax_calc_fid
from mapperatorinator_tpu.models import cm3p as jax_cm3p
from mapperatorinator_tpu.osu.vocab import Vocabulary as JaxVocabulary
from mapperatorinator_tpu_torch import calc_fid
from mapperatorinator_tpu_torch.config import load_fid_config
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint
from tests.test_torch_classifier import jax_classifier, tiny_overrides, write_jax_bundle, write_tiny_ors
from tests.test_torch_cm3p import tiny_config

torch.set_num_threads(1)

TOL = 2e-4


def write_generated(ors, tracks: int = 2):
    """Each track's "generated" map: the next track's map, under the
    directory ``calc_fid`` pairs it by."""
    for i in range(tracks):
        out = ors / "generated" / f"Track{i:05d}_map0"
        out.mkdir(parents=True)
        shutil.copy(ors / f"Track{(i + 1) % tracks:05d}" / "beatmaps" / "map0.osu", out / "generated.osu")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    ors = write_tiny_ors(root / "ors")
    write_generated(ors)
    jargs, jvocab, _, params = jax_classifier(tiny_overrides(ors), seed=11)
    classifier = write_jax_bundle(root / "classifier", jargs, jvocab, params)
    ckpt = make_tiny_checkpoint(root / "ckpt")
    vocab = JaxVocabulary.from_pretrained(ckpt)
    config = tiny_config(vocab_size=vocab.vocab_size_in, projection_dim=8)
    cm3p_params = jax_cm3p.Cm3p(config).init(jax.random.PRNGKey(12), input_ids=jnp.ones((1, 8), jnp.int32),
                                             frames=jnp.zeros((1, 64 * 63), jnp.float32))
    cm3p = jax_cm3p.save_cm3p(root / "cm3p", config, cm3p_params, vocab)
    (root / "train_ids.txt").write_text("10\n999\n")
    return root, ors, classifier, cm3p, ckpt


def test_main_matches_jax_number_for_number(setup, capsys):
    root, ors, classifier, cm3p, _ = setup
    argv = [f"dataset_path={ors}", "dataset_start=0", "dataset_end=2", "gamemodes=[0]", "skip_generation=true",
            f"classifier_ckpt={classifier}", "classifier_batch_size=4", "fid_cm3p=true", f"cm3p_ckpt={cm3p}",
            "cm3p_batch_size=4", f"training_set_ids_path={root / 'train_ids.txt'}"]
    want = jax_calc_fid.main(argv)
    want_out = capsys.readouterr().out
    got = calc_fid.main([*argv, "inference.device=cpu"])
    got_out = capsys.readouterr().out
    assert list(got) == list(want)
    assert set(want) >= {"training_set_overlap", "active_rhythm_f1", "passive_rhythm_f1", "drain_mse", "bpm_mse",
                         "sr_mse", "fid", "ssm_rmse", "fid_cm3p", "ssm_rmse_cm3p"}
    for key, value in want.items():
        if key.startswith(("fid", "ssm")):
            assert np.isfinite(got[key]) and abs(got[key] - value) <= TOL * max(1.0, abs(value)), (key, got, want)
        else:
            assert got[key] == value, key
    assert got_out.splitlines()[0] == want_out.splitlines()[0]  # the scan's summary line


def test_inline_generation_on_the_cpu(setup, tmp_path):
    """``num_processes=0``: the port's engine regenerates each map in this
    process, on the CPU as asked, and the report covers the pairs."""
    _, _, _, _, ckpt = setup
    ors = write_tiny_ors(tmp_path / "ors", seconds=2.0)
    argv = [f"dataset_path={ors}", "dataset_start=0", "dataset_end=2", "gamemodes=[0]", "num_processes=0",
            "fid=false", "fid_cm3p=false", "extra_stats=false", f"inference.model_path={ckpt}",
            "inference.device=cpu", "inference.seed=5", "inference.train.data.src_seq_len=256",
            "inference.train.data.tgt_seq_len=256"]
    got = calc_fid.main(argv)
    args = load_fid_config("calc_fid", argv)
    paths = calc_fid.get_beatmap_paths(args)
    assert len(paths) == 2 and all(calc_fid._already_generated(p, args) for p in paths)
    assert {"active_rhythm_precision", "passive_rhythm_f1"} <= set(got)
    assert json.loads(json.dumps(got)) == got


def test_no_card_and_no_cpu_asked_raises(setup):
    """The classifier and CM3P run on the device ``inference.device``
    selects: with no card visible and no ``inference.device=cpu``, the
    harness raises rather than run on the CPU."""
    _, ors, classifier, _, _ = setup
    args = load_fid_config("calc_fid", [f"classifier_ckpt={classifier}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calc_fid.load_classifier(args)
