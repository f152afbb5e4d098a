"""The port's ``CheckpointManager`` keeps the best checkpoint through
retention, as the JAX one does (``tests/test_train_loop.py::
test_best_checkpoint_tracking``): saves of steps 1-4 with eval losses 3.0,
5.0, 4.0 and 2.0 at ``total_limit=2``. Both managers run the same sequence
and must leave the same step directories, the same best step and a
restorable best checkpoint; the artifact hook is driven with a stand-in
wandb module, as the JAX test drives its own."""

import json
import shutil
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.train.loop import CheckpointManager as JaxCheckpointManager
from mapperatorinator_tpu_torch.train.loop import CheckpointManager, MetricsLogger
from mapperatorinator_tpu_torch.train.step import TrainState

SAVES = ((1, 3.0), (2, 5.0), (3, 4.0), (4, 2.0))  # (step, eval loss)


def port_state(step: int) -> TrainState:
    """A small model whose weights encode the step, and its optimizer."""
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.fill_(float(step))
        model.bias.fill_(-float(step))
    return TrainState(step=step, model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1))


def jax_state(step: int) -> dict:
    return {"step": jnp.asarray(step, jnp.int32), "w": jnp.full((3, 2), float(step), jnp.float32)}


def step_dirs(directory: Path) -> set[str]:
    return {p.name for p in directory.iterdir() if p.is_dir() and not p.name.startswith(".")}


def test_best_checkpoint_survives_retention(tmp_path):
    ckpts = CheckpointManager(tmp_path / "ckpt", total_limit=2)
    ckpts.set_metadata({"src_seq_len": 1024, "format": "torch.save"})
    ckpts.save(1, port_state(1), metrics={"step": 1, "eval_loss": 3.0})
    ckpts.save(2, port_state(2), metrics={"step": 2, "eval_loss": 5.0})  # worse
    assert ckpts.best_step() == 1
    manifest = json.loads((tmp_path / "ckpt" / "manifest.json").read_text())
    assert manifest["best"] == {"step": 1, "eval_loss": 3.0}
    assert manifest["metadata"]["src_seq_len"] == 1024
    assert set(manifest["checkpoints"]) == {"1", "2"}

    # retention removes step 1's directory; the mirror keeps it restorable
    ckpts.save(3, port_state(3), metrics={"step": 3, "eval_loss": 4.0})
    assert ckpts.latest_step() == 3 and ckpts.all_steps() == [2, 3]
    assert ckpts.best_step() == 1
    restored = ckpts.restore_best(port_state(0))
    assert restored.step == 1
    assert torch.equal(restored.model.weight, torch.full((2, 3), 1.0))

    # a new minimum moves the mirror
    ckpts.save(4, port_state(4), metrics={"step": 4, "eval_loss": 2.0})
    assert ckpts.best_step() == 4
    restored = ckpts.restore_best(port_state(0))
    assert restored.step == 4 and torch.equal(restored.model.bias, torch.full((2,), -4.0))
    # auto-resume takes the latest numbered step, never the mirror
    assert ckpts.latest_step() == 4 and ckpts.restore(port_state(0)).step == 4
    # a fresh manager reads the best step from the manifest
    assert CheckpointManager(tmp_path / "ckpt", total_limit=2).best_step() == 4


def test_restore_best_falls_back_and_raises(tmp_path):
    ckpts = CheckpointManager(tmp_path / "ckpt", total_limit=2)
    ckpts.save(1, port_state(1), metrics={"step": 1})  # no eval loss: no best
    assert ckpts.best_step() is None
    with pytest.raises(ValueError, match="no best checkpoint"):
        ckpts.restore_best(port_state(0))
    ckpts.save(2, port_state(2), metrics={"step": 2, "eval_loss": 1.0})
    shutil.rmtree(tmp_path / "ckpt" / "best")
    assert ckpts.restore_best(port_state(0)).step == 2  # the live step directory


def test_same_steps_and_best_as_the_jax_manager(tmp_path):
    port = CheckpointManager(tmp_path / "port", total_limit=2)
    ref = JaxCheckpointManager(tmp_path / "jax", total_limit=2)
    for step, loss in SAVES:
        port.save(step, port_state(step), metrics={"step": step, "eval_loss": loss})
        ref.save(step, jax_state(step), metrics={"step": step, "eval_loss": loss})
        assert port.best_step() == ref.best_step()
        assert port.latest_step() == ref.latest_step()
        assert step_dirs(tmp_path / "port") == step_dirs(tmp_path / "jax")
        want = ref.restore_best(jax_state(0))
        got = port.restore_best(port_state(0))
        assert got.step == int(want["step"])
        np.testing.assert_array_equal(got.model.weight.detach().numpy().T, np.asarray(want["w"]))
    assert step_dirs(tmp_path / "port") == {"3", "4", "best"}


class _FakeRun:
    id = "run123"

    def __init__(self, kwargs):
        self.init_kwargs = kwargs
        self.artifacts = []

    def log(self, record, step=None):
        pass

    def log_artifact(self, art, aliases=None):
        self.artifacts.append((art, aliases))

    def finish(self):
        pass


class _FakeArtifact:
    def __init__(self, name, type, metadata=None):
        self.name, self.type, self.metadata, self.files = name, type, metadata, {}

    def add_file(self, path, artifact_path):
        self.files[artifact_path] = path


def test_artifact_hook(tmp_path, monkeypatch):
    """``artifact_sink`` gets every save with the run metadata and the step's
    metrics; ``log_checkpoint_artifact`` uploads it, aliased ``best`` on a
    new minimum (tests/test_train_loop.py::test_wandb_tracker_backend)."""
    mod = types.ModuleType("wandb")
    mod.runs = []
    mod.init = lambda **kw: mod.runs.append(_FakeRun(kw)) or mod.runs[-1]
    mod.Artifact = _FakeArtifact
    monkeypatch.setitem(sys.modules, "wandb", mod)

    logger = MetricsLogger(tmp_path / "logs", log_with="wandb", mode="offline")
    run = mod.runs[0]
    ckpts = CheckpointManager(tmp_path / "ckpt", total_limit=2)
    ckpts.set_metadata({"src_seq_len": 1024})
    ckpts.artifact_sink = logger.log_checkpoint_artifact
    ckpts.save(1, port_state(1), metrics={"step": 1, "eval_loss": 3.0})
    ckpts.save(2, port_state(2), metrics={"step": 2, "eval_loss": 5.0})  # worse: no alias

    (art1, aliases1), (art2, aliases2) = run.artifacts
    assert art1.name == "osuT5-run123" and art1.type == "model"
    assert aliases1 == ["best"] and aliases2 is None
    assert art1.metadata["src_seq_len"] == 1024 and art1.metadata["eval_loss"] == 3.0
    assert set(art1.files) == {"state.pt"} and all(not Path(p).is_absolute() for p in art1.files)
    logger.close()

    # without a live run the hook does nothing
    quiet = MetricsLogger(tmp_path / "quiet", log_with=None)
    quiet.log_checkpoint_artifact(tmp_path / "ckpt" / "2", {}, True)
    quiet.close()
