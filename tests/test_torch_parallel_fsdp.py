"""Multi-process training of the port on the CPU over gloo: FSDP and HSDP on
the fsdp axis (``parallel/sharding.py``) against DDP, one process and the
JAX package, and checkpoints across layouts.

The ranks are child processes (``tests/fixtures/torch_parallel_worker.py``)
started by a module fixture in two phases: first every layout takes two
adamwscale updates on ``tests/test_train.py``'s fsdp batch (one process; 2
DDP ranks; 2 and 3 FSDP ranks; 4 HSDP ranks on a 2 x 2 ``(data, fsdp)``
mesh) and saves a checkpoint; then one process, 2 DDP ranks and 2 FSDP
ranks each restore every layout's checkpoint.

* (iv) Losses, gradient and weight norms and parameters after the 2
  updates equal DDP's (FSDP over 2, HSDP over 4) or one process's (FSDP
  over 3 on 6 rows: 3 divides few of the tiny widths, so some leaves stay
  replicated and the step sums their gradients by hand) at the model bar,
  fp32; the first loss equals JAX's fsdp8 and dp4fsdp2 step (bf16) at that
  test's bar, 2e-3 (``tests/test_train.py:302-303``).
* (v) Every layout restores every layout's checkpoint: the full parameters
  and optimizer buffers equal the file's, and the next step's loss is one
  process's.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import __graft_entry__ as graft
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.parallel import shard_batch, shard_params
from mapperatorinator_tpu.parallel.mesh import ensure_on_mesh
from mapperatorinator_tpu.train import make_train_step as jax_make_train_step
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu.train.step import init_train_state
from tests.fixtures.torch_parallel_worker import fsdp_batch
from tests.test_torch_parallel_train import JAX_BAR, digest_checkpoints, launch, results, wait
from tests.test_torch_train import MODEL_TOL

FSDP_BAR = 2e-3  # tests/test_train.py:302-303


def jax_fsdp_losses(checkpoint: Path) -> dict:
    """``tests/test_train.py``'s fsdp8 and dp4fsdp2 steps: their losses."""
    model, params, vocab = jax_load_checkpoint(checkpoint)
    _, args, _ = graft._tiny_v32_model(d_model=32, layers=1, heads=2, ffn=64, tgt_len=32, src_len=64)
    args.optim.name, args.optim.warmup_steps, args.optim.total_steps = "adamwscale", 10, 100
    tx = jax_optim.build_optimizer(args)
    batch = fsdp_batch(vocab)
    losses = {}
    for name, (shape, axes, fsdp) in {"fsdp8": ((8,), ("data",), "data"),
                                      "dp4fsdp2": ((4, 2), ("data", "fsdp"), "fsdp")}.items():
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(shape), axes)
        state = ensure_on_mesh(mesh, init_train_state(shard_params(mesh, params, fsdp_axis=fsdp), tx))
        _, metrics = jax_make_train_step(model, tx, mesh=mesh)(state, shard_batch(mesh, batch), jax.random.PRNGKey(1))
        losses[name] = float(metrics["loss"])
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_fsdp")
    bf16, fp32 = digest_checkpoints(root)
    work = root / "runs"

    def layout(name, rows=8):
        task = {"task": "layout", "name": f"layout{rows}", "checkpoint": str(fp32), "rows": rows}
        return task if rows != 8 else {**task, "ckpt_dir": str(work / "ckpt" / name)}

    children = (launch(work / "single", "single", 1, [layout("single"), layout("single", rows=6)])
                + launch(work / "ddp", "ddp", 2, [layout("ddp")])
                + launch(work / "fsdp", "fsdp", 2, [layout("fsdp")])
                + launch(work / "fsdp3", "fsdp", 3, [layout("fsdp3", rows=6)])
                + launch(work / "hsdp", "hsdp", 4, [layout("hsdp")]))
    jax_losses = jax_fsdp_losses(bf16)
    wait(children)

    sources = {name: str(work / "ckpt" / name) for name in ("single", "ddp", "fsdp", "hsdp")}
    restore = [{"task": "restore", "name": "restore", "checkpoint": str(fp32), "sources": sources}]
    wait(launch(work / "restore_single", "single", 1, restore) + launch(work / "restore_ddp", "ddp", 2, restore)
         + launch(work / "restore_fsdp", "fsdp", 2, restore))
    worlds = {"single": 1, "ddp": 2, "fsdp": 2, "fsdp3": 3, "hsdp": 4, "restore_single": 1, "restore_ddp": 2,
              "restore_fsdp": 2}
    return {"work": work, "jax": jax_losses, **{name: results(work / name, world) for name, world in worlds.items()}}


def npz(runs, layout: str, name: str) -> dict:
    with np.load(runs["work"] / layout / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def test_every_rank_reports_the_same_metrics(runs):
    for layout in ("ddp", "fsdp", "fsdp3", "hsdp", "restore_ddp", "restore_fsdp"):
        assert all(r == runs[layout][0] for r in runs[layout]), layout


@pytest.mark.parametrize("layout,reference,rows", [("fsdp", "ddp", 8), ("hsdp", "ddp", 8), ("ddp", "single", 8),
                                                   ("fsdp3", "single", 6)])
def test_sharded_layouts_match_ddp_and_jax(runs, layout, reference, rows):
    name = f"layout{rows}"
    got, want = runs[layout][0][name], runs[reference][0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(got["grad_l2"], want["grad_l2"], rtol=MODEL_TOL)
    np.testing.assert_allclose(got["weights_l2"], want["weights_l2"], rtol=MODEL_TOL)
    params, ref = npz(runs, layout, name), npz(runs, reference, name)
    assert sorted(params) == sorted(ref)
    for path in ref:
        np.testing.assert_allclose(params[path], ref[path], rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)
    if layout in ("fsdp", "hsdp"):
        assert got["sharded"] > 0
        jax_loss = runs["jax"]["fsdp8" if layout == "fsdp" else "dp4fsdp2"]
        assert abs(got["losses"][0] - jax_loss) < FSDP_BAR, (got["losses"][0], runs["jax"])
    if layout == "fsdp3":
        assert got["sharded"] > 0 and got["hand_reduced"] > 0, got


@pytest.mark.parametrize("restorer", ["restore_single", "restore_ddp", "restore_fsdp"])
def test_every_layout_restores_every_checkpoint(runs, restorer):
    result = runs[restorer][0]["restore"]
    assert sorted(result) == ["ddp", "fsdp", "hsdp", "single"]
    for source, r in result.items():
        assert r["model_equal"] and r["optimizer_equal"] and r["step"] == 2, (source, r)
    reference = runs["restore_single"][0]["restore"]["single"]["loss"]
    for source, r in result.items():
        assert abs(r["loss"] - reference) < JAX_BAR, (source, r["loss"], reference)
