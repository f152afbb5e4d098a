"""Multi-process training of the port on the CPU over gloo: DDP on the data
axis (``parallel/``) against the port's single process and the JAX package.
FSDP and HSDP are ``tests/test_torch_parallel_fsdp.py``'s.

The ranks are child processes (``tests/fixtures/torch_parallel_worker.py``,
which imports torch and the port only), all started at once by a module
fixture (one process, 2 DDP ranks, ``train.main`` on 1 and 2 processes);
the JAX references are computed meanwhile, the JAX digest in a process of
its own.

* (i) The JAX ``_multihost_train_digest`` (3 steps, a save, a scramble, a
  restore, 2 steps, a global eval): 2 DDP ranks equal one process at the
  JAX bar, abs 1e-5 (``__graft_entry__.py:417``), in fp32. (In bf16 each
  rank's weight gradient is rounded to bf16 before the ranks' sum, so two
  ranks differ from one process by that rounding, 2e-4 at the fifth
  loss; the JAX 1- and 2-process runs share one 8-device partition.) In
  bf16, the JAX digest's own dtype, the 2-rank digest equals the JAX one at
  ``tests/test_torch_train.py``'s bars, and its parameters equal the JAX
  Muon chain fed the port's gradients (that file's method).
* (ii) The same 5 steps without the checkpoint give the same losses.
* (iii) Ranks holding unequal numbers of valid labels (one of rank 1's rows
  all ``-100``), sample weights and ``grad_acc`` 2: each micro-step's loss
  and the gradients the optimizer gets equal ``jax.value_and_grad`` of the
  JAX loss over the global batch, at the model bar.
* (vi) The 2-rank global eval of a LoRA adapter merges its factors and
  equals the 1-process eval; 2-rank LoRA training has the 1-process
  gradients.
* (vii) ``train.main`` with ``parallel.num_processes=2 device=cpu`` trains
  on a tiny ``ors`` set, under DDP and with ``parallel.fsdp_axis=data``:
  its losses equal one process's on the same global batches at abs 1e-5,
  its norms and parameters within the model bar; with an eval after each
  step its global eval step is built once, and rank 1 logs to
  ``<log_dir>/proc1``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.models.io import save_checkpoint as jax_save_checkpoint
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu_torch.models.params import flatten, unflatten
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.fixtures.torch_parallel_worker import unequal_batch
from tests.test_torch_data import TINY_MODEL, data_overrides, write_ors
from tests.test_torch_train import ADAMW_BRANCH_TOL, MODEL_TOL, MUON_TOL, without_key_biases

JAX_BAR = 1e-5  # __graft_entry__.py:417
PHASE_TIMEOUT = 300
DIGEST_DEVICES = 8  # the JAX digest's device count: its global batch is 16 rows and its schedule stretched 8 times


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(out: Path, layout: str, world: int, tasks: list) -> list:
    out.mkdir(parents=True)
    spec = {"layout": layout, "world": world, "port": free_port(), "out": str(out), "tasks": tasks}
    (out / "spec.json").write_text(json.dumps(spec))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO_ROOT)}
    return [(out, rank, subprocess.Popen(
        [sys.executable, "-m", "tests.fixtures.torch_parallel_worker", str(out / "spec.json"), str(rank)],
        cwd=out, env=env, stdout=open(out / f"log{rank}.txt", "w"), stderr=subprocess.STDOUT))
        for rank in range(world)]


def wait(children: list) -> None:
    failed = []
    for out, rank, proc in children:
        if proc.wait(timeout=PHASE_TIMEOUT) != 0:
            failed.append(f"{out.name} rank {rank}:\n" + (out / f"log{rank}.txt").read_text()[-3000:])
    assert not failed, "\n".join(failed)


def results(out: Path, world: int) -> list:
    return [json.loads((out / f"rank{rank}.json").read_text()) for rank in range(world)]


def digest_checkpoints(root: Path) -> tuple[Path, Path]:
    """The JAX digest's model (``_tiny_v32_model`` at its widths, bf16) with
    its ``init`` parameters, and the same parameters computing in fp32."""
    model, _, vocab = graft._tiny_v32_model(d_model=32, layers=1, heads=2, ffn=64, tgt_len=32, src_len=64)
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), frames=jnp.zeros((1, 128 * 63)),
                                                decoder_input_ids=jnp.ones((1, 32), jnp.int32)))
    cfg32 = dataclasses.replace(model.config, backbone=dataclasses.replace(model.config.backbone, dtype=jnp.float32))
    jax_save_checkpoint(root / "digest_bf16", model.config, params, vocab=vocab)
    jax_save_checkpoint(root / "digest_fp32", cfg32, params, vocab=vocab)
    return root / "digest_bf16", root / "digest_fp32"


def main_argv(ors: Path, ckpt: Path, port: int, processes: int) -> list:
    """Two steps of 4 rows at a constant learning rate (the schedule, stretched
    by the process count, is all sustain) and a checkpoint at the end; no
    eval (an eval draws augmentations from the data pipeline's global RNG, so
    the batches after it differ between layouts)."""
    argv = ["-cn", "v32", "device=cpu", "mixed_precision=no", f"checkpoint_path={ckpt}",
            *data_overrides(ors, src=128, tgt=192), *TINY_MODEL, "optim.batch_size=4", "optim.grad_acc=1",
            "optim.total_steps=2", "optim.sustain_steps=2", "dataloader.num_workers=0",
            "dataloader.balancer_buffer_size=0", "logging.every_steps=1", "logging.log_with=none",
            "eval.every_steps=0", "checkpoint.every_steps=2"]
    if processes > 1:
        argv += [f"parallel.coordinator_address=127.0.0.1:{port}", f"parallel.num_processes={processes}"]
    return argv


def jax_value_and_grads(checkpoint: Path, seeds) -> list:
    """The JAX loss and gradients over each global batch of ``unequal_batch``."""
    model, params, _ = jax_load_checkpoint(checkpoint)
    batches = [unequal_batch(model.config.vocab_size_in, seed) for seed in seeds]

    def loss(p, batch):
        return model.apply(p, **{k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)[1]

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    return [(float(v), flatten(jax.device_get(g))) for v, g in (value_and_grad(params, b) for b in batches)]


def jax_digest(ckpt_dir: Path):
    """Start the JAX ``_multihost_train_digest`` on 8 virtual devices in a
    process of its own; the returned callable waits for its 5 numbers."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "--xla_force_host_platform_device_count=8"}
    code = ("import jax; jax.config.update('jax_platforms', 'cpu'); import __graft_entry__ as g; "
            f"print('DIGEST', *g._multihost_train_digest({DIGEST_DEVICES}, ckpt_dir={str(ckpt_dir)!r}))")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)

    def result() -> list:
        out, err = proc.communicate(timeout=PHASE_TIMEOUT)
        assert proc.returncode == 0, err[-3000:]
        return [float(v) for v in next(line for line in out.splitlines() if line.startswith("DIGEST")).split()[1:]]

    return result


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    jax_digest_result = jax_digest(root / "jax_digest")
    bf16, fp32 = digest_checkpoints(root)
    ors = write_ors(root / "ors")
    work = root / "runs"

    def digest_task(name, checkpoint, layout):
        return {"task": "digest", "name": name, "checkpoint": str(checkpoint), "n_devices": DIGEST_DEVICES,
                "ckpt_dir": str(work / "digest_ckpt" / f"{layout}_{name}")}

    def main_task(name, processes, *extra):
        return [{"task": "main", "name": "main", "log_dir": str(work / f"{name}_logs"),
                 "argv": main_argv(ors, work / f"{name}_ckpt", free_port(), processes) + list(extra)}]

    lora = [{"task": "lora_eval", "name": "lora_eval", "checkpoint": str(fp32)},
            {"task": "lora_train", "name": "lora_train", "checkpoint": str(fp32)}]
    children = (
        launch(work / "single", "single", 1, [digest_task("digest_fp32", fp32, "single"), *lora])
        + launch(work / "ddp", "ddp", 2, [
            digest_task("digest_fp32", fp32, "ddp"), digest_task("digest_bf16", bf16, "ddp"), *lora,
            {"task": "unequal", "name": "unequal", "checkpoint": str(fp32)}])
        + launch(work / "main1", "main", 1, main_task("main1", 1))
        + launch(work / "main2", "main", 2, main_task("main2", 2))
        + launch(work / "main2_fsdp", "main", 2, main_task("main2_fsdp", 2, "parallel.fsdp_axis=data"))
        + launch(work / "main2_eval", "main", 2, main_task("main2_eval", 2, "eval.every_steps=1", "eval.steps=2")))
    jax_refs = {"unequal": jax_value_and_grads(fp32, (0, 1)), "digest": jax_digest_result()}
    wait(children)
    worlds = {"single": 1, "ddp": 2, "main1": 1, "main2": 2, "main2_fsdp": 2, "main2_eval": 2}
    return {"work": work, "jax": jax_refs, "bf16": bf16,
            **{name: results(work / name, world) for name, world in worlds.items()}}


def npz(runs, layout: str, name: str) -> dict:
    with np.load(runs["work"] / layout / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def test_every_rank_reports_the_same_metrics(runs):
    for layout in ("ddp", "main2", "main2_fsdp", "main2_eval"):
        assert all(r == runs[layout][0] for r in runs[layout]), layout


def test_two_ranks_equal_one_process_digest(runs):
    names = ("loss@1", "loss@3", "loss@5(resumed)", "eval_loss", "eval_acc")
    single, ddp = runs["single"][0]["digest_fp32"], runs["ddp"][0]["digest_fp32"]
    for name, got, want in zip(names, ddp["digest"], single["digest"]):
        assert abs(got - want) < JAX_BAR, (name, ddp["digest"], single["digest"])
    assert ddp["restored_step"] == single["restored_step"] == 5


@pytest.mark.parametrize("layout", ["single", "ddp"])
def test_resumed_run_equals_the_uninterrupted_one(runs, layout):
    """The save / scramble / restore in the middle changes nothing: the
    five losses equal those of a run without it (ADVICE.md's digest item)."""
    for name in ("digest_fp32",) + (("digest_bf16",) if layout == "ddp" else ()):
        result = runs[layout][0][name]
        assert result["losses"] == result["uninterrupted"], name


def test_two_rank_digest_matches_the_jax_digest(runs):
    """bf16, the JAX digest's dtype: the first loss (no update yet) at the
    model bar, the later ones and the eval after Muon updates at Muon's
    (Newton-Schulz in bf16, tests/test_torch_train.py); the parameters after
    the five updates against the JAX chain fed the port's gradients."""
    got, want = runs["ddp"][0]["digest_bf16"]["digest"], runs["jax"]["digest"]
    np.testing.assert_allclose(got[0], want[0], rtol=MODEL_TOL)
    np.testing.assert_allclose(got[1:4], want[1:4], rtol=MUON_TOL[0])
    assert abs(got[4] - want[4]) < JAX_BAR

    arrays = npz(runs, "ddp", "digest_bf16")
    _, params, _ = jax_load_checkpoint(runs["bf16"])
    _, args, _ = graft._tiny_v32_model(d_model=32, layers=1, heads=2, ffn=64, tgt_len=32, src_len=64)
    args.optim.warmup_steps, args.optim.total_steps = 10, 100
    tx = jax_optim.build_optimizer(args, num_processes=DIGEST_DEVICES)
    opt_state, update = tx.init(params), jax.jit(tx.update)
    for i in range(5):
        grads = unflatten({k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith(f"update{i}/")})
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    branch = flatten(jax_optim.muon_branch_mask(params))
    for path, want_leaf in flatten(jax.device_get(params)).items():
        rtol, atol = MUON_TOL if branch[path] else ADAMW_BRANCH_TOL
        np.testing.assert_allclose(arrays[f"final/{path}"], want_leaf, rtol=rtol, atol=atol, err_msg=path)


def test_unequal_label_counts_give_the_jax_global_mean(runs):
    """Rank 0's rows hold 59 valid labels, rank 1's 26: a mean over each
    rank's own labels, averaged over the ranks, weighs rank 1's labels twice
    as much and misses this (checked on a copy whose loss divides by the
    rank's own count)."""
    result = runs["ddp"][0]["unequal"]
    assert result["updates"] == 1
    grads = npz(runs, "ddp", "unequal")
    for i, (want_loss, want_grads) in enumerate(runs["jax"]["unequal"]):
        np.testing.assert_allclose(result["losses"][i], want_loss, rtol=MODEL_TOL, atol=MODEL_TOL)
        for path, want in want_grads.items():
            np.testing.assert_allclose(grads[f"micro{i}/{path}"], np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=f"micro-step {i}: {path}")


def test_lora_under_ddp(runs):
    """The global eval merges the factors (ADVICE.md: the JAX multi-host eval
    takes the bare factors) and equals one process's; LoRA training's factor
    gradients, summed by hand, equal one process's."""
    single, ddp = runs["single"][0], runs["ddp"][0]
    for key in ("test/loss", "test/acc"):
        assert abs(ddp["lora_eval"]["merged"][key] - single["lora_eval"]["merged"][key]) < JAX_BAR, key
        assert abs(ddp["lora_eval"]["base"][key] - single["lora_eval"]["base"][key]) < JAX_BAR, key
    assert abs(ddp["lora_eval"]["merged"]["test/loss"] - ddp["lora_eval"]["base"]["test/loss"]) > 1e-3
    np.testing.assert_allclose(ddp["lora_train"]["losses"], single["lora_train"]["losses"], rtol=MODEL_TOL)
    got, want = npz(runs, "ddp", "lora_train"), npz(runs, "single", "lora_train")
    assert sorted(got) == sorted(want) and len(got) > 0
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=MODEL_TOL, atol=1e-6, err_msg=key)


def test_train_main_on_two_processes(runs):
    """``train.main`` on 2 gloo ranks, DDP and FSDP (``parallel.fsdp_axis=data``,
    its parameters sharded): the losses of one process on the same global
    batches at the JAX bar, its norms and checkpoint within the model bar;
    with an eval after
    each step, the global eval step built once for both, the test metrics
    logged by rank 0 and rank 1's log in ``proc1``."""
    work = runs["work"]
    for name in ("main2", "main2_fsdp", "main2_eval"):
        for r in runs[name]:
            assert (r["main"]["step"], r["main"]["updates"], r["main"]["backend"]) == (2, 2, "gloo")
    assert runs["main2"][0]["main"]["sharded"] == 0 < runs["main2_fsdp"][0]["main"]["sharded"]
    assert [r["main"]["eval_step_builds"] for r in runs["main2_eval"]] == [1, 1]
    assert runs["main1"][0]["main"]["backend"] is None

    def logged(name):
        return [json.loads(line) for line in (work / f"{name}_logs" / "metrics.jsonl").read_text().splitlines()]

    def losses(name):
        return [r["train/loss"] for r in logged(name) if "train/loss" in r]

    for name in ("main2", "main2_fsdp"):
        np.testing.assert_allclose(losses(name), losses("main1"), rtol=0, atol=JAX_BAR, err_msg=name)
        # the norms after a Muon update at the model bar (tests/test_torch_train.py: Newton-Schulz in bf16)
        for key in ("train/grad_l2", "train/weights_l2"):
            np.testing.assert_allclose([r[key] for r in logged(name) if key in r],
                                       [r[key] for r in logged("main1") if key in r], rtol=MODEL_TOL,
                                       err_msg=f"{name}: {key}")
    # the parameters after two updates, each tensor within the model bar in norm: Adam's normalisation turns a
    # gradient element of rounding size into a step of either sign (a few such elements a run), and Muon's
    # Newton-Schulz in bf16 magnifies last-bit differences; the key biases, whose exact gradient is 0, left out
    # (tests/test_torch_train.py and its without_key_biases)
    want = torch.load(work / "main1_ckpt" / "2" / "state.pt", weights_only=True)["model"]
    for run in ("main2", "main2_fsdp"):
        got = torch.load(work / f"{run}_ckpt" / "2" / "state.pt", weights_only=True)["model"]
        assert sorted(got) == sorted(want)
        for name in want:
            a, b = (without_key_biases(name.replace(".", "/"), t.numpy()) for t in (got[name], want[name]))
            diff, size = np.linalg.norm(a - b), np.linalg.norm(b)
            assert diff <= MODEL_TOL * size, (run, name, diff, size)
    evals = [r for r in logged("main2_eval") if "test/loss" in r]
    assert [r["step"] for r in evals] == [1, 2] and all(np.isfinite(r["test/loss"]) for r in evals)
    assert (work / "main2_eval_logs" / "proc1" / "metrics.jsonl").exists()
