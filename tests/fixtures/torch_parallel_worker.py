"""One rank (or the single process) of a training layout of the port on the
CPU, over gloo: the child processes of ``tests/test_torch_parallel_train.py``.
It imports torch, numpy and the port only.

    python -m tests.fixtures.torch_parallel_worker SPEC.json RANK

``SPEC.json`` names the layout (``single``, ``ddp``, ``fsdp``: FSDP over a
1-D mesh, ``hsdp``: a ``(data, fsdp)`` mesh of 2 x 2; on the tensor axis
``tp2`` and ``tp3``, ``dp2tp2``: a ``(data, tensor)`` mesh of 2 x 2,
``fsdp2tp2``: ``(fsdp, tensor)``; or ``main``: the command line of
``train.main``, which joins the group itself), the world size, the port of
the group's address, the output directory and the tasks, each ``{"task":
kind, "name": key, ...}``; every rank writes ``<out>/rank<i>.json`` (rank 0
also ``.npz`` files of tensors). The ranks of one tensor group take the
same rows.
"""

from __future__ import annotations

import functools
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.lora import init_lora_params
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.params import flax_layout, flax_paths, init_params
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.parallel import (data_parallel_group, data_parallel_rank, make_global_mesh,
                                                 maybe_initialize, replicate, shard_params, tensor_partial)
from mapperatorinator_tpu_torch.parallel.sharding import gathered
from mapperatorinator_tpu_torch.train.loop import CheckpointManager, full_state_dict
from mapperatorinator_tpu_torch.train.optim import build_optimizer
from mapperatorinator_tpu_torch.train.step import (TrainState, _merged_forward, eval_model_global,
                                                   make_global_eval_step, make_lora_train_step, make_train_step,
                                                   named_flax_params, sum_grads, to_device)

torch.set_num_threads(1)
CPU = torch.device("cpu")


def mesh_layout(shape, names, fsdp=None, tensor=None):
    return SimpleNamespace(mesh_shape=shape, axis_names=names, fsdp_axis=fsdp, tensor_axis=tensor)


LAYOUTS = {"single": None, "main": None, "ddp": mesh_layout(None, ["data"]),
           "fsdp": mesh_layout(None, ["data"], fsdp="data"),
           "hsdp": mesh_layout([2, 2], ["data", "fsdp"], fsdp="fsdp"),
           "tp2": mesh_layout([2], ["tensor"], tensor="tensor"), "tp3": mesh_layout([3], ["tensor"], tensor="tensor"),
           "dp2tp2": mesh_layout([2, 2], ["data", "tensor"], tensor="tensor"),
           "fsdp2tp2": mesh_layout([2, 2], ["fsdp", "tensor"], fsdp="fsdp", tensor="tensor")}
# the JAX digest's optimizer settings (__graft_entry__._multihost_train_digest); its train step takes no MultiSteps
DIGEST_OPTIM = ["optim.warmup_steps=10", "optim.total_steps=100", "optim.grad_acc=1"]


class Run:
    def __init__(self, spec: dict, rank: int):
        self.spec, self.layout = spec, spec["layout"]
        self.rank, self.world = rank, spec["world"]
        self.parallel = LAYOUTS.get(self.layout)
        self.mesh = self.group = self.tensor_group = None
        if self.parallel is not None:
            self.mesh = make_global_mesh(self.parallel, "cpu")
            self.group = data_parallel_group(self.mesh, self.parallel.tensor_axis)
            if self.parallel.tensor_axis:
                self.tensor_group = self.mesh.get_group(self.parallel.tensor_axis)

    def shard(self, model) -> tuple:
        """(hand-reduced parameters, tensor-partial ones) of ``model`` placed
        in this layout (DDP aside)."""
        parallel = self.parallel
        if parallel is None or self.layout == "ddp":
            return (), ()
        hand_reduced = shard_params(model, self.mesh, tensor_axis=parallel.tensor_axis, fsdp_axis=parallel.fsdp_axis)
        return hand_reduced, tensor_partial(model)

    def state(self, checkpoint: str, optim: list, seed: int = 0, n_devices: int = 1, model=None) -> TrainState:
        """A fresh state of ``checkpoint``'s model in this layout (its
        parameters re-drawn from ``seed`` where it is not 0)."""
        if model is None:
            model, _ = load_checkpoint(checkpoint)
            if seed:
                init_params(model, seed)
        replica = replicate(model, CPU) if self.layout == "ddp" else None
        hand_reduced, partial = self.shard(model)
        args = load_train_config("v32", optim)
        return TrainState(0, model, build_optimizer(args, named_flax_params(model), num_processes=n_devices),
                          replica=replica, hand_reduced=hand_reduced, group=self.group, tensor_partial=partial,
                          tensor_group=self.tensor_group)

    def rows(self, full: dict) -> dict:
        """This rank's data-parallel group's share of the rows."""
        index, groups = data_parallel_rank(self.parallel) if self.parallel is not None else (0, 1)
        n = next(iter(full.values())).shape[0] // groups
        return {k: v[index * n:(index + 1) * n] for k, v in full.items()}


def random_batch(vocab, seed: int, rows: int, length: int = 32, samples: int = 128 * 63) -> dict:
    """The JAX digest's ``local_batch`` before the process's slice."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((rows, samples)).astype(np.float32),
            "decoder_input_ids": rng.integers(0, vocab.vocab_size_in, (rows, length)).astype(np.int32),
            "decoder_attention_mask": np.ones((rows, length), np.int32),
            "labels": rng.integers(0, vocab.vocab_size_out, (rows, length)).astype(np.int32)}


def flax_tensors(model, tensors) -> dict:
    """{flax path: numpy array in the flax layout} of tensors in the model's
    parameter order."""
    paths = flax_paths(model)
    return {paths[name]: flax_layout(t.detach().float(), paths[name]).numpy()
            for (name, _), t in zip(model.named_parameters(), tensors)}


def full_params(model) -> list[torch.Tensor]:
    return [gathered(p.detach(), like=p) for p in model.parameters()]


def record_updates(state: TrainState, into: list) -> None:
    """Keep (a gathered copy of) the gradients of every optimizer step."""
    inner = state.optimizer.step
    params = state.params

    def step(grads):
        into.append([gathered(g, like=p).clone() for g, p in zip(grads, params)])
        inner(grads)

    state.optimizer.step = step


def scramble(state: TrainState) -> None:
    """Fill every optimizer buffer with noise and move its count, so a
    restore has everything to overwrite."""
    gen = torch.Generator().manual_seed(7)
    opt = state.optimizer
    while hasattr(opt, "inner"):
        for t in getattr(opt, "acc", []):
            t.copy_(torch.randn(t.shape, generator=gen))
        opt = opt.inner
    for tensors in opt.buffers().values():
        for t in tensors:
            t.copy_(torch.randn(t.shape, generator=gen).abs())
    opt.count = 41


def save_npz(run: Run, path: Path, arrays: dict) -> None:
    if run.rank == 0:
        np.savez(path, **arrays)


def task_digest(run: Run, spec: dict, out: Path) -> dict:
    """The JAX ``_multihost_train_digest``: 3 steps, a save, a scramble, a
    restore, 2 more steps and a global eval; and the same 5 steps without
    the checkpoint."""
    n_devices, vocab = spec["n_devices"], load_checkpoint(spec["checkpoint"])[1]
    global_rows = 2 * n_devices
    batch = functools.lru_cache(None)(lambda seed: run.rows(random_batch(vocab, seed, global_rows)))
    step = make_train_step()
    state = run.state(spec["checkpoint"], DIGEST_OPTIM, n_devices=n_devices)
    updates = []
    record_updates(state, updates)
    losses = [step(state, batch(i + 1))[1]["loss"].item() for i in range(3)]
    checkpoints = CheckpointManager(spec["ckpt_dir"], total_limit=2)
    checkpoints.save(3, state)
    restored = run.state(spec["checkpoint"], DIGEST_OPTIM, seed=99, n_devices=n_devices)
    scramble(restored)
    restored = checkpoints.restore(restored, step=3)
    record_updates(restored, updates)
    losses += [step(restored, batch(i + 1))[1]["loss"].item() for i in range(3, 5)]
    stats = eval_model_global(make_global_eval_step(group=run.group), restored.model, [batch(100), batch(101)],
                              group=run.group)
    plain = run.state(spec["checkpoint"], DIGEST_OPTIM, n_devices=n_devices)
    uninterrupted = [step(plain, batch(i + 1))[1]["loss"].item() for i in range(5)]
    arrays = {f"update{i}/{path}": g for i, grads in enumerate(updates)
              for path, g in flax_tensors(restored.model, grads).items()}
    arrays.update({f"final/{path}": v for path, v in flax_tensors(restored.model, full_params(restored.model)).items()})
    save_npz(run, out / f"{spec['name']}.npz", arrays)
    return {"digest": [losses[0], losses[2], losses[4], stats["test/loss"], stats["test/acc"]],
            "losses": losses, "uninterrupted": uninterrupted, "restored_step": restored.step}


def fsdp_batch(vocab, rows: int = 8) -> dict:
    """``tests/test_train.py``'s batch of its fsdp8 / dp4fsdp2 step (8 rows
    from seed 0), or its first ``rows``."""
    return {k: v[:rows] for k, v in random_batch(vocab, 0, 8).items()}


LAYOUT_OPTIM = ["optim.name=adamwscale", "optim.warmup_steps=10", "optim.total_steps=100", "optim.grad_acc=1"]


def task_layout(run: Run, spec: dict, out: Path) -> dict:
    """Two adamwscale updates on ``fsdp_batch`` (one per step) in this
    layout; the losses, the parameters after, and a checkpoint."""
    state = run.state(spec["checkpoint"], LAYOUT_OPTIM)
    batch = run.rows(fsdp_batch(load_checkpoint(spec["checkpoint"])[1], spec.get("rows", 8)))
    step = make_train_step()
    metrics = [step(state, batch)[1] for _ in range(2)]
    final = full_params(state.model)
    if "ckpt_dir" in spec:
        CheckpointManager(spec["ckpt_dir"]).save(2, state)
    save_npz(run, out / f"{spec['name']}.npz", flax_tensors(state.model, final))
    return {"losses": [m["loss"].item() for m in metrics], "grad_l2": [m["grad_l2"].item() for m in metrics],
            "weights_l2": [m["weights_l2"].item() for m in metrics],
            "sharded": sum(isinstance(p, DTensor) for p in state.model.parameters()),
            "hand_reduced": len(state.hand_reduced)}


def task_restore(run: Run, spec: dict, out: Path) -> dict:
    """Restore each of ``sources``' checkpoints into a scrambled state of this
    layout: the full parameters and optimizer buffers equal the file's, and
    one more step's loss."""
    batch = run.rows(fsdp_batch(load_checkpoint(spec["checkpoint"])[1]))
    result = {}
    for name, directory in spec["sources"].items():
        state = run.state(spec["checkpoint"], LAYOUT_OPTIM, seed=99)
        scramble(state)
        state = CheckpointManager(directory).restore(state)
        saved = torch.load(Path(directory) / "2" / "state.pt", map_location="cpu", weights_only=True)
        model_equal = all(torch.equal(v, saved["model"][k]) for k, v in full_state_dict(state.model).items())
        opt, want = state.optimizer.state_dict(), saved["optimizer"]
        opt_equal = opt["count"] == want["count"] and all(torch.equal(a, b) for key in ("mu", "nu")
                                                          for a, b in zip(opt[key], want[key], strict=True))
        loss = make_train_step()(state, batch)[1]["loss"].item()
        result[name] = {"model_equal": model_equal, "optimizer_equal": opt_equal, "step": state.step - 1,
                        "loss": loss}
    return result


def unequal_batch(vocab_in: int, seed: int, rows: int = 4, length: int = 32, samples: int = 128 * 63) -> dict:
    """4 rows of white-noise audio (test_torch_train.batch_arrays' kind);
    row 2, the first of rank 1's rows, is all ignored labels, row 3 padded,
    and each row has its own sample weight."""
    rng = np.random.default_rng(seed)
    frames = (0.3 * rng.standard_normal((rows, samples))).astype(np.float32)
    ids = rng.integers(3, vocab_in, (rows, length)).astype(np.int64)
    mask = np.ones((rows, length), np.int64)
    ids[3, -6:], mask[3, -6:] = 0, 0
    labels = rng.integers(3, 600, (rows, length)).astype(np.int64)
    labels[mask == 0] = -100
    labels[2] = -100
    labels[0, :5] = -100
    return {"frames": frames, "decoder_input_ids": ids, "decoder_attention_mask": mask, "labels": labels,
            "sample_weights": np.array([0.5, 1.7, 1.1, 0.8], np.float32)}


def task_unequal(run: Run, spec: dict, out: Path) -> dict:
    """Two micro-steps (grad_acc 2) on batches where the ranks hold unequal
    numbers of valid labels: each micro-step's loss and the gradients the
    optimizer got."""
    optim = ["optim.name=adamwscale", "optim.grad_acc=2", "optim.grad_clip=0", "optim.warmup_steps=2",
             "optim.total_steps=50"]
    state = run.state(spec["checkpoint"], optim)
    grads = []
    record_updates(state, grads)
    step = make_train_step()
    vocab_in = state.model.cfg.vocab_size_in
    losses = [step(state, run.rows(unequal_batch(vocab_in, seed)))[1]["loss"].item() for seed in (0, 1)]
    save_npz(run, out / f"{spec['name']}.npz", {f"micro{i}/{path}": g for i, gs in enumerate(grads)
                                                  for path, g in flax_tensors(state.model, gs).items()})
    return {"losses": losses, "updates": state.optimizer.count}


def task_lora_train(run: Run, spec: dict, out: Path) -> dict:
    """Two LoRA steps (the factors replicated, their gradients summed by
    hand): each step's loss and the factors' gradients."""
    model, _ = load_checkpoint(spec["checkpoint"])
    adapter = init_lora_params(model, rank=4, seed=0)
    hand_reduced = list(adapter.parameters()) if run.group is not None else ()
    args = load_train_config("lora", ["optim.warmup_steps=2", "optim.total_steps=50", "optim.grad_acc=1"])
    state = TrainState(0, adapter, build_optimizer(args, named_flax_params(adapter), num_processes=run.world),
                       hand_reduced=hand_reduced, group=run.group)
    grads = []
    record_updates(state, grads)
    step = make_lora_train_step(model, alpha=8.0)
    losses = [step(state, run.rows(unequal_batch(model.cfg.vocab_size_in, seed)))[1]["loss"].item()
              for seed in (2, 3)]
    paths = [path for path, _ in named_flax_params(adapter)]
    save_npz(run, out / f"{spec['name']}.npz", {f"step{i}/{path}": g.numpy() for i, gs in enumerate(grads)
                                                  for path, g in zip(paths, gs)})
    return {"losses": losses}


def task_lora_eval(run: Run, spec: dict, out: Path) -> dict:
    """The global eval of a LoRA adapter (factors B non-zero) merged into the
    base, and of the bare base, over 2 batches of 4 rows."""
    model, _ = load_checkpoint(spec["checkpoint"])
    adapter = init_lora_params(model, rank=4, seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for factors in adapter.values():
            factors.b.copy_(0.5 * torch.randn(factors.b.shape, generator=gen))
    batches = [run.rows(unequal_batch(model.cfg.vocab_size_in, seed)) for seed in (5, 6)]
    merged = make_global_eval_step(functools.partial(_merged_forward, model, alpha=8.0), group=run.group)
    base = make_global_eval_step(group=run.group)
    return {"merged": eval_model_global(merged, adapter, batches, group=run.group),
            "base": eval_model_global(base, model, batches, group=run.group)}


def task_main(run: Run, spec: dict, out: Path) -> dict:
    """``train.main`` on the spec's command line, counting the builds of the
    global eval step."""
    from mapperatorinator_tpu_torch.train import main as train_main

    builds = []
    build = train_main.make_global_eval_step

    def counted(*a, **k):
        builds.append(1)
        return build(*a, **k)

    train_main.make_global_eval_step = counted
    # the data pipeline draws its augmentations from random and np.random (seeded alike in every run)
    random.seed(0)
    np.random.seed(0)
    argv = spec["argv"] + ([f"parallel.process_id={run.rank}"] if run.world > 1 else [])
    state = train_main.main(argv, log_dir=spec["log_dir"])
    return {"step": state.step, "updates": state.optimizer.count, "eval_step_builds": len(builds),
            "sharded": sum(isinstance(p, DTensor) for p in state.model.parameters()),
            "backend": torch.distributed.get_backend() if torch.distributed.is_initialized() else None}


def family_model(spec: dict):
    """The spec's training config (``config``, ``overrides``) as a model
    holding the parameters saved at ``state``."""
    args = load_train_config(spec["config"], spec["overrides"])
    model = Mapperatorinator(build_config(args, build_vocabulary(args)))
    model.load_state_dict(torch.load(spec["state"], weights_only=True))
    return model


def task_grads(run: Run, spec: dict, out: Path) -> dict:
    """One forward and backward of a family's model in this layout on the
    spec's batch: the loss, the logits and every gradient (gathered, flax
    order), the tensor-partial leaves summed over the tensor group and
    every gradient over the data-parallel one, as the train step sums
    them."""
    model = family_model(spec)
    hand_reduced, partial = run.shard(model)
    with np.load(spec["batch"]) as f:
        batch = run.rows({k: f[k] for k in f.files})
    model.train()
    logits, loss = model(**to_device(batch, CPU))
    loss.backward()
    if run.tensor_group is not None:
        sum_grads(partial, run.tensor_group)
        sum_grads(hand_reduced, run.group)
    grads = [gathered(p.grad, like=p) for p in model.parameters()]
    save_npz(run, out / f"{spec['name']}.npz", {"logits": logits.detach().numpy(),
                                                  **{f"grad/{k}": v for k, v in flax_tensors(model, grads).items()}})
    blocks = [m.tp for m in model.modules() if getattr(m, "tp", None) is not None]
    return {"loss": loss.item(), "blocks": len(blocks), "local_blocks": sum(tg.local for tg in blocks),
            "partial": len(partial), "sharded": sum(isinstance(p, DTensor) for p in model.parameters())}


def task_decode(run: Run, spec: dict, out: Path) -> dict:
    """Greedy decode of the spec's prompts (this data-parallel group's rows)
    on the tiny checkpoint placed in this layout, through ``DecodeEngine``."""
    model, vocab = load_checkpoint(spec["checkpoint"])
    run.shard(model)
    model.eval()
    with np.load(spec["inputs"]) as f:
        rows = run.rows({"frames": f["frames"], "ids": f["ids"]})
    engine = DecodeEngine(model, spec["max_length"], vocab.pad_id, device="cpu")
    enc = engine.encode_with_cond(rows["frames"])
    tokens, end = engine.generate(enc, rows["ids"], build_logits_pipeline(vocab, do_sample=False), [vocab.eos_id],
                                  seed=0)
    caches = engine._states[next(iter(engine._states))].cache[0]["self"]["k"].shape
    return {"tokens": tokens.tolist(), "end": end, "cache_heads": caches[2]}


def task_adafactor(run: Run, spec: dict, out: Path) -> dict:
    """Three adafactor updates (grad_acc 1) on ``fsdp_batch`` in this
    layout, a save, a restore into a scrambled state, and one more update:
    the losses and the parameters after."""
    optim = ["optim.name=adafactor", "optim.warmup_steps=10", "optim.total_steps=100", "optim.grad_acc=1"]
    state = run.state(spec["checkpoint"], optim)
    batch = run.rows(fsdp_batch(load_checkpoint(spec["checkpoint"])[1]))
    step = make_train_step()
    losses = [step(state, batch)[1]["loss"].item() for _ in range(3)]
    checkpoints = CheckpointManager(spec["ckpt_dir"], total_limit=2)
    checkpoints.save(3, state)
    restored = run.state(spec["checkpoint"], optim, seed=99)
    scramble(restored)
    restored = checkpoints.restore(restored, step=3)
    losses.append(step(restored, batch)[1]["loss"].item())
    save_npz(run, out / f"{spec['name']}.npz", flax_tensors(restored.model, full_params(restored.model)))
    return {"losses": losses, "count": restored.optimizer.count}


TASKS = {"digest": task_digest, "layout": task_layout, "restore": task_restore, "unequal": task_unequal,
         "lora_train": task_lora_train, "lora_eval": task_lora_eval, "main": task_main, "grads": task_grads,
         "decode": task_decode, "adafactor": task_adafactor}


def main(spec_path: str, rank: int) -> None:
    spec = json.loads(Path(spec_path).read_text())
    out = Path(spec["out"])
    if spec["layout"] not in ("single", "main"):
        maybe_initialize(SimpleNamespace(coordinator_address=f"127.0.0.1:{spec['port']}",
                                         num_processes=spec["world"], process_id=rank, cpu_collectives="gloo"),
                         "cpu")
    run = Run(spec, rank)
    result, seconds = {}, {}
    for task in spec["tasks"]:
        t0 = time.perf_counter()
        result[task["name"]] = TASKS[task["task"]](run, task, out)
        seconds[task["name"]] = time.perf_counter() - t0
    print("seconds", json.dumps(seconds), flush=True)
    (out / f"rank{rank}.json").write_text(json.dumps(result))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
