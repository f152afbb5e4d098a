"""Training entry point of the port (the repo's ``train.py`` in PyTorch).

    python -m mapperatorinator_tpu_torch.train.main -cn v32 [key=value ...]

Composes ``configs/train/<name>.yaml`` with the overrides, builds the
vocabulary, parser, dataset, model (seeded random weights, or a native
checkpoint's with ``pretrained_path``), optimizer and checkpoint manager,
resumes from the latest checkpoint under ``checkpoint_path``, saves
``tokenizer.json`` beside the checkpoints and runs :func:`.loop.train`. It
runs on the first CUDA device unless ``device=cpu`` is given, and raises
without one. Metrics go to ``<log_dir>/metrics.jsonl`` (``logs/`` under the
working directory, as for ``train.py``), and with ``profile.do_profile`` a
Chrome trace to ``<log_dir>/profile``.

``pretrained_path`` (its ``gamemode=N`` subfolder for ``pretrained_gamemode``
N, where one exists) gives the model, its compute dtype and the vocabulary,
as in the JAX ``train.py``: the checkpoint's dtype wins over
``mixed_precision``, and a difference is printed. ``enable_lora`` trains
LoRA factors (``lora``: rank, alpha, targets; seeded with ``seed``) on that
frozen base and writes the adapter to ``<checkpoint_path>/lora``.

Every backbone family trains: v32's (``-cn v32``), stock whisper (``-cn
v28``, ``-cn v29``), T5 v1.1 (``-cn t5_base``), nGPT (``-cn
nwhisper_base``) and moonshine (``-cn moonshine_tiny``), through one step,
optimizer and loop.

More than one process (the JAX ``train.py``'s multi-host run): start one
command a rank with ``parallel.coordinator_address=host:port
parallel.num_processes=N parallel.process_id=i`` (or under torchrun with
the address alone). Each rank takes its own card (``cuda:{i % count}``,
:func:`..parallel.distributed.choose_backend` for the backend), feeds its
share of every batch and trains under DDP, or, with
``parallel.fsdp_axis``, FSDP over a 1-D mesh or HSDP over a ``(data,
fsdp)`` one, or, with ``parallel.tensor_axis``, Megatron column / row
parallelism on that axis of ``parallel.mesh_shape`` (beside data and fsdp
axes; :mod:`..parallel`); the ranks of one tensor group feed the same rows.
The schedule is stretched by the process count, as the JAX one by the
device count; rank 0 logs to ``log_dir`` and writes the checkpoints, rank i
to ``<log_dir>/proc{i}``; with more than one rank the eval is the global
one (loss and accuracy, as in JAX). Under LoRA the factors are trained
replicated whatever the layout (their gradients summed by hand), the frozen
base whole on every rank, as the JAX ``train.py`` replicates it.

A mesh axis other than the data, fsdp and tensor axes raises. Each recipe
trains from its own ``dataset_type``: ``web`` (v32, ``lora``,
``v32-mini_ft``) reads the ``*.parquet`` shards of a local directory, under
``data.dataset_subset`` (``compressed``) where it is set, as in ``-cn v32
data.train_dataset_path=<dir>``; ``mmrs`` (v28, v29, ``lora_v32``) an MMRS
root (``metadata.parquet`` and ``data/<set folder>/``); ``ors`` a folder of
tracks. Parquet is read by the port's own reader
(:mod:`.data.parquet`); a web source that is not a directory (a Hugging
Face repo id) raises, since streaming it needs the network.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

import functools

import torch
import torch.distributed as dist

from ..config import load_train_config, parse_argv, select_device
from ..models.io import load_checkpoint
from ..models.lora import init_lora_params, resolve_model_checkpoint_path, save_lora
from ..models.mapperatorinator import Mapperatorinator, build_config
from ..models.params import init_params
from ..osu import BeatmapParser, build_vocabulary
from .data import build_dataset
from ..parallel import (data_parallel_group, make_global_mesh, maybe_initialize, process_index,
                        process_local_batch_size, replicate, shard_iterator_by_process, shard_params, tensor_partial,
                        world_size)
from ..parallel.distributed import rank_device
from .data.batching import batch_iterator, prefetch_iterator
from .loop import CheckpointManager, MetricsLogger, card_line, device_peak_flops, lora_step_flops, step_flops, train
from .optim import build_optimizer
from .step import (TrainState, _forward, _merged_forward, eval_model_global, make_eval_step, make_global_eval_step,
                   make_lora_eval_step, make_lora_train_step, make_train_step, named_flax_params)


def refuse_unported(args) -> None:
    """Raise for a mesh that names an axis other than the data, fsdp and
    tensor axes, which no rule of the JAX package places anything on."""
    p = args.parallel
    other = [a for a in (p.axis_names or []) if a not in (p.data_axis, p.fsdp_axis, p.tensor_axis)]
    if other:
        raise NotImplementedError(f"mesh axes {other}: neither parallel.data_axis={p.data_axis!r}, "
                                  f"parallel.fsdp_axis={p.fsdp_axis!r} nor parallel.tensor_axis={p.tensor_axis!r}")


def build_model_and_data(args, device: torch.device):
    """(model, vocab, make_batches): the model on ``device`` with seeded
    random fp32 parameters, computing in the ``mixed_precision`` dtype; or,
    with ``pretrained_path``, the checkpoint's model and vocabulary (the
    batches still come from the configured vocabulary, as in JAX)."""
    data_vocab = build_vocabulary(args)
    parser = BeatmapParser(args, data_vocab)
    config = build_config(args, data_vocab)
    if args.pretrained_path:
        pretrained = resolve_model_checkpoint_path(args.pretrained_path, gamemode=args.pretrained_gamemode)
        print(f"Loading pretrained weights from {pretrained}")
        model, vocab = load_checkpoint(pretrained)
        model, vocab = model.to(device), vocab or data_vocab
        dtype = model.cfg.backbone.dtype
        if dtype != config.backbone.dtype:
            print(f"The checkpoint computes in {dtype}: it wins over mixed_precision={args.mixed_precision!r} "
                  f"({config.backbone.dtype}), as in the JAX train.py")
    else:
        model, vocab = Mapperatorinator(config).to(device), data_vocab
        init_params(model, args.seed)
    return model, vocab, make_batch_factory(args, parser, data_vocab)


def make_batch_factory(args, parser: BeatmapParser, vocab):
    """``make_batches(test) -> iterator of collated batches`` over the
    configured dataset: the training split (token-balanced, prefetched by
    ``dataloader.num_workers`` threads) or the test split. Across processes
    each of the N data-parallel groups (the processes, or the tensor groups
    under a tensor axis) keeps every N-th example and batches
    ``optim.batch_size / N`` rows. It needs no model, so the eval harness
    builds it alone."""
    local_batch_size = process_local_batch_size(args.optim.batch_size, args.parallel)

    def make_batches(test: bool):
        dataset = build_dataset(args.data, parser, vocab, test=test)
        batches = batch_iterator(
            shard_iterator_by_process(iter(dataset), args.parallel),
            local_batch_size,
            balancer_buffer_size=args.dataloader.balancer_buffer_size if not test else 0,
            drop_last=args.dataloader.drop_last,
        )
        if not test and args.dataloader.num_workers > 0:
            batches = prefetch_iterator(batches, buffer_size=2 * args.dataloader.num_workers)
        return batches

    return make_batches


def main(argv: Optional[Sequence[str]] = None, log_dir: str = "logs") -> TrainState:
    config_name, overrides, _ = parse_argv(sys.argv[1:] if argv is None else argv, "v32", {})
    args = load_train_config(config_name, overrides)
    refuse_unported(args)
    if args.enable_lora and not args.pretrained_path:
        raise ValueError("enable_lora requires pretrained_path (LoRA fine-tunes a base model).")
    device = select_device(args)
    distributed = maybe_initialize(args.parallel, device.type)
    device = rank_device(device)
    mesh = make_global_mesh(args.parallel, device.type)
    n_processes, is_main = world_size(), process_index() == 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if is_main and device.type == "cuda":
        peak = device_peak_flops(device)
        print(f"Training on {card_line()}; MFU against {peak / 1e12:g} TFLOP/s dense bf16" if peak
              else f"Training on {card_line()}; no published peak for this card, so no MFU")
    elif is_main:
        print("Training on the CPU")
    tensor_axis = args.parallel.tensor_axis if distributed else None
    if args.parallel.tensor_axis and not distributed:
        print(f"parallel.tensor_axis={args.parallel.tensor_axis!r} without a process group: the model stays whole")
    if is_main and distributed:
        layout = [f"FSDP on {args.parallel.fsdp_axis}"] if args.parallel.fsdp_axis else []
        layout += [f"tensor parallel on {tensor_axis}"] if tensor_axis else []
        print(f"{n_processes} process(es), mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"{', '.join(layout) or 'DDP'}")
    group = data_parallel_group(mesh, tensor_axis) if distributed else None
    tensor_group = mesh.get_group(tensor_axis) if tensor_axis else None

    model, vocab, make_batches = build_model_and_data(args, device)
    replica, hand_reduced, forward, partial = None, (), _forward, ()
    if args.enable_lora:
        lora_cfg = dict(args.lora or {})
        rank = int(lora_cfg.get("r", 64))
        lora_alpha = float(lora_cfg.get("lora_alpha", 128))
        trained = init_lora_params(model, rank=rank, target_modules=lora_cfg.get("target_modules"), seed=args.seed)
        train_step, eval_step = make_lora_train_step(model, lora_alpha), make_lora_eval_step(model, lora_alpha)
        forward = functools.partial(_merged_forward, model, alpha=lora_alpha)
        if distributed:
            hand_reduced = list(trained.parameters())

        def flops(batch):
            # what the card computes, beside the JAX figure (the factors as the model)
            return {"mfu": lora_step_flops(model, trained, batch, model.cfg),
                    "mfu_jax_numerator": step_flops(trained, batch, model.cfg)}
        print(f"LoRA fine-tuning: rank={rank} alpha={lora_alpha} "
              f"({sum(p.numel() for p in trained.parameters())} trainable params)")
    else:
        trained, train_step, eval_step, flops = model, make_train_step(), make_eval_step(), None
        if distributed and (args.parallel.fsdp_axis or tensor_axis):
            hand_reduced = shard_params(model, mesh, tensor_axis=tensor_axis, fsdp_axis=args.parallel.fsdp_axis)
            partial = tensor_partial(model)
        elif distributed:
            replica = replicate(model, device)
        if tensor_axis:
            # the card's share of its group's rows: the JAX figure, the global batch over every device
            tensor_size = mesh.size(tuple(mesh.mesh_dim_names).index(tensor_axis))

            def flops(batch):
                return {"mfu": step_flops(model, batch, model.cfg) / tensor_size}
    state = TrainState(step=0, model=trained,
                       optimizer=build_optimizer(args, named_flax_params(trained), num_processes=n_processes),
                       replica=replica, hand_reduced=hand_reduced, group=group, tensor_partial=partial,
                       tensor_group=tensor_group)
    eval_fn = None
    if n_processes > 1:
        # built once, for every eval; it merges the LoRA factors, as the single-process eval does
        global_eval = make_global_eval_step(forward, state.group)

        def eval_fn(trained_model, batches, max_steps):
            return eval_model_global(global_eval, trained_model, batches, max_steps, state.group)

    ckpt_dir = Path(args.checkpoint_path or "checkpoints").resolve()
    checkpoints = CheckpointManager(ckpt_dir, total_limit=args.checkpoint.local_total_limit)
    checkpoints.set_metadata({
        "format": "torch.save",
        "src_seq_len": args.data.src_seq_len,
        "tgt_seq_len": args.data.tgt_seq_len,
        "num_classes": args.data.num_classes,
        "num_diff_classes": args.data.num_diff_classes,
        "max_difficulty": args.data.max_diff,
        "class_dropout_prob": args.data.class_dropout_prob,
        "diff_dropout_prob": args.data.diff_dropout_prob,
        "backbone": args.model.name,
    })
    latest = checkpoints.latest_step()
    if latest is not None:
        print(f"Resuming from checkpoint step {latest}")
        state = checkpoints.restore(state)

    # only rank 0 logs to the tracker; rank i keeps its own directory (train.py:222-225)
    logger = (MetricsLogger(log_dir, log_with=args.logging.log_with, run_name=args.logging.run_name,
                            mode=args.logging.mode) if is_main
              else MetricsLogger(Path(log_dir) / f"proc{process_index()}", log_with=None))
    # checkpoint saves also upload to the tracker when one is live (train.py:228-229)
    if logger.wandb_run is not None:
        checkpoints.artifact_sink = logger.log_checkpoint_artifact
    if is_main:
        vocab.save_pretrained(ckpt_dir)
    try:
        state = train(
            train_step=train_step,
            eval_step=eval_step,
            state=state,
            train_batch_factory=lambda: make_batches(test=False),
            eval_batch_factory=(lambda: make_batches(test=True)) if args.eval.every_steps > 0 else None,
            vocab=vocab,
            args=args,
            logger=logger,
            checkpoints=checkpoints,
            profile_dir=Path(log_dir) / "profile" if args.profile.do_profile else None,
            flops=flops,
            eval_fn=eval_fn,
        )
    finally:
        logger.close()
    if args.enable_lora and is_main:
        save_lora(ckpt_dir / "lora", state.model, rank=rank, alpha=lora_alpha,
                  target_modules=lora_cfg.get("target_modules"),
                  ckpt_subfolders=args.lora_metadata.ckpt_subfolders)
        print(f"Saved LoRA adapter to {ckpt_dir / 'lora'}")
    return state


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
