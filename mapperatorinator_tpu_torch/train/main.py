"""Training entry point of the port (the repo's ``train.py`` in PyTorch).

    python -m mapperatorinator_tpu_torch.train.main -cn v32 [key=value ...]

Loads ``configs/train_<name>.json`` with the overrides, builds the
vocabulary, parser, dataset, model (seeded random weights), optimizer and
checkpoint manager, resumes from the latest checkpoint under
``checkpoint_path``, saves ``tokenizer.json`` beside the checkpoints and runs
:func:`.loop.train`. It runs on the first CUDA device unless ``device=cpu``
is given, and raises without one. Metrics go to ``<log_dir>/metrics.jsonl``
(``logs/`` under the working directory, as for ``train.py``).

Not ported yet, each raising and naming ROADMAP queue 1, item 15: LoRA,
``pretrained_path`` (a msgpack checkpoint), more than one process, tensor
and FSDP mesh axes, profiling, the ``mmrs`` and ``web`` datasets and
``adafactor``. v32's ``dataset_type: web`` is therefore overridden to
``ors``, a local track-folder dataset.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..config import load_train_config, select_device
from ..models.mapperatorinator import Mapperatorinator, build_config
from ..models.params import init_params
from ..osu import BeatmapParser, build_vocabulary
from .data import build_dataset
from .data.batching import batch_iterator, prefetch_iterator
from .loop import CheckpointManager, MetricsLogger, card_line, device_peak_flops, train
from .optim import build_optimizer
from .step import TrainState, make_eval_step, make_train_step, named_flax_params

ROADMAP_ITEM = "ROADMAP queue 1, item 15"


def parse_argv(argv: Sequence[str]) -> tuple[str, list[str]]:
    """``-cn <name>`` (or ``--config-name``) and the ``key=value`` overrides."""
    config_name, overrides, i = "v32", [], 0
    while i < len(argv):
        if argv[i] in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        else:
            overrides.append(argv[i])
            i += 1
    return config_name, overrides


def refuse_unported(args) -> None:
    """Raise for the training options the port does not cover yet."""
    p = args.parallel
    refused = {
        "enable_lora": args.enable_lora,
        "pretrained_path (a msgpack checkpoint)": args.pretrained_path,
        "parallel.num_processes / coordinator_address (more than one process)":
            (p.num_processes or 1) > 1 or p.coordinator_address,
        "parallel.tensor_axis / fsdp_axis": p.tensor_axis or p.fsdp_axis,
        "profile.do_profile": args.profile.do_profile,
    }
    for what, on in refused.items():
        if on:
            raise NotImplementedError(f"{what}: not ported yet ({ROADMAP_ITEM})")


def build_model_and_data(args, device: torch.device):
    """(model, vocab, make_batches): the model on ``device`` with seeded
    random fp32 parameters, computing in the ``mixed_precision`` dtype."""
    vocab = build_vocabulary(args)
    parser = BeatmapParser(args, vocab)
    model = Mapperatorinator(build_config(args, vocab)).to(device)
    init_params(model, args.seed)

    def make_batches(test: bool):
        dataset = build_dataset(args.data, parser, vocab, test=test)
        batches = batch_iterator(
            iter(dataset),
            args.optim.batch_size,
            balancer_buffer_size=args.dataloader.balancer_buffer_size if not test else 0,
            drop_last=args.dataloader.drop_last,
        )
        if not test and args.dataloader.num_workers > 0:
            batches = prefetch_iterator(batches, buffer_size=2 * args.dataloader.num_workers)
        return batches

    return model, vocab, make_batches


def main(argv: Optional[Sequence[str]] = None, log_dir: str = "logs") -> TrainState:
    config_name, overrides = parse_argv(sys.argv[1:] if argv is None else argv)
    args = load_train_config(config_name, overrides)
    refuse_unported(args)
    device = select_device(args)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        peak = device_peak_flops(device)
        print(f"Training on {card_line()}; MFU against {peak / 1e12:g} TFLOP/s dense bf16" if peak
              else f"Training on {card_line()}; no published peak for this card, so no MFU")
    else:
        print("Training on the CPU")

    model, vocab, make_batches = build_model_and_data(args, device)
    state = TrainState(step=0, model=model, optimizer=build_optimizer(args, named_flax_params(model)))

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

    logger = MetricsLogger(log_dir, log_with=args.logging.log_with, run_name=args.logging.run_name,
                           mode=args.logging.mode)
    # checkpoint saves also upload to the tracker when one is live (train.py:228-229)
    if logger.wandb_run is not None:
        checkpoints.artifact_sink = logger.log_checkpoint_artifact
    vocab.save_pretrained(ckpt_dir)
    try:
        state = train(
            train_step=make_train_step(),
            eval_step=make_eval_step(),
            state=state,
            train_batch_factory=lambda: make_batches(test=False),
            eval_batch_factory=(lambda: make_batches(test=True)) if args.eval.every_steps > 0 else None,
            vocab=vocab,
            args=args,
            logger=logger,
            checkpoints=checkpoints,
        )
    finally:
        logger.close()
    return state


if __name__ == "__main__":
    main()
