"""Train the mapper classifier on the port (``classifier_train.py``;
reference: ``classifier/train.py:43-82``).

    python -m mapperatorinator_tpu_torch.classifier_train -cn train_v1 [key=value ...] [device=cpu]

``OsuClassifier`` (a whisper-style encoder-decoder over the audio and the
map's tokens, a mean-pooled projector and a head over the mapper classes;
its pooled projection is the FID feature extractor) starts from flax's
initialisation (``models/params.init_flax_params``), or with its towers
grafted from the native checkpoint at ``pretrained_path``
(``transfer_from_pretrained``). Each micro-step's gradient goes through
the JAX chain: clipping and AdamW with weight decay on every leaf, under
``MultiSteps(optim.grad_acc)``. Every ``eval.every_steps`` micro-steps the
loss and top-1 / top-10 / top-100 accuracy of up to ``eval.steps`` test
batches are logged as ``val/*``. The final weights are exported as the
classifier bundle under ``<checkpoint_path>/final``, which
``load_classifier_bundle``, ``calc_fid`` and the JAX loader read.

On a CUDA tensor every attention call (the encoder's, the decoder's causal
self-attention under the token mask, the cross attention) runs kernel B's
fp32 route forward and kernel C's backward.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .classifier_test import eval_step
from .config import load_classifier_config, parse_argv, select_device
from .models.classifier import OsuClassifier, build_classifier, save_classifier_bundle, transfer_from_pretrained
from .models.io import load_checkpoint
from .models.params import init_flax_params
from .osu import BeatmapParser, build_vocabulary
from .train.data.batching import batch_iterator
from .train.data.classifier import ClassifierDataset
from .train.loop import CheckpointManager, MetricsLogger, run_steps
from .train.optim import build_adamw_chain
from .train.step import to_device


def make_train_step(model: OsuClassifier, tx):
    """``train_step(batch) -> loss``: one micro-step of ``model`` and ``tx``
    (the parameters move on every ``grad_acc``-th)."""
    params = list(model.parameters())

    def train_step(batch: dict) -> torch.Tensor:
        loss = model(batch["frames"], batch["decoder_input_ids"], batch["decoder_attention_mask"],
                     batch["labels"])["loss"]
        tx.step(torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True))
        return loss.detach()

    return train_step


def evaluate(model: OsuClassifier, args, parser, vocab, device) -> dict:
    """The mean loss and top-1 / top-10 / top-100 accuracy of up to
    ``eval.steps`` test batches, as ``val/*`` (empty without a batch)."""
    stats = []
    dataset = ClassifierDataset(args, parser, vocab, test=True)
    with torch.no_grad():
        for j, batch in enumerate(batch_iterator(dataset, args.optim.batch_size, drop_last=True)):
            if j >= args.eval.steps:
                break
            stats.append(eval_step(model, to_device(batch, device)))
    if not stats:
        return {}
    m = np.mean(stats, axis=0)
    return {"val/loss": m[0], "val/accuracy": m[1], "val/top_10_accuracy": m[2], "val/top_100_accuracy": m[3]}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "train_v1", {})
    args = load_classifier_config(config_name, overrides)
    device = select_device(args)

    vocab = build_vocabulary(args)
    parser = BeatmapParser(args, vocab)
    model = build_classifier(args, vocab).to(device)
    init_flax_params(model, args.seed)
    if args.pretrained_path:
        pretrained, _ = load_checkpoint(args.pretrained_path)
        model.load_state_dict(transfer_from_pretrained(model, pretrained))
        print(f"Initialized towers from pretrained checkpoint {args.pretrained_path}")
    tx = build_adamw_chain(args.optim, model, grad_acc=args.optim.grad_acc)
    train_step = make_train_step(model, tx)

    ckpt_dir = Path(args.checkpoint_path or "classifier_checkpoints")
    logger = MetricsLogger("logs/classifier", log_with=args.logging.log_with)
    run_steps(args, lambda: batch_iterator(ClassifierDataset(args, parser, vocab), args.optim.batch_size,
                                           drop_last=True),
              lambda batch: train_step(to_device(batch, device)),
              held=SimpleNamespace(step=0, model=model, optimizer=tx),
              checkpoints=CheckpointManager(ckpt_dir), logger=logger,
              evaluate=lambda: evaluate(model, args, parser, vocab, device))
    final_dir = ckpt_dir / "final"
    save_classifier_bundle(final_dir, model, args, vocab)
    print(f"Saved final model to {final_dir}")
    logger.close()
    return model


if __name__ == "__main__":
    main()
