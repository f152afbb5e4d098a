"""Evaluate a trained classifier on the test split on the port
(``classifier_test.py``): the loss and the top-1, top-10 and top-100
accuracy, averaged over the batches of the test tracks.

    python -m mapperatorinator_tpu_torch.classifier_test -cn train_v1 model_path=DIR \
        data.test_dataset_path=... [optim.batch_size=N] [device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .classifier_classify import load_model
from .config import load_classifier_config, parse_argv, select_device
from .osu import BeatmapParser, build_vocabulary
from .train.data.batching import batch_iterator
from .train.data.classifier import ClassifierDataset


def eval_step(model, batch: dict) -> list[float]:
    """(loss, top-1, top-10, top-100 accuracy) of one batch."""
    out = model(batch["frames"], batch["decoder_input_ids"], batch["decoder_attention_mask"], batch["labels"])
    logits, labels = out["logits"], batch["labels"]

    def in_topk(k: int) -> torch.Tensor:
        return (logits.topk(min(k, logits.shape[-1]), dim=-1).indices == labels[:, None]).any(-1).float().mean()

    top1 = (logits.argmax(-1) == labels).float().mean()
    return [float(x) for x in (out["loss"], top1, in_topk(10), in_topk(100))]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "train_v1", {})
    args = load_classifier_config(config_name, overrides)
    device = select_device(args)
    vocab = build_vocabulary(args)
    parser = BeatmapParser(args, vocab)
    model = load_model(args, vocab, device)

    stats = []
    dataset = ClassifierDataset(args, parser, vocab, test=True)
    with torch.inference_mode():
        for batch in batch_iterator(dataset, args.optim.batch_size, drop_last=True):
            stats.append(eval_step(model, {k: torch.as_tensor(v, device=device) for k, v in batch.items()}))
    if not stats:
        print("no test batches produced")
        return {}
    m = np.mean(stats, axis=0)
    results = {"test_loss": m[0], "test_accuracy": m[1],
               "test_top_10_accuracy": m[2], "test_top_100_accuracy": m[3]}
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
