"""Train the rhythm-complexity model on the port (``rcomplexion_train.py``;
reference: ``rcomplexion/train.py:20-91``).

    python -m mapperatorinator_tpu_torch.rcomplexion_train -cn train_v1 [key=value ...] [device=cpu]

OsuR, the next-note-timing MLP whose cross-entropy per drain-second is the
rhythm-complexity measure, starts from flax's initialisation
(``models/params.init_flax_params``) and trains with the JAX chain:
clipping, then AdamW with weight decay on every leaf (no ``MultiSteps``).
Every ``eval.every_steps`` the loss and accuracy of up to ``eval.steps``
test batches are logged as ``val/*``. The final weights go to
``<checkpoint_path>/final/params.msgpack`` in the flax layout, which
``rcomplexion_inference`` reads in either package.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from .config import load_rcomplexion_config, parse_argv, select_device
from .models.classifier import OsuR, OsuRConfig
from .models.io import save_params
from .models.params import init_flax_params
from .rcomplexion import RcomplexionDataset, RTokenizer
from .train.data.batching import batch_iterator
from .train.loop import CheckpointManager, MetricsLogger, run_steps
from .train.optim import build_adamw_chain
from .train.step import to_device

BATCH_KEYS = ("input_ids", "labels")


def make_train_step(model: OsuR, tx):
    """``train_step(batch) -> loss``: one update of ``model`` and ``tx``."""
    params = list(model.parameters())

    def train_step(batch: dict) -> torch.Tensor:
        loss = model(batch["input_ids"], labels=batch["labels"])["loss"]
        tx.step(torch.autograd.grad(loss, params))
        return loss.detach()

    return train_step


@torch.no_grad()
def eval_step(model: OsuR, batch: dict) -> tuple[float, float]:
    """(loss, accuracy) of one batch."""
    out = model(batch["input_ids"], labels=batch["labels"])
    return float(out["loss"]), float((out["logits"].argmax(-1) == batch["labels"]).float().mean())


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, _ = parse_argv(argv, "train_v1", {})
    args = load_rcomplexion_config(config_name, overrides)
    device = select_device(args)

    tokenizer = RTokenizer(args)
    model = OsuR(OsuRConfig(vocab_size_in=tokenizer.vocab_size_in, vocab_size_out=tokenizer.vocab_size_out,
                            src_seq_len=args.data.src_seq_len, hidden_size=args.model.hidden_size)).to(device)
    init_flax_params(model, args.seed)
    tx = build_adamw_chain(args.optim, model)
    train_step = make_train_step(model, tx)

    def evaluate() -> dict:
        stats = []
        batches = batch_iterator(RcomplexionDataset(args, tokenizer, test=True), args.optim.batch_size, drop_last=True)
        for j, batch in enumerate(batches):
            if j >= args.eval.steps:
                break
            stats.append(eval_step(model, to_device(batch, device, BATCH_KEYS)))
        if not stats:
            return {}
        m = np.mean(stats, axis=0)
        return {"val/loss": m[0], "val/accuracy": m[1]}

    ckpt_dir = Path(args.checkpoint_path or "rcomplexion_checkpoints")
    logger = MetricsLogger("logs/rcomplexion", log_with=args.logging.log_with)
    run_steps(args, lambda: batch_iterator(RcomplexionDataset(args, tokenizer), args.optim.batch_size, drop_last=True),
              lambda batch: train_step(to_device(batch, device, BATCH_KEYS)),
              held=SimpleNamespace(step=0, model=model, optimizer=tx),
              checkpoints=CheckpointManager(ckpt_dir), logger=logger, evaluate=evaluate)
    final_dir = ckpt_dir / "final"
    final_dir.mkdir(parents=True, exist_ok=True)
    save_params(final_dir / "params.msgpack", model)
    print(f"Saved final model to {final_dir}")
    logger.close()
    return model


if __name__ == "__main__":
    main()
