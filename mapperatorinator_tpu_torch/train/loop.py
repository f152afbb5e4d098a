"""Training loop: the parts of the JAX ``train/loop.py`` that ``train()``
needs, in PyTorch.

Streaming-mean logging, per-context eval, checkpoints with total-limit
retention, a best alias and auto-resume, the FLOPs of a step and the MFU
gauge against the card's published peak.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time
import warnings
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..osu.events import ContextType, EventType
from ..osu.vocab import Vocabulary

# published dense bf16 tensor-core peaks (NVIDIA data sheets), by a substring
# of torch.cuda.get_device_name: the H100 SXM part at its 700 W limit
PEAK_BF16_FLOPS = {"H100 80GB HBM3": 989e12, "H100 SXM": 989e12}


class Averager:
    """Streaming means (reference: log_utils.py:5-43)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.total = {}
        self.counter = {}

    def update(self, stats: dict) -> None:
        for key, value in stats.items():
            if isinstance(value, torch.Tensor):
                value = value.detach().cpu().numpy()
            value = np.asarray(value, dtype=np.float64)
            if key in self.total:
                self.total[key] += value.sum()
                self.counter[key] += value.size
            else:
                self.total[key] = value.sum()
                self.counter[key] = value.size

    def average(self) -> dict:
        # a stat with no entries (a context type absent from the eval batch) is skipped
        out = {key: float(self.total[key] / self.counter[key]) for key in self.total if self.counter[key] > 0}
        self.reset()
        return out


def add_prefix(prefix: str, stats: dict) -> dict:
    return {f"{prefix}/{k}": v for k, v in stats.items()}


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def _ckpt_metrics(step: int, eval_loss) -> dict:
    metrics = {"step": step}
    if eval_loss is not None:
        metrics["eval_loss"] = float(eval_loss)
    return metrics


def acc_range(preds, labels, start_index, end_index) -> np.ndarray:
    index = (start_index <= labels) & (labels < end_index)
    return (preds[index] == labels[index]).astype(np.float32)


def fuzzy_acc_range(preds, labels, start_index, end_index, fuzzyness=0) -> np.ndarray:
    index = (start_index <= labels) & (labels < end_index)
    rl, rp = labels[index], preds[index]
    return ((rp - fuzzyness <= rl) & (rl <= rp + fuzzyness)).astype(np.float32)


def get_stats(loss, preds, labels, vocab: Vocabulary, args) -> dict:
    """Per-range accuracy metrics (reference: train_utils.py:327-376)."""
    es, ee = vocab.event_start, vocab.event_end
    stats = {
        "loss": np.asarray(loss),
        "timing_acc": acc_range(preds, labels, es[EventType.TIME_SHIFT], ee[EventType.TIME_SHIFT]),
        "fuzzy_timing_acc": fuzzy_acc_range(preds, labels, es[EventType.TIME_SHIFT], ee[EventType.TIME_SHIFT], 2),
        "hitsound_acc": acc_range(preds, labels, es[EventType.HITSOUND], ee[EventType.HITSOUND]),
        "volume_acc": acc_range(preds, labels, es[EventType.VOLUME], ee[EventType.VOLUME]),
        "other_acc": acc_range(preds, labels, ee[EventType.VOLUME], ee[EventType.VOLUME] + vocab.vocab_size_out),
    }
    if args.data.add_positions:
        if args.data.position_split_axes:
            stats["position_acc"] = acc_range(preds, labels, es[EventType.POS_X], ee[EventType.POS_Y])
        else:
            stats["position_acc"] = acc_range(preds, labels, es[EventType.POS], ee[EventType.POS])
    if args.data.add_distances:
        stats["spacing_acc"] = acc_range(preds, labels, es[EventType.DISTANCE], ee[EventType.DISTANCE])
    if 3 in args.data.gamemodes:
        stats["column_acc"] = acc_range(preds, labels, es[EventType.MANIA_COLUMN], ee[EventType.MANIA_COLUMN])
    if 1 in args.data.gamemodes or 3 in args.data.gamemodes:
        stats["scroll_speed_acc"] = acc_range(preds, labels, es[EventType.SCROLL_SPEED], ee[EventType.SCROLL_SPEED])
    return stats


def eval_model(eval_step: Callable, model, eval_batches: Iterable[dict], vocab: Vocabulary, args,
               max_steps: Optional[int] = None) -> dict:
    """Per-context-type eval (reference: train_utils.py:236-318). Batches are
    sliced by context-SOS token presence in the decoder input."""
    averager = Averager()
    all_in_contexts = set()
    for cts in args.data.context_types:
        if isinstance(cts, (str, ContextType)):
            all_in_contexts.add(ContextType(cts) if isinstance(cts, str) else cts)
        else:
            all_in_contexts.update(cts["in"])

    for batch_id, batch in enumerate(eval_batches, start=1):
        if max_steps is not None and batch_id > max_steps:
            break
        loss, logits = eval_step(model, batch)
        preds = logits.argmax(-1).cpu().numpy()
        labels = np.asarray(batch["labels"])
        if len(args.data.context_types) > 0:
            for cts in args.data.context_types:
                if isinstance(cts, (str, ContextType)):
                    cts = {"out": [ContextType.MAP], "in": [ContextType(cts) if isinstance(cts, str) else cts]}
                ids = np.asarray(batch["decoder_input_ids"])
                ct_index = np.ones(ids.shape[0], bool)
                for c in cts["in"]:
                    ct_index &= (ids == vocab.context_sos[c]).any(axis=1)
                for c in all_in_contexts - set(cts["in"]):
                    ct_index &= ~(ids == vocab.context_sos[c]).any(axis=1)
                if not ct_index.any():
                    continue
                stats = get_stats(float(loss), preds[ct_index], labels[ct_index], vocab, args)
                averager.update(add_prefix("+".join(c.value for c in cts["in"]), stats))
        else:
            averager.update(get_stats(float(loss), preds, labels, vocab, args))
    return add_prefix("test", averager.average())


class CheckpointManager:
    """Checkpoints with total-limit retention, auto-resume and a metadata
    manifest that records each step's metrics and the best eval loss: the
    interface of the JAX ``CheckpointManager``. It writes with
    ``torch.save`` where the JAX one writes orbax: ``<dir>/<step>/state.pt``
    holds the step, the model's state dict and the optimizer's state. The
    best checkpoint is mirrored to ``<dir>/best``, so retention, which
    removes only numbered step directories, never loses it."""

    def __init__(self, directory, total_limit: int = 2):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.total_limit = total_limit
        # called after every save with (step_dir, metadata, is_best); wired to
        # MetricsLogger.log_checkpoint_artifact when a wandb run is live
        self.artifact_sink: Optional[Callable[[Path, dict, bool], None]] = None
        self._manifest_path = self.directory / "manifest.json"
        self._manifest = {"metadata": {}, "checkpoints": {}, "best": None}
        if self._manifest_path.exists():
            try:
                self._manifest = json.loads(self._manifest_path.read_text(encoding="utf-8"))
            except (OSError, ValueError):
                pass

    def set_metadata(self, metadata: dict) -> None:
        self._manifest["metadata"] = {k: _jsonable(v) for k, v in metadata.items()}
        self._write_manifest()

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        """``metrics`` may carry ``eval_loss``; a new minimum is recorded as
        the manifest's ``best`` and mirrors the checkpoint to ``<dir>/best``."""
        step_dir = self.directory / str(step)
        tmp = self.directory / f".{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save({"step": state.step, "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict()}, tmp / "state.pt")
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp.rename(step_dir)

        entry = {k: _jsonable(v) for k, v in (metrics or {}).items()}
        self._manifest.setdefault("checkpoints", {})[str(step)] = entry
        eval_loss = entry.get("eval_loss")
        best = self._manifest.get("best")
        is_best = eval_loss is not None and (best is None or eval_loss < best["eval_loss"])
        if is_best:
            self._manifest["best"] = {"step": step, "eval_loss": eval_loss}
            self._mirror_best(step_dir)
        for old in self.all_steps()[:-self.total_limit]:
            shutil.rmtree(self.directory / str(old))
        self._write_manifest()
        if self.artifact_sink is not None:
            self.artifact_sink(step_dir, {**self._manifest.get("metadata", {}), **entry}, is_best)

    def _mirror_best(self, step_dir: Path) -> None:
        """Copy ``step_dir`` to ``<dir>/best`` through a temporary directory
        and a rename."""
        tmp, dst = self.directory / ".best.tmp", self.directory / "best"
        if tmp.exists():
            shutil.rmtree(tmp)
        shutil.copytree(step_dir, tmp)
        if dst.exists():
            shutil.rmtree(dst)
        tmp.rename(dst)

    def _write_manifest(self) -> None:
        self._manifest_path.write_text(json.dumps(self._manifest, indent=1), encoding="utf-8")

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir() if p.is_dir() and p.name.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        best = self._manifest.get("best")
        return None if best is None else int(best["step"])

    def restore_best(self, state_template):
        """Restore the best checkpoint from its mirror, or from the live step
        directory if the mirror is gone."""
        step = self.best_step()
        if step is None:
            raise ValueError("no best checkpoint recorded in the manifest")
        mirror = self.directory / "best"
        if (mirror / "state.pt").exists():
            return self._load(mirror, state_template)
        return self.restore(state_template, step=step)

    def restore(self, state_template, step: Optional[int] = None):
        """Load the checkpoint at ``step`` (default: the latest) into the
        template's model and optimizer, in place, and return the state."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return self._load(self.directory / str(step), state_template)

    @staticmethod
    def _load(step_dir: Path, state_template):
        saved = torch.load(step_dir / "state.pt", map_location="cpu", weights_only=True)
        state_template.model.load_state_dict(saved["model"])
        state_template.optimizer.load_state_dict(saved["optimizer"])
        state_template.step = int(saved["step"])
        return state_template


class MetricsLogger:
    """A JSONL metrics sink, plus a TensorBoard or wandb tracker where that
    package is installed (the JAX ``MetricsLogger``): the JSONL file is
    always written, and a missing tracker package leaves JSONL only."""

    def __init__(self, directory, log_with: Optional[str] = "tensorboard", *, run_name: Optional[str] = None,
                 mode: str = "online"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.jsonl = open(self.directory / "metrics.jsonl", "a", encoding="utf-8")
        self.tb = None
        self.wandb_run = None
        if log_with == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(str(self.directory))
            except ImportError:
                pass
        elif log_with == "wandb":
            try:
                import wandb
            except ImportError:
                warnings.warn("logging.log_with=wandb but the wandb package is not installed; metrics go to "
                              "JSONL only")
            else:
                kwargs = dict(project="osuT5", job_type="training", mode=mode, dir=str(self.directory))
                if run_name:
                    kwargs["name"] = run_name
                self.wandb_run = wandb.init(**kwargs)

    def log(self, stats: dict, step: int) -> None:
        record = {"step": step, **{k: float(v) for k, v in stats.items()}}
        self.jsonl.write(json.dumps(record) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in record.items():
                if k != "step":
                    self.tb.add_scalar(k, v, step)
        if self.wandb_run is not None:
            self.wandb_run.log({k: v for k, v in record.items() if k != "step"}, step=step)

    def log_checkpoint_artifact(self, checkpoint_dir, metadata: dict, is_best: bool) -> None:
        """Upload a saved checkpoint directory as a wandb model artifact with
        the run's metadata, aliased ``best`` on a new eval-loss minimum (the
        JAX ``log_checkpoint_artifact``). Does nothing without a live wandb
        run."""
        if self.wandb_run is None:
            return
        import wandb

        art = wandb.Artifact(f"osuT5-{self.wandb_run.id}", type="model",
                             metadata={k: _jsonable(v) for k, v in metadata.items()})
        checkpoint_dir = Path(checkpoint_dir)
        for file in sorted(p for p in checkpoint_dir.rglob("*") if p.is_file()):
            art.add_file(str(file), str(file.relative_to(checkpoint_dir)))
        self.wandb_run.log_artifact(art, aliases=["best"] if is_best else None)

    def close(self) -> None:
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


# ---------------------------------------------------------------------------
# FLOPs and MFU
# ---------------------------------------------------------------------------


def _batch_token_split(batch: dict) -> tuple[float, float]:
    """(encoder frames, decoder positions) processed per step."""
    tok_enc = tok_dec = 0.0
    ids = batch.get("decoder_input_ids")
    if ids is not None:
        tok_dec = float(np.prod(ids.shape))
    frames = batch.get("frames")
    if frames is not None:
        # raw samples -> mel frames (hop 128), halved by the conv stem
        tok_enc = float(frames.shape[0]) * (frames.shape[-1] / 128.0) / 2.0
    return tok_enc, tok_dec


def batch_tokens(batch: dict) -> float:
    """Tokens processed per step: encoder frames + decoder positions."""
    return sum(_batch_token_split(batch))


def _attention_flops(batch: dict, backbone) -> float:
    """fwd + bwd FLOPs of the attention score and value products per step:
    12 S^2 d_model per layer and batch row (fwd 4, bwd 8), the full S^2
    (the kernels skip no masked tile)."""
    ids, frames = batch.get("decoder_input_ids"), batch.get("frames")
    if ids is None or backbone is None:
        return 0.0
    bsz, s_dec = int(ids.shape[0]), int(ids.shape[-1])
    s_enc = int(frames.shape[-1] / 128.0 / 2.0) if frames is not None else 0
    d = backbone.d_model
    per_row = (backbone.encoder_layers * 12.0 * s_enc * s_enc * d
               + backbone.decoder_layers * 12.0 * s_dec * s_dec * d
               + backbone.decoder_layers * 12.0 * s_dec * s_enc * d)
    return float(bsz) * per_row


def step_flops(model, batch: dict, backbone=None) -> float:
    """fwd + bwd FLOPs of one step: 6 (N_enc S_enc + N_dec S_dec) for the
    parameterised products, encoder parameters seeing only encoder frames
    and the rest only decoder positions, plus the attention products when
    ``backbone`` is given (the JAX ``step_flops``)."""
    tok_enc, tok_dec = _batch_token_split(batch)
    enc = sum(p.numel() for name, p in model.named_parameters() if "encoder" in name)
    dec = sum(p.numel() for name, p in model.named_parameters() if "encoder" not in name)
    return 6.0 * (enc * tok_enc + dec * tok_dec) + _attention_flops(batch, backbone)


def device_peak_flops(device) -> float:
    """The published dense bf16 peak of the card (0 where it is not in the
    table: MFU is then left out rather than misreported)."""
    if torch.device(device).type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    return next((flops for key, flops in PEAK_BF16_FLOPS.items() if key in name), 0.0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------


def train(*, train_step: Callable, eval_step: Callable, state, train_batch_factory: Callable[[], Iterable[dict]],
          eval_batch_factory: Optional[Callable[[], Iterable[dict]]] = None, vocab: Vocabulary, args,
          logger: Optional[MetricsLogger] = None, checkpoints: Optional[CheckpointManager] = None):
    """The main loop (reference: train_utils.py:379-434): runs until
    ``optim.total_steps`` with eval, log and checkpoint hooks at their
    configured intervals, remaking the batch stream each epoch, and saves a
    checkpoint at the end."""
    averager = Averager()
    last_log = time.time()
    backbone = state.model.cfg.backbone
    device = next(state.model.parameters()).device
    peak_flops = device_peak_flops(device)
    step = state.step
    last_eval_loss = None
    while step < args.optim.total_steps:
        made_progress = False
        for batch in train_batch_factory():
            made_progress = True
            if step >= args.optim.total_steps:
                break
            state, metrics = train_step(state, batch)
            step = state.step
            averager.update(metrics)

            if logger is not None and step % args.logging.every_steps == 0:
                stats = averager.average()
                stats["seconds_per_step"] = (time.time() - last_log) / args.logging.every_steps
                if peak_flops and stats["seconds_per_step"] > 0:
                    stats["mfu"] = step_flops(state.model, batch, backbone) / stats["seconds_per_step"] / peak_flops
                if device.type == "cuda":
                    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
                last_log = time.time()
                logger.log(add_prefix("train", stats), step)

            if eval_batch_factory is not None and step % args.eval.every_steps == 0:
                eval_stats = eval_model(eval_step, state.model, eval_batch_factory(), vocab, args,
                                        max_steps=args.eval.steps)
                if "test/loss" in eval_stats:
                    last_eval_loss = eval_stats["test/loss"]
                if logger is not None:
                    logger.log(eval_stats, step)

            if checkpoints is not None and step % args.checkpoint.every_steps == 0:
                checkpoints.save(step, state, metrics=_ckpt_metrics(step, last_eval_loss))

        if not made_progress:
            break

    if checkpoints is not None:
        checkpoints.save(step, state, metrics=_ckpt_metrics(step, last_eval_loss))
    return state
