"""Training loop: the parts of the JAX ``train/loop.py`` that ``train()``
needs, in PyTorch.

Streaming-mean logging, per-context eval, checkpoints with total-limit
retention, a best alias and auto-resume, the FLOPs of a step and the MFU
gauge against the card's published peak, and a ``torch.profiler`` trace
over the window ``profile`` configures. Across processes rank 0 writes the
checkpoints and every rank restores them (:class:`CheckpointManager`).
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
import torch.distributed as dist

from ..models.transformer import moonshine_stem_length
from ..osu.events import ContextType, EventType
from ..osu.vocab import Vocabulary
from ..parallel.sharding import any_sharded, gathered, local, shard_of

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
    removes only numbered step directories, never loses it.

    In a process group every rank calls :meth:`save` (under FSDP the full
    state is gathered from the shards, a collective) and rank 0 alone
    writes, between two barriers; every rank restores. The file holds the
    unwrapped model's state dict and the optimizer's full buffers, so one
    written by a single process, by DDP ranks or by FSDP ranks restores in
    any of these layouts."""

    def __init__(self, directory, total_limit: int = 2):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.total_limit = total_limit
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
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
        if self.writer:
            self._write_manifest()

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        """``metrics`` may carry ``eval_loss``; a new minimum is recorded as
        the manifest's ``best`` and mirrors the checkpoint to ``<dir>/best``."""
        saved = {"step": state.step, "model": full_state_dict(state.model),
                 "optimizer": state.optimizer.state_dict()}
        if dist.is_initialized():
            dist.barrier()
        if self.writer:
            self._write(step, saved, metrics)
        if dist.is_initialized():
            dist.barrier()
            if not self.writer:
                self._manifest = json.loads(self._manifest_path.read_text(encoding="utf-8"))

    def _write(self, step: int, saved: dict, metrics: Optional[dict]) -> None:
        step_dir = self.directory / str(step)
        tmp = self.directory / f".{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        torch.save(saved, tmp / "state.pt")
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
        load_full_state_dict(state_template.model, saved["model"])
        state_template.optimizer.load_state_dict(saved["optimizer"])
        state_template.step = int(saved["step"])
        return state_template


def full_state_dict(model: torch.nn.Module) -> dict:
    """The model's state dict with every tensor whole: under FSDP each
    sharded tensor gathered from the ranks (a collective,
    :func:`..parallel.sharding.gathered`; ``torch.distributed.checkpoint``'s
    full state dict gathers through ``DTensor.full_tensor``, which ends the
    process over gloo on CUDA tensors) in flax order (a fused tensor leaf's
    rank order undone, as its parameter records), else the module's own (a
    DDP wrapper's ``module.`` prefix never reaches it: the state holds the
    bare model)."""
    state = model.state_dict()
    if not any_sharded(model.parameters()):
        return state
    params = dict(model.named_parameters())
    return {name: gathered(t.detach(), like=params.get(name)) for name, t in state.items()}


@torch.no_grad()
def load_full_state_dict(model: torch.nn.Module, saved: dict) -> None:
    """Load a full state dict (:func:`full_state_dict`) into ``model``: each
    rank copies its own shard of a sharded tensor, without a collective."""
    if not any_sharded(model.parameters()):
        model.load_state_dict(saved)
        return
    own, params = model.state_dict(), dict(model.named_parameters())
    if sorted(own) != sorted(saved):
        raise KeyError(f"state dict keys differ: {sorted(set(own) ^ set(saved))}")
    for name, tensor in own.items():
        local(tensor).copy_(shard_of(saved[name], params.get(name, tensor)))


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


def encoder_positions(cfg, samples: int) -> float:
    """Encoder positions of a window of ``samples`` raw audio samples for a
    model config (a :class:`..models.mapperatorinator.MapperatorinatorConfig`
    or a :class:`..models.classifier.ClassifierConfig`): a position per
    spectrogram ``hop_length`` times the whisper conv stem's stride 2, a
    position a hop where the backbone has no stem (T5, the classifier), or
    what moonshine's raw-wave stem makes of the samples
    (:func:`..models.transformer.moonshine_stem_length`)."""
    if getattr(cfg, "input_raw_wave", False):
        return float(moonshine_stem_length(samples))
    return samples / (cfg.hop_length * (2 if cfg.backbone.conv_stem else 1))


def _batch_token_split(batch: dict, cfg) -> tuple[float, float]:
    """(encoder positions, decoder positions) processed per step by a model
    of config ``cfg`` (:func:`encoder_positions`)."""
    tok_enc = tok_dec = 0.0
    ids = batch.get("decoder_input_ids")
    if ids is not None:
        tok_dec = float(np.prod(ids.shape))
    frames = batch.get("frames")
    if frames is not None:
        tok_enc = float(frames.shape[0]) * encoder_positions(cfg, frames.shape[-1])
    return tok_enc, tok_dec


def batch_tokens(batch: dict, cfg) -> float:
    """Tokens processed per step: encoder positions + decoder positions."""
    return sum(_batch_token_split(batch, cfg))


def attention_widths(backbone) -> tuple[int, int]:
    """(encoder, decoder) attention widths, heads x head dim: what the score
    and value products contract over. It is ``d_model`` for every whisper
    and moonshine size and T5-base; T5-small's 6 heads of 64 span 384 of its
    512 (the JAX count takes ``d_model``). A head the kernels take padded
    (moonshine's 36) counts at its own width."""
    head = backbone.head_dim_override
    return tuple(h * (head or backbone.d_model // h) for h in (backbone.encoder_heads, backbone.decoder_heads))


def _attention_flops(batch: dict, cfg) -> float:
    """fwd + bwd FLOPs of the attention score and value products per step:
    12 S^2 W per layer and batch row (fwd 4, bwd 8), W the side's
    :func:`attention_widths`, the full S^2 (the kernels skip no masked
    tile)."""
    ids, frames = batch.get("decoder_input_ids"), batch.get("frames")
    if ids is None or cfg is None or cfg.backbone is None:
        return 0.0
    backbone = cfg.backbone
    bsz, s_dec = int(ids.shape[0]), int(ids.shape[-1])
    s_enc = int(encoder_positions(cfg, frames.shape[-1])) if frames is not None else 0
    w_enc, w_dec = attention_widths(backbone)
    per_row = (backbone.encoder_layers * 12.0 * s_enc * s_enc * w_enc
               + backbone.decoder_layers * 12.0 * s_dec * s_dec * w_dec
               + backbone.decoder_layers * 12.0 * s_dec * s_enc * w_dec)
    return float(bsz) * per_row


def _side_counts(counts) -> tuple[int, int]:
    """(encoder, decoder-side) totals of (name, count) pairs: a name holding
    ``encoder`` counts on the encoder side, as in the JAX
    ``_component_param_counts``."""
    enc = dec = 0
    for name, n in counts:
        if "encoder" in name:
            enc += n
        else:
            dec += n
    return enc, dec


def step_flops(model, batch: dict, cfg) -> float:
    """fwd + bwd FLOPs of one step: 6 (N_enc S_enc + N_dec S_dec) for the
    parameterised products, encoder parameters seeing only encoder positions
    and the rest only decoder positions, plus the attention products of
    ``cfg.backbone`` (none where it is None), ``cfg`` being the model's
    config: the JAX ``step_flops`` for a whisper-stem backbone (v32's family,
    v28, v29, NWhisper), which takes 256 samples a position for every
    backbone. The port counts T5's positions a hop (it has no stem),
    moonshine's from its raw-wave stem (:func:`encoder_positions`), and the
    attention products at :func:`attention_widths`. Given a LoRA
    adapter, this is the JAX figure for a LoRA step, whose parameters are
    the factors: attention and little else (see :func:`lora_step_flops`)."""
    tok_enc, tok_dec = _batch_token_split(batch, cfg)
    enc, dec = _side_counts((name, p.numel()) for name, p in model.named_parameters())
    return 6.0 * (enc * tok_enc + dec * tok_dec) + _attention_flops(batch, cfg)


def lora_step_flops(model, adapter, batch: dict, cfg) -> float:
    """What the card computes in a LoRA micro-step
    (:func:`.step.make_lora_train_step`), per token of each side: the frozen
    base's forward and its input gradients, 4 N_base; the gradient of each
    merged target weight, 2 N_target, which the merge formulation computes
    in full and passes to the factors; plus, once a step, each target's
    merge and its two factor gradients, 6 r N_target; and the attention
    products as in :func:`step_flops`."""
    tok_enc, tok_dec = _batch_token_split(batch, cfg)
    enc, dec = _side_counts((name, p.numel()) for name, p in model.named_parameters())
    t_enc, t_dec = _side_counts((f.flax_path, f.a.shape[0] * f.b.shape[1]) for f in adapter.values())
    merge = 6.0 * sum(f.a.numel() * f.b.shape[1] for f in adapter.values())
    return (4.0 * (enc * tok_enc + dec * tok_dec) + 2.0 * (t_enc * tok_enc + t_dec * tok_dec) + merge
            + _attention_flops(batch, cfg))


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


class Profile:
    """A ``torch.profiler`` trace (CPU, and the card's kernels on a CUDA
    device), written as a Chrome trace ``trace.json`` under ``directory``
    when it stops."""

    def __init__(self, directory, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.path = Path(directory) / "trace.json"
        self.device = device
        self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self) -> Path:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        return self.path


def run_steps(args, make_batches: Callable[[], Iterable[dict]], train_step: Callable[[dict], torch.Tensor], *,
              held, checkpoints: CheckpointManager, logger: MetricsLogger,
              evaluate: Optional[Callable[[], dict]] = None) -> int:
    """The loop of the JAX diffusion, classifier and rhythm-complexion
    trainers: ``train_step(batch) -> loss`` over a fresh ``make_batches()``
    each epoch until ``optim.total_steps``, logging ``train/loss`` every
    ``logging.every_steps``, ``evaluate()``'s metrics every
    ``eval.every_steps`` (where positive), and saving ``held`` (its ``step``
    kept current) every ``checkpoint.every_steps`` and at the end. Returns
    the steps run."""
    step = 0
    while step < args.optim.total_steps:
        progressed = False
        for batch in make_batches():
            if step >= args.optim.total_steps:
                break
            progressed = True
            loss = train_step(batch)
            step += 1
            held.step = step
            if step % args.logging.every_steps == 0:
                logger.log({"train/loss": float(loss)}, step)
            if evaluate is not None and args.eval.every_steps > 0 and step % args.eval.every_steps == 0:
                stats = evaluate()
                if stats:
                    logger.log(stats, step)
            if step % args.checkpoint.every_steps == 0:
                checkpoints.save(step, held)
        if not progressed:
            break
    checkpoints.save(step, held)
    return step


def train(*, train_step: Callable, eval_step: Callable, state, train_batch_factory: Callable[[], Iterable[dict]],
          eval_batch_factory: Optional[Callable[[], Iterable[dict]]] = None, vocab: Vocabulary, args,
          logger: Optional[MetricsLogger] = None, checkpoints: Optional[CheckpointManager] = None,
          profile_dir=None, flops: Optional[Callable[[dict], dict]] = None, eval_fn: Optional[Callable] = None):
    """The main loop (reference: train_utils.py:379-434): runs until
    ``optim.total_steps`` with eval, log and checkpoint hooks at their
    configured intervals, remaking the batch stream each epoch, and saves a
    checkpoint at the end.

    ``flops(batch)`` gives {gauge: FLOPs of a step on ``batch``}; on a card
    with a published peak each gauge is logged as those FLOPs over the peak
    times the seconds per step (by default ``mfu``, :func:`step_flops` of
    ``state.model``). Across processes this is the JAX figure, the global
    batch's FLOPs over the peak times the device count: every rank's rows
    have the batch's fixed shapes, so the two ratios are one. ``eval_fn(model,
    batches, max_steps)``, where given, replaces the per-context eval (the
    multi-process eval, :func:`.step.eval_model_global`). With
    ``profile_dir``, a trace starts before the step that begins at
    ``profile.wait`` completed steps and stops once ``wait + warmup +
    active`` are complete (the JAX loop's arithmetic, not
    ``torch.profiler.schedule``'s), and with ``profile.early_stop`` the loop
    returns there, without the final checkpoint, as the JAX loop does. A
    trace still open when the loop ends or raises is stopped and written."""
    averager = Averager()
    last_log = time.time()
    if flops is None:
        model = state.model
        flops = lambda batch: {"mfu": step_flops(model, batch, model.cfg)}  # noqa: E731
    device = next(state.model.parameters()).device
    peak_flops = device_peak_flops(device)
    step = state.step
    last_eval_loss = None
    profiler, profiled = None, False
    profile_end = args.profile.wait + args.profile.warmup + args.profile.active
    try:
        while step < args.optim.total_steps:
            made_progress = False
            for batch in train_batch_factory():
                made_progress = True
                if step >= args.optim.total_steps:
                    break
                if profile_dir is not None and step == args.profile.wait and not profiled:
                    profiler, profiled = Profile(profile_dir, device), True
                state, metrics = train_step(state, batch)
                step = state.step
                averager.update(metrics)

                if profiler is not None and step >= profile_end:
                    profiler.stop()
                    profiler = None
                    if args.profile.early_stop:
                        return state

                if logger is not None and step % args.logging.every_steps == 0:
                    stats = averager.average()
                    stats["seconds_per_step"] = (time.time() - last_log) / args.logging.every_steps
                    if peak_flops and stats["seconds_per_step"] > 0:
                        peak_work = peak_flops * stats["seconds_per_step"]
                        stats.update({gauge: n / peak_work for gauge, n in flops(batch).items()})
                    if device.type == "cuda":
                        stats["peak_mem_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
                    last_log = time.time()
                    logger.log(add_prefix("train", stats), step)

                if eval_batch_factory is not None and step % args.eval.every_steps == 0:
                    if eval_fn is not None:
                        eval_stats = eval_fn(state.model, eval_batch_factory(), args.eval.steps)
                    else:
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
    finally:
        if profiler is not None:
            profiler.stop()

    if checkpoints is not None:
        checkpoints.save(step, state, metrics=_ckpt_metrics(step, last_eval_loss))
    return state
