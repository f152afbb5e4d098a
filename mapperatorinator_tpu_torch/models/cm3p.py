"""CM3P, the contrastive audio <-> beatmap embedding model, as a feature
extractor (``models/cm3p.py``).

* :class:`Cm3p`: a CLIP-style dual encoder: a beatmap-token tower and a
  mel-audio tower (two :class:`.transformer.Encoder` stacks, no conv stem,
  RoPE by default), mean pooling (over the live tokens, divided by at least
  one, so an all-pad window pools to zero), bias-free projections into a
  shared space, l2 normalisation (the norm clipped at 1e-8) and a learned
  contrastive logit scale with the symmetric InfoNCE loss. Both towers'
  attention runs on the flash kernel where it covers the call: the audio
  tower unmasked, the beatmap tower under its token mask.
* :func:`extract_cm3p_features` windows a (beatmap, audio) pair as the
  classifier's feature extractor does and embeds every window.
* :func:`load_cm3p` / :func:`save_cm3p`: a checkpoint directory of
  ``cm3p_config.json`` with ``params.msgpack`` (the flax tree, read and
  written in pure Python) or ``pytorch_model.bin`` (a torch dual-tower state
  dict, :func:`convert_cm3p_state_dict`), and ``tokenizer.json``.

The published ``OliBomby/CM3P`` is Hub remote code and needs the network;
:func:`load_cm3p` prints why it skips a checkpoint it cannot read, and the
evaluation harness then skips the CM3P metrics.
"""

from __future__ import annotations

import dataclasses
import json
import types
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..audio.mel import MelSpectrogram
from ..config import PARSER_DATA_DEFAULTS
from ..osu.events import Event, EventType
from ..osu.parsing import BeatmapParser
from ..osu.vocab import Vocabulary
from ..utils.batched_apply import batched_apply
from .convert import _norm, _split_attn
from .io import load_params, save_params
from .transformer import Dense, Encoder, TransformerConfig, check_supported


@dataclasses.dataclass(frozen=True)
class Cm3pConfig:
    beatmap_backbone: TransformerConfig = TransformerConfig(conv_stem=False)
    audio_backbone: TransformerConfig = TransformerConfig(conv_stem=False)
    vocab_size: int = 4096  # beatmap-token vocab
    projection_dim: int = 512
    logit_scale_init: float = 2.6592  # log(1/0.07), the CLIP default
    sample_rate: int = 16000
    n_fft: int = 1024
    n_mels: int = 388
    hop_length: int = 128
    src_seq_len: int = 1024  # audio window = (src_seq_len-1)*hop samples
    tgt_seq_len: int = 512   # beatmap tokens per window


class Cm3p(nn.Module):
    def __init__(self, cfg: Cm3pConfig):
        super().__init__()
        check_supported(cfg.beatmap_backbone)
        check_supported(cfg.audio_backbone)
        self.cfg = cfg
        d_beatmap, d_audio = cfg.beatmap_backbone.d_model, cfg.audio_backbone.d_model
        self.spectrogram = MelSpectrogram("xla", sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels,
                                          hop_length=cfg.hop_length)
        self.beatmap_embedder = nn.Embedding(cfg.vocab_size, d_beatmap)
        self.beatmap_encoder = Encoder(cfg.beatmap_backbone)
        self.audio_embedder = Dense(cfg.n_mels, d_audio)
        self.audio_encoder = Encoder(cfg.audio_backbone)
        self.beatmap_projection = Dense(d_beatmap, cfg.projection_dim, bias=False)
        self.audio_projection = Dense(d_audio, cfg.projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(cfg.logit_scale_init))

    def flax_init(self, leaf: str) -> torch.Tensor:
        """The value flax initialises ``leaf`` (``logit_scale``) to."""
        return torch.tensor(self.cfg.logit_scale_init, device=self.logit_scale.device)

    @staticmethod
    def _pool(hidden: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        if mask is None:
            return hidden.mean(dim=1)
        m = mask.to(hidden.dtype)[..., None]
        return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)

    @staticmethod
    def _normalize(proj: torch.Tensor) -> torch.Tensor:
        return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True).clamp_min(1e-8)

    def encode_beatmap(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T) ids, int32 or int64, and (B, T) mask (nonzero where a token
        is real) -> (B, projection_dim) unit embeddings (zero for a window
        with no token)."""
        attn = attention_mask[:, None, None, :].bool() if attention_mask is not None else None
        hidden = self.beatmap_encoder(self.beatmap_embedder(input_ids), attn_mask=attn)
        return self._normalize(self.beatmap_projection(self._pool(hidden, attention_mask)))

    def encode_audio(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, n_samples) -> (B, projection_dim) unit embeddings."""
        hidden = self.audio_encoder(self.audio_embedder(self.spectrogram(frames)))
        return self._normalize(self.audio_projection(self._pool(hidden, None)))

    def forward(self, input_ids: torch.Tensor, frames: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
                return_loss: bool = False) -> dict:
        beatmap_embeds = self.encode_beatmap(input_ids, attention_mask)
        audio_embeds = self.encode_audio(frames)
        logits_per_beatmap = beatmap_embeds @ audio_embeds.T * self.logit_scale.exp()
        loss = None
        if return_loss:  # symmetric InfoNCE over the in-batch pairing
            labels = torch.arange(logits_per_beatmap.shape[0], device=logits_per_beatmap.device)
            loss = (F.cross_entropy(logits_per_beatmap, labels) + F.cross_entropy(logits_per_beatmap.T, labels)) / 2
        return {"loss": loss, "beatmap_embeds": beatmap_embeds, "audio_embeds": audio_embeds,
                "logits_per_beatmap": logits_per_beatmap}


# -- feature extraction -------------------------------------------------------


def cm3p_parser(config: Cm3pConfig, vocab: Vocabulary) -> BeatmapParser:
    """The beatmap parser at the JAX ``DataConfig()`` defaults, emitting only
    the event families the checkpoint's vocabulary can encode."""
    ranges = vocab.event_range
    data = types.SimpleNamespace(**{
        **PARSER_DATA_DEFAULTS,
        "src_seq_len": config.src_seq_len,
        "tgt_seq_len": config.tgt_seq_len,
        "add_distances": EventType.DISTANCE in ranges,
        "add_positions": EventType.POS in ranges or EventType.POS_X in ranges,
        "add_hitsounds": EventType.HITSOUND in ranges,
        "add_snapping": EventType.SNAPPING in ranges,
        "add_timing_points": EventType.TIMING_POINT in ranges,
        "add_kiai": EventType.KIAI in ranges,
        "add_sv": EventType.SCROLL_SPEED in ranges,
        "add_mania_sv": False,
    })
    return BeatmapParser(types.SimpleNamespace(data=data), vocab)


def extract_cm3p_features(beatmap, audio: np.ndarray, bundle, batch_size: int = 16) -> np.ndarray:
    """Per-window CM3P beatmap embeddings (the reference's
    ``outputs.beatmap_embeds``, calc_fid.py:650-676), on the model's device.
    ``bundle`` is the (model, config, vocab) of :func:`load_cm3p`. Windows
    span the whole audio, so one past the map's last object holds only
    pads."""
    model, config, vocab = bundle
    events, event_times = cm3p_parser(config, vocab).parse(beatmap, 1.0, None, (False, False))

    samples_per_seq = (config.src_seq_len - 1) * config.hop_length
    seq_s = samples_per_seq / config.sample_rate
    starts = np.arange(0, max(len(audio) / config.sample_rate - seq_s, seq_s / 2), seq_s)

    ts_range = vocab.event_range[EventType.TIME_SHIFT]
    examples = []
    for time_s in starts:
        frames = np.zeros(samples_per_seq, np.float32)
        chunk = audio[int(time_s * config.sample_rate):][:samples_per_seq]
        frames[: len(chunk)] = chunk
        tokens = np.full((config.tgt_seq_len,), vocab.pad_id, np.int32)
        window = [e for e, t in zip(events, event_times) if time_s <= t / 1000 < time_s + seq_s]
        for i, event in enumerate(window[: config.tgt_seq_len]):
            if event.type == EventType.TIME_SHIFT:
                value = int((event.value - time_s * 1000) / 10)
                event = Event(EventType.TIME_SHIFT,
                              int(np.clip(value, ts_range.min_value, ts_range.max_value)))
            tokens[i] = vocab.encode(event)
        examples.append({"input_ids": tokens[None], "frames": frames[None],
                         "attention_mask": (tokens != vocab.pad_id)[None].astype(np.int32)})

    device = next(model.parameters()).device

    def apply_fn(batch):
        with torch.inference_mode():
            out = model.encode_beatmap(torch.as_tensor(batch["input_ids"], device=device),
                                       torch.as_tensor(batch["attention_mask"], device=device))
        return out.float().cpu().numpy()

    return batched_apply(examples, batch_size, apply_fn)


# -- checkpoint IO ------------------------------------------------------------


def config_to_dict(cfg: Cm3pConfig) -> dict:
    """The ``cm3p_config.json`` tree, as the JAX ``_config_to_dict`` writes it."""
    d = dataclasses.asdict(cfg)
    for key in ("beatmap_backbone", "audio_backbone"):
        for field in ("dtype", "param_dtype"):
            d[key][field] = str(getattr(getattr(cfg, key), field)).removeprefix("torch.")
    return d


def config_from_dict(d: dict) -> Cm3pConfig:
    d = dict(d)
    for key in ("beatmap_backbone", "audio_backbone"):
        if isinstance(d.get(key), dict):
            td = dict(d[key])
            for field in ("dtype", "param_dtype"):
                td[field] = getattr(torch, td.get(field, "float32"))
            d[key] = TransformerConfig(**td)
    return Cm3pConfig(**d)


def save_cm3p(directory, model: Cm3p, vocab: Optional[Vocabulary] = None) -> Path:
    """``cm3p_config.json``, ``params.msgpack`` (fp32, the flax layout, which
    the JAX ``load_cm3p`` reads too) and, with a vocabulary,
    ``tokenizer.json``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "cm3p_config.json").write_text(json.dumps(config_to_dict(model.cfg), indent=1))
    save_params(directory / "params.msgpack", model)
    if vocab is not None:
        vocab.save_pretrained(directory)
    return directory


def convert_cm3p_state_dict(sd: dict, config: Cm3pConfig) -> dict[str, torch.Tensor]:
    """A torch dual-tower state dict -> the state dict of :class:`Cm3p`: the
    JAX converter's map, onto the port's names. The whisper-style CLIP
    layout: ``beatmap_embedder.weight``, ``audio_embedder.{weight,bias}``,
    ``{beatmap,audio}_projection.weight``, ``logit_scale``, and
    ``{beatmap,audio}_encoder.layers.N.self_attn.{q,k,v,out}_proj`` (fused
    into ``wqkv``, the k bias slot 0), ``*_layer_norm`` and ``fc1`` / ``fc2``.
    Keys the map drops as the JAX one does (a k bias, an RMSNorm's bias)
    are dropped; any other key left over raises with a listing."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    out = {name: sd.pop(name) for name in ("beatmap_embedder.weight", "audio_embedder.weight",
                                           "audio_embedder.bias", "beatmap_projection.weight",
                                           "audio_projection.weight")}
    out["logit_scale"] = sd.pop("logit_scale").reshape(())
    for tower, backbone in (("beatmap_encoder", config.beatmap_backbone), ("audio_encoder", config.audio_backbone)):
        _norm(out, sd, f"{tower}.layer_norm", f"{tower}.norm", backbone.norm)
        used = [f"{tower}.layer_norm"]
        for i in range(backbone.encoder_layers):
            p = f"{tower}.layers.{i}"
            _split_attn(out, sd, f"{p}.self_attn", f"{p}.self_attn", cross=False)
            _norm(out, sd, f"{p}.self_attn_layer_norm", f"{p}.self_attn_norm", backbone.norm)
            _norm(out, sd, f"{p}.final_layer_norm", f"{p}.final_norm", backbone.norm)
            for fc in ("fc1", "fc2"):
                out[f"{p}.ffn.{fc}.weight"] = sd.pop(f"{p}.{fc}.weight")
                out[f"{p}.ffn.{fc}.bias"] = sd.pop(f"{p}.{fc}.bias")
            used += [f"{p}.self_attn.{proj}" for proj in ("q_proj", "k_proj", "v_proj", "out_proj")]
            used += [f"{p}.self_attn_layer_norm", f"{p}.final_layer_norm"]
        for prefix in used:
            sd.pop(f"{prefix}.weight", None)
            sd.pop(f"{prefix}.bias", None)
    if sd:
        raise ValueError(f"unconverted CM3P keys: {sorted(sd)[:10]} (+{max(0, len(sd) - 10)} more)")
    return out


def load_cm3p(directory, device: Union[torch.device, str] = "cpu") -> Optional[tuple]:
    """(model in eval mode on ``device``, config, vocab or None) from a local
    CM3P checkpoint directory, or None with the reason printed. Native:
    ``cm3p_config.json`` + ``params.msgpack`` (+ ``tokenizer.json``). Torch:
    ``cm3p_config.json`` + ``pytorch_model.bin``, read with
    ``torch.load(..., weights_only=True)``."""
    directory = Path(directory)
    config_path = directory / "cm3p_config.json"
    if not config_path.exists():
        print(
            f"CM3P checkpoint {directory} unavailable (no local cm3p_config.json; "
            "the published hub checkpoint needs network access); skipping fid_cm3p"
        )
        return None
    config = config_from_dict(json.loads(config_path.read_text()))
    vocab = Vocabulary.from_pretrained(directory) if (directory / "tokenizer.json").exists() else None
    msgpack, torch_bin = directory / "params.msgpack", directory / "pytorch_model.bin"
    model = Cm3p(config)
    if msgpack.exists():
        load_params(msgpack, model)
    elif torch_bin.exists():
        model.load_state_dict(convert_cm3p_state_dict(torch.load(torch_bin, map_location="cpu", weights_only=True),
                                                      config))
    else:
        print(f"CM3P checkpoint {directory} has no params.msgpack/pytorch_model.bin; skipping fid_cm3p")
        return None
    return model.to(device).eval(), config, vocab
