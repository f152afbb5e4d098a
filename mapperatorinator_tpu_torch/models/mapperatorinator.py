"""The Mapperatorinator model (``models/mapperatorinator.py``): mel front end,
optional encoder projection, decoder token table, the transformer and the
rhythm-weighted, label-smoothed training loss.

v32 turns every conditioning embedder off, so the embedders are not ported
yet: a config that enables one raises. Parameters stay in their own dtype
(fp32 in training) and each layer computes in ``backbone.dtype``, which the
training config's ``mixed_precision`` sets; the mel stays fp32 until it is
cast for the encoder, and the loss's log-softmax is fp32, as in the JAX
model.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..audio.mel import MelSpectrogram
from ..osu.events import EventType
from .transformer import Dense, OsuTransformer, TransformerConfig

LABEL_IGNORE_ID = -100

# public whisper family dimensions (model card constants)
WHISPER_DIMS = {
    "tiny": dict(d_model=384, layers=4, heads=6, ffn=1536),
    "base": dict(d_model=512, layers=6, heads=8, ffn=2048),
    "small": dict(d_model=768, layers=12, heads=12, ffn=3072),
    "smaller": dict(d_model=512, layers=8, heads=8, ffn=2048),
    "medium": dict(d_model=1024, layers=24, heads=16, ffn=4096),
}


@dataclasses.dataclass(frozen=True)
class MapperatorinatorConfig:
    """Field for field the JAX ``MapperatorinatorConfig``."""

    backbone: TransformerConfig = TransformerConfig()
    input_raw_wave: bool = False
    vocab_size_in: int = 9920
    vocab_size_out: int = 3988
    num_classes: int = 0
    num_mappers: int = 3731
    input_features: bool = True
    project_encoder_input: bool = True
    embed_decoder_input: bool = True
    do_style_embed: bool = False
    do_difficulty_embed: bool = False
    do_mapper_embed: bool = False
    do_song_position_embed: bool = False
    cond_dim: int = 128
    cond_size: int = 0
    spectrogram_implementation: str = "xla"
    spectrogram_log_scale: bool = False
    sample_rate: int = 16000
    n_fft: int = 1024
    n_mels: int = 388
    hop_length: int = 128
    f_min: float = 0
    f_max: float = 8000
    pad_mode: str = "constant"
    rhythm_weight: float = 3.0
    rhythm_token_start: int = 17
    rhythm_token_end: int = 836
    label_smoothing: float = 0.0
    init_std: float = 0.02
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    max_target_positions: int = 2048


def build_config(train_args, vocab) -> MapperatorinatorConfig:
    """A MapperatorinatorConfig from a training config and a Vocabulary, for
    the RoPE + RMSNorm whisper backbones (VarWhisper, RoPEWhisper)."""
    m = train_args.model
    name = m.name
    if not (name.startswith("OliBomby/varwhisper") or name.startswith("Tiger14n/ropewhisper")):
        raise NotImplementedError(f"backbone {name!r}: the port builds VarWhisper / RoPEWhisper only "
                                  "(other families: ROADMAP queue 1, item 11)")
    dims = next((d for key, d in WHISPER_DIMS.items() if name.endswith(key)), None)
    if dims is None:
        raise ValueError(f"unknown whisper size in backbone name: {name}")
    overwrite = dict(m.overwrite or {})
    tie = overwrite.pop("tie_word_embeddings", True)
    dropout = overwrite.pop("dropout", 0.0)
    mp = str(getattr(train_args, "mixed_precision", None) or "no").lower()
    compute_dtype = torch.bfloat16 if mp in ("bf16", "bfloat16", "fp16", "float16") else torch.float32

    backbone = TransformerConfig(
        vocab_size=vocab.vocab_size_out,
        d_model=overwrite.pop("d_model", dims["d_model"]),
        encoder_layers=overwrite.pop("encoder_layers", dims["layers"]),
        decoder_layers=overwrite.pop("decoder_layers", dims["layers"]),
        encoder_heads=overwrite.pop("encoder_attention_heads", dims["heads"]),
        decoder_heads=overwrite.pop("decoder_attention_heads", dims["heads"]),
        encoder_ffn=overwrite.pop("encoder_ffn_dim", dims["ffn"]),
        decoder_ffn=overwrite.pop("decoder_ffn_dim", dims["ffn"]),
        dropout=dropout,
        max_source_positions=train_args.data.src_seq_len // 2,
        max_target_positions=train_args.data.tgt_seq_len,
        num_mel_bins=dims["d_model"] if m.project_encoder_input else m.spectrogram.n_mels + m.cond_size,
        position_scheme="rope",
        rope_global_theta=m.global_rope_theta,
        rope_local_theta=m.local_rope_theta,
        rope_type=getattr(m, "rope_type", "default"),
        rope_encoder_scaling_factor=getattr(m, "rope_encoder_scaling_factor", 1.0),
        rope_decoder_scaling_factor=getattr(m, "rope_decoder_scaling_factor", 1.0),
        global_attn_every_n_layers=m.global_attn_every_n_layers,
        local_attention=m.local_attention,
        norm="rms",
        remat=bool(getattr(getattr(train_args, "parallel", None), "remat", False)),
        remat_policy=getattr(getattr(train_args, "parallel", None), "remat_policy", "full"),
        attention_bias=m.attention_bias,
        tie_word_embeddings=tie,
        pad_token_id=0,
        dtype=compute_dtype,
    )
    rhythm_start, rhythm_end = vocab.event_type_range(EventType.TIME_SHIFT)
    return MapperatorinatorConfig(
        backbone=backbone,
        vocab_size_in=vocab.vocab_size_in,
        vocab_size_out=vocab.vocab_size_out,
        num_classes=vocab.num_classes,
        num_mappers=vocab.num_mapper_classes,
        input_features=m.input_features,
        input_raw_wave=getattr(m, "input_raw_wave", False),
        project_encoder_input=m.project_encoder_input,
        embed_decoder_input=m.embed_decoder_input,
        do_style_embed=m.do_style_embed,
        do_difficulty_embed=m.do_difficulty_embed,
        do_mapper_embed=m.do_mapper_embed,
        do_song_position_embed=m.do_song_position_embed,
        cond_dim=m.cond_dim,
        cond_size=m.cond_size,
        spectrogram_implementation=m.spectrogram.implementation,
        spectrogram_log_scale=m.spectrogram.log_scale,
        sample_rate=m.spectrogram.sample_rate,
        n_fft=m.spectrogram.n_fft,
        n_mels=m.spectrogram.n_mels,
        hop_length=m.spectrogram.hop_length,
        f_min=m.spectrogram.f_min,
        f_max=m.spectrogram.f_max,
        pad_mode=m.spectrogram.pad_mode,
        rhythm_weight=train_args.data.rhythm_weight,
        rhythm_token_start=rhythm_start,
        rhythm_token_end=rhythm_end + 1,
        label_smoothing=train_args.data.label_smoothing,
        max_target_positions=train_args.data.tgt_seq_len,
    )


class Mapperatorinator(nn.Module):
    def __init__(self, cfg: MapperatorinatorConfig):
        super().__init__()
        for flag in ("input_raw_wave", "do_style_embed", "do_difficulty_embed", "do_mapper_embed",
                     "do_song_position_embed"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"MapperatorinatorConfig.{flag}: not ported yet "
                                          "(ROADMAP queue 1, item 10)")
        self.cfg = cfg
        b = cfg.backbone
        self.spectrogram = MelSpectrogram(
            implementation=cfg.spectrogram_implementation,
            log_scale=cfg.spectrogram_log_scale,
            sample_rate=cfg.sample_rate,
            n_fft=cfg.n_fft,
            n_mels=cfg.n_mels,
            hop_length=cfg.hop_length,
            f_min=cfg.f_min,
            f_max=cfg.f_max,
            pad_mode=cfg.pad_mode,
        )
        self.transformer = OsuTransformer(b, embed_inputs=not cfg.embed_decoder_input)
        if cfg.project_encoder_input:
            self.encoder_embedder = Dense(cfg.n_mels + cfg.cond_size, b.d_model, True, b.dtype)
        if cfg.embed_decoder_input:
            self.decoder_embedder = nn.Embedding(cfg.vocab_size_in, b.d_model)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """Raw audio samples (B, n_samples) -> encoder states (B, T, D)."""
        mel = self.spectrogram(frames).to(self.cfg.backbone.dtype)
        if self.cfg.project_encoder_input:
            mel = self.encoder_embedder(mel)
        return self.transformer.encode(mel)

    def forward(self, frames: Optional[torch.Tensor] = None, decoder_input_ids=None,
                decoder_attention_mask=None, encoder_states=None, labels: Optional[torch.Tensor] = None,
                sample_weights: Optional[torch.Tensor] = None):
        """Teacher-forced forward -> logits (B, T, vocab_size_out), or
        (logits, loss) when ``labels`` are given."""
        if encoder_states is None:
            encoder_states = self.encode(frames)
        logits = self.transformer(
            decoder_inputs_embeds=self.embed_tokens(decoder_input_ids),
            decoder_attention_mask=decoder_attention_mask,
            encoder_states=encoder_states,
        )
        if labels is None:
            return logits
        return logits, self.loss(logits, labels, sample_weights)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rhythm-weighted label-smoothed cross entropy, the mean over labels
        that are not ``LABEL_IGNORE_ID`` (torch's CE with label smoothing:
        (1 - eps) nll + eps mean_k(-log p_k), weighted by the target's class
        weight and the row's sample weight)."""
        cfg = self.cfg
        valid = labels != LABEL_IGNORE_ID
        safe = torch.where(valid, labels, 0)
        class_weights = torch.ones(cfg.vocab_size_out, device=logits.device)
        class_weights[cfg.rhythm_token_start:cfg.rhythm_token_end] = cfg.rhythm_weight
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        eps = cfg.label_smoothing
        nll = -log_probs.gather(-1, safe[..., None])[..., 0]
        per_tok = ((1 - eps) * nll + eps * -log_probs.mean(-1)) * class_weights[safe] * valid
        if sample_weights is not None:
            per_tok = per_tok * sample_weights[:, None]
        return per_tok.sum() / valid.sum().clamp(min=1)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.cfg.embed_decoder_input:
            return self.decoder_embedder(input_ids)
        return self.transformer.decoder.embed_tokens(input_ids)

    def init_cache(self, batch: int, max_len: int, encoder_states: torch.Tensor) -> list:
        return self.transformer.init_cache(batch, max_len, encoder_states)

    def decode_step(self, input_embeds, cache, cache_index: int, self_mask=None, positions=None):
        return self.transformer.decode_step(input_embeds, cache, cache_index, self_mask=self_mask,
                                            positions=positions)
