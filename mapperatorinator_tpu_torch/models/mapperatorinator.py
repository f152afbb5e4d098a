"""The Mapperatorinator model (``models/mapperatorinator.py``): mel front end,
the conditioning embedders, optional encoder projection, decoder token
table, the transformer and the rhythm-weighted, label-smoothed training
loss.

The conditioning embedders (v30 and v31 turn on the difficulty, mapper and
song-position ones; v32 none) each map a window's condition to a vector,
which :meth:`Mapperatorinator.encode` broadcasts over the window's frames
and concatenates after the mel, as the JAX model does. Parameters stay in
their own dtype (fp32 in training) and each backbone layer computes in
``backbone.dtype``, which the training config's ``mixed_precision`` sets;
the mel and the embedders compute in fp32 (the JAX model gives them no
dtype), the mel is cast to ``backbone.dtype`` before the concatenation,
which promotes, and the loss's log-softmax is fp32, as in the JAX model.
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

# T5 v1.1 sizes (HF google/t5-v1_1-*): d_kv stays 64 while heads * 64 != d_model
T5_DIMS = {
    "small": dict(d_model=512, layers=8, heads=6, ffn=1024, head_dim=64),
    "base": dict(d_model=768, layers=12, heads=12, ffn=2048, head_dim=64),
}

# HF UsefulSensors/moonshine-* (MoonshineConfig defaults)
MOONSHINE_DIMS = {
    "tiny": dict(d_model=288, layers=6, heads=8, ffn=1152),
    "base": dict(d_model=416, layers=8, heads=8, ffn=1664),
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


def _size(table: dict, family: str, name: str) -> dict:
    for key, dims in table.items():
        if name.endswith(key):
            return dims
    raise ValueError(f"unknown {family} size in backbone name: {name}")


def _t5_size(name: str) -> dict:
    return _size(T5_DIMS, "t5", name)


def build_config(train_args, vocab) -> MapperatorinatorConfig:
    """A MapperatorinatorConfig from a training config and a Vocabulary, for
    every backbone family of the JAX ``build_config``, in its dispatch order
    and with its defaults: NWhisper (``OliBomby/nwhisper-*``: nGPT blocks,
    the backbone embedding the decoder ids itself), T5 v1.1
    (``google/t5-v1_1-*``: relative positions, RMSNorm at eps 1e-6, gated
    tanh-GELU, unscaled bias-free attention of 64-wide heads, no conv
    stem), RoPE + RMSNorm (VarWhisper, RoPEWhisper), moonshine
    (``UsefulSensors/moonshine-*``: the raw-wave stem, partial rotation,
    bias-free LayerNorms and attention, the gated SiLU decoder
    feed-forward; an unknown size is tiny's) and stock whisper
    (``openai/whisper-*``: absolute positions + LayerNorm). Another name
    raises: the JAX package would build a VarWhisper of the name's size."""
    m = train_args.model
    name = m.name
    family, attention_bias = {}, m.attention_bias
    if name.startswith(("OliBomby/nwhisper", "olibomby/nwhisper")):
        dims = _size(WHISPER_DIMS, "whisper", name)
        position_scheme, norm = "whisper_abs", "layer"
        family = dict(norm_scheme="ngpt", input_vocab_size=vocab.vocab_size_in)
    elif name.startswith("google/t5"):
        dims = _t5_size(name)
        position_scheme, norm = "t5_relpos", "rms"
        attention_bias = False
        family = dict(head_dim_override=dims["head_dim"], attention_scale=False, ffn_gated=True, mlp_bias=False,
                      conv_stem=False, norm_eps=1e-6, activation="gelu_tanh")
    elif name.startswith(("OliBomby/varwhisper", "Tiger14n/ropewhisper")):
        dims = _size(WHISPER_DIMS, "whisper", name)
        position_scheme, norm = "rope", "rms"
    elif name.startswith("UsefulSensors/moonshine"):
        dims = MOONSHINE_DIMS.get(name.rsplit("-", 1)[-1], MOONSHINE_DIMS["tiny"])
        position_scheme, norm = "rope", "layer"
        attention_bias = False
        family = dict(norm_bias=False, stem_type="moonshine", rope_partial_factor=0.9, decoder_activation="silu",
                      decoder_ffn_gated_concat=True)
    elif "whisper" in name:
        dims = _size(WHISPER_DIMS, "whisper", name)
        position_scheme, norm = "whisper_abs", "layer"
    else:
        raise NotImplementedError(f"backbone {name!r}: the port builds NWhisper, T5 v1.1, VarWhisper, RoPEWhisper, "
                                  "moonshine and stock whisper")
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
        position_scheme=position_scheme,
        rope_global_theta=m.global_rope_theta,
        rope_local_theta=m.local_rope_theta,
        rope_type=getattr(m, "rope_type", "default"),
        rope_encoder_scaling_factor=getattr(m, "rope_encoder_scaling_factor", 1.0),
        rope_decoder_scaling_factor=getattr(m, "rope_decoder_scaling_factor", 1.0),
        global_attn_every_n_layers=m.global_attn_every_n_layers,
        local_attention=m.local_attention,
        norm=norm,
        remat=bool(getattr(getattr(train_args, "parallel", None), "remat", False)),
        remat_policy=getattr(getattr(train_args, "parallel", None), "remat_policy", "full"),
        attention_bias=attention_bias,
        tie_word_embeddings=tie,
        pad_token_id=0,
        dtype=compute_dtype,
        **family,
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


class RBFEmbedder(nn.Module):
    """Gaussian radial basis of a scalar: ``exp(-(x - c)^2 / (2 w^2))`` over
    ``num_basis`` learned centres ``c`` and widths ``w``."""

    def __init__(self, num_basis: int):
        super().__init__()
        self.basis_centers = nn.Parameter(torch.linspace(0, 1, num_basis))
        self.basis_widths = nn.Parameter(torch.full((num_basis,), 0.1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(-((x[..., None] - self.basis_centers) ** 2) / (2 * self.basis_widths**2))


class DifficultyEmbedder(nn.Module):
    """(B,) star rating -> (B, hidden): the RBF of ``difficulty / 10``, then
    Dense, LayerNorm, ReLU, Dropout, Dense, LayerNorm."""

    def __init__(self, hidden_size: int, max_difficulty: float = 10.0, num_basis: int = 8):
        super().__init__()
        self.max_difficulty = max_difficulty
        self.rbf = RBFEmbedder(num_basis)
        self.proj1 = nn.Linear(num_basis, hidden_size)
        self.norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.dropout = nn.Dropout(0.1)
        self.proj2 = nn.Linear(hidden_size, hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, difficulty: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.norm1(self.proj1(self.rbf(difficulty / self.max_difficulty))))
        return self.norm2(self.proj2(self.dropout(h)))


class MapperStyleEmbedder(nn.Module):
    """(B,) mapper ids -> (B, dim): id -1 (no mapper) takes the table's last
    row, ``num_mappers``, and every id is clipped into the table, so an id
    past it takes that row too; then Dropout and LayerNorm."""

    def __init__(self, num_mappers: int, embedding_dim: int):
        super().__init__()
        self.num_mappers = num_mappers
        self.table = nn.Embedding(num_mappers + 1, embedding_dim)
        self.dropout = nn.Dropout(0.1)
        self.norm = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, mapper_ids: torch.Tensor) -> torch.Tensor:
        ids = torch.where(mapper_ids == -1, self.num_mappers, mapper_ids).clamp(0, self.num_mappers)
        return self.norm(self.dropout(self.table(ids.long())))


class SongPositionEmbedder(nn.Module):
    """(B, 2) window start and end as fractions of the song -> (B, hidden):
    one RBF applied to both ends, concatenated, then Dense(2 hidden),
    LayerNorm, ReLU, Dropout, Dense, LayerNorm."""

    def __init__(self, hidden_size: int, num_basis: int = 10):
        super().__init__()
        self.rbf = RBFEmbedder(num_basis)
        self.proj1 = nn.Linear(2 * num_basis, 2 * hidden_size)
        self.norm1 = nn.LayerNorm(2 * hidden_size, eps=1e-5)
        self.dropout = nn.Dropout(0.1)
        self.proj2 = nn.Linear(2 * hidden_size, hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, position_range: torch.Tensor) -> torch.Tensor:
        combined = torch.cat([self.rbf(position_range[:, 0]), self.rbf(position_range[:, 1])], dim=-1)
        h = torch.relu(self.norm1(self.proj1(combined)))
        return self.norm2(self.proj2(self.dropout(h)))


def encoder_input_width(cfg: MapperatorinatorConfig) -> int:
    """The features :meth:`Mapperatorinator.encode` hands the encoder
    projection: the mels, then each embedded condition, as flax infers the
    JAX ``encoder_embedder``'s input width from them. It is ``n_mels +
    cond_size`` where ``cond_size`` counts the conditions; a style embedding
    adds ``d_model`` (the default model config embeds styles with
    ``cond_size`` 0)."""
    conds = cfg.do_difficulty_embed + cfg.do_mapper_embed + cfg.do_song_position_embed
    return cfg.n_mels + cfg.do_style_embed * cfg.backbone.d_model + conds * cfg.cond_dim


# the submodules that compute in fp32 whatever ``backbone.dtype`` is
FP32_MODULES = ("spectrogram", "style_embedder", "difficulty_embedder", "mapper_embedder", "song_pos_embedder")


class Mapperatorinator(nn.Module):
    def __init__(self, cfg: MapperatorinatorConfig):
        super().__init__()
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
        # a projected input reaches the stem at d_model channels: flax infers
        # the stem's input width, which build_config sizes from the name's
        # size table (the two differ where model.overwrite sets d_model)
        stem_input = dataclasses.replace(b, num_mel_bins=b.d_model) if cfg.project_encoder_input else b
        self.transformer = OsuTransformer(stem_input, embed_inputs=not cfg.embed_decoder_input)
        # under input_raw_wave the samples go to the stem alone: flax creates
        # no parameter of the mel path, whose modules it never calls
        mel_path = not cfg.input_raw_wave
        if cfg.do_style_embed and mel_path:
            self.style_embedder = nn.Embedding(cfg.num_classes + 1, b.d_model)
        if cfg.do_difficulty_embed and mel_path:
            self.difficulty_embedder = DifficultyEmbedder(cfg.cond_dim)
        if cfg.do_mapper_embed and mel_path:
            self.mapper_embedder = MapperStyleEmbedder(cfg.num_mappers, cfg.cond_dim)
        if cfg.do_song_position_embed and mel_path:
            self.song_pos_embedder = SongPositionEmbedder(cfg.cond_dim)
        if cfg.project_encoder_input and mel_path:
            self.encoder_embedder = Dense(encoder_input_width(cfg), b.d_model, True, b.dtype)
        if cfg.embed_decoder_input:
            self.decoder_embedder = nn.Embedding(cfg.vocab_size_in, b.d_model)

    def to_compute_dtype(self) -> "Mapperatorinator":
        """Every weight held at ``backbone.dtype`` but those of
        ``FP32_MODULES`` (the mel tables and the embedders), which stay fp32
        as they compute; int8 kernels and their scales stay as they are."""
        for name, child in self.named_children():
            if name not in FP32_MODULES:
                child.to(dtype=self.cfg.backbone.dtype)
        return self

    def encode(self, frames: torch.Tensor, beatmap_idx: Optional[torch.Tensor] = None,
               difficulty: Optional[torch.Tensor] = None, mapper_idx: Optional[torch.Tensor] = None,
               song_position: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Raw audio samples (B, n_samples) -> encoder states (B, T, D). The
        conditions the config embeds: ``beatmap_idx`` (B,) style ids (missing:
        the "no style" row ``num_classes``), ``difficulty`` (B,) star ratings,
        ``mapper_idx`` (B,) mapper ids (-1: none) and ``song_position`` (B, 2)
        the window's start and end as fractions of the song. Under
        ``input_raw_wave`` (moonshine) the samples go to the backbone's stem
        as one channel, with no mel and no conditions."""
        cfg = self.cfg
        if cfg.input_raw_wave:
            return self.transformer.encode(frames[..., None])
        mel = self.spectrogram(frames).to(cfg.backbone.dtype)
        conds = []
        if cfg.do_style_embed:
            if beatmap_idx is None:
                beatmap_idx = torch.full((frames.shape[0],), cfg.num_classes, dtype=torch.long, device=frames.device)
            conds.append(self.style_embedder(beatmap_idx.long()))
        if cfg.do_difficulty_embed:
            conds.append(self.difficulty_embedder(_given(difficulty, "difficulty")))
        if cfg.do_mapper_embed:
            conds.append(self.mapper_embedder(_given(mapper_idx, "mapper_idx")))
        if cfg.do_song_position_embed:
            conds.append(self.song_pos_embedder(_given(song_position, "song_position")))
        if conds:
            mel = torch.cat([mel, *(c[:, None, :].expand(-1, mel.shape[1], -1) for c in conds)], dim=-1)
        if cfg.project_encoder_input:
            mel = self.encoder_embedder(mel)
        return self.transformer.encode(mel)

    def forward(self, frames: Optional[torch.Tensor] = None, decoder_input_ids=None,
                decoder_attention_mask=None, encoder_states=None, labels: Optional[torch.Tensor] = None,
                sample_weights: Optional[torch.Tensor] = None, beatmap_idx=None, difficulty=None, mapper_idx=None,
                song_position=None, label_count: Optional[torch.Tensor] = None):
        """Teacher-forced forward -> logits (B, T, vocab_size_out), or
        (logits, loss) when ``labels`` are given (``label_count``:
        :meth:`loss`)."""
        if encoder_states is None:
            encoder_states = self.encode(frames, beatmap_idx, difficulty, mapper_idx, song_position)
        logits = self.transformer(
            decoder_inputs_embeds=self.embed_tokens(decoder_input_ids),
            decoder_attention_mask=decoder_attention_mask,
            encoder_states=encoder_states,
        )
        if labels is None:
            return logits
        return logits, self.loss(logits, labels, sample_weights, label_count)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor,
             sample_weights: Optional[torch.Tensor] = None,
             label_count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Rhythm-weighted label-smoothed cross entropy, the mean over labels
        that are not ``LABEL_IGNORE_ID`` (torch's CE with label smoothing:
        (1 - eps) nll + eps mean_k(-log p_k), weighted by the target's class
        weight and the row's sample weight). ``label_count`` replaces the
        batch's own count of such labels as the divisor: across processes it
        is every rank's count, so that the ranks' losses sum to the global
        batch's mean."""
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
        count = valid.sum() if label_count is None else label_count
        return per_tok.sum() / count.clamp(min=1)

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.cfg.embed_decoder_input:
            return self.decoder_embedder(input_ids)
        return self.transformer.decoder.embed(input_ids)

    def init_cache(self, batch: int, max_len: int, encoder_states: torch.Tensor) -> list:
        return self.transformer.init_cache(batch, max_len, encoder_states)

    def cross_cache(self, encoder_states: torch.Tensor) -> list:
        return self.transformer.cross_cache(encoder_states)

    def decode_step(self, input_embeds, cache, cache_index, self_mask=None, positions=None,
                    limit: Optional[int] = None, k_positions: Optional[torch.Tensor] = None):
        return self.transformer.decode_step(input_embeds, cache, cache_index, self_mask=self_mask,
                                            positions=positions, limit=limit, k_positions=k_positions)


def _given(condition: Optional[torch.Tensor], name: str) -> torch.Tensor:
    if condition is None:
        raise ValueError(f"the model embeds {name}, and none was given")
    return condition


def build_model(cfg: MapperatorinatorConfig, device) -> Mapperatorinator:
    """``Mapperatorinator(cfg)`` with its parameters allocated and initialised
    on ``device`` (the mel tables, made with numpy, are moved there)."""
    with torch.device(device):
        return Mapperatorinator(cfg).to(device)
