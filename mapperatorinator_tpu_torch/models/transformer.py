"""The seq2seq transformer, VarWhisper family (``models/transformer.py``).

The v32 backbone: a whisper conv stem, RoPE (rotate-half, fp32, with the
dynamic-NTK base), RMSNorm, pre-norm blocks, alternating local/global
self-attention, exact-erf GELU feed-forwards, fused ``wqkv`` / ``wkv``
projections. Every other family of the JAX ``TransformerConfig`` raises.

Dtypes follow the flax modules op by op rather than ``torch.autocast``: the
projections and the conv stem compute in ``cfg.dtype`` whatever the dtype of
their parameters (flax's ``dtype`` / ``param_dtype``: bf16 mixed-precision
training keeps fp32 parameters), while RoPE, RMSNorm and the softmax compute
in fp32 and cast back.

Attention follows the JAX routing. A call that is structurally eligible for
the flash kernel (no cache, no position bias, scaled, at most a key-padding
mask) goes to :func:`..ops.attention_kernel.flash_attention`, for every shape:
the JAX package's ``flash_min_logits`` gate is a TPU v5e measurement and is
not carried over. Cached decode attention is plain PyTorch over the live
prefix of the cache. The KV cache is preallocated and updated in place (the
JAX package returns a new cache; the dicts returned here are the same
objects that were passed in).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention_kernel import NEG_INF, flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Field for field the JAX ``TransformerConfig``, so a native checkpoint's
    ``model_config.json`` loads unchanged; see the JAX class for each field."""

    vocab_size: int = 4096
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    activation: str = "gelu"
    dropout: float = 0.0
    max_source_positions: int = 1024
    max_target_positions: int = 2048
    num_mel_bins: int = 512
    position_scheme: str = "rope"
    rope_global_theta: float = 10000.0
    rope_local_theta: float = 10000.0
    rope_type: str = "default"
    rope_encoder_scaling_factor: float = 1.0
    rope_decoder_scaling_factor: float = 1.0
    global_attn_every_n_layers: int = 1
    local_attention: int = 128
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    input_vocab_size: Optional[int] = None
    norm: str = "rms"
    norm_eps: Optional[float] = None
    norm_scheme: str = "prenorm"
    ngpt_alpha_init: float = 0.05
    ngpt_alpha_pos_init: float = 0.1
    use_flash_attention: bool = True
    banded_local_attention: bool = False
    flash_min_logits: int = 12 * 2560 * 2560
    remat: bool = False
    remat_policy: str = "full"
    quantized_weights: bool = False
    quantized_kv: bool = False
    decode_attend_bucket: int = 256
    attention_bias: bool = True
    attention_scale: bool = True
    mlp_bias: bool = True
    ffn_gated: bool = False
    decoder_ffn_gated_concat: bool = False
    decoder_activation: Optional[str] = None
    norm_bias: bool = True
    conv_stem: bool = True
    stem_type: str = "whisper"
    rope_partial_factor: float = 1.0
    scale_embedding: bool = False
    tie_word_embeddings: bool = False
    pad_token_id: int = 0
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    head_dim_override: Optional[int] = None

    @property
    def head_dim(self) -> int:
        if self.head_dim_override is not None:
            return self.head_dim_override
        return self.d_model // self.decoder_heads


# (field, value the port supports, ROADMAP queue 1 item that ports the rest)
_SUPPORTED = (
    ("position_scheme", "rope", 11),
    ("norm", "rms", 11),
    ("norm_scheme", "prenorm", 11),
    ("stem_type", "whisper", 11),
    ("conv_stem", True, 11),
    ("rope_partial_factor", 1.0, 11),
    ("activation", "gelu", 11),
    ("decoder_activation", None, 11),
    ("ffn_gated", False, 11),
    ("decoder_ffn_gated_concat", False, 11),
    ("attention_scale", True, 11),
    ("scale_embedding", False, 11),
    ("head_dim_override", None, 11),
    ("quantized_weights", False, 14),
    ("quantized_kv", False, 14),
    ("banded_local_attention", False, 11),
)


def check_supported(cfg: TransformerConfig) -> None:
    """The port covers the VarWhisper (v32) family; raise for the rest."""
    for field, value, item in _SUPPORTED:
        if getattr(cfg, field) != value:
            raise NotImplementedError(
                f"TransformerConfig.{field}={getattr(cfg, field)!r}: the port supports only "
                f"{value!r} so far (ROADMAP queue 1, item {item})"
            )


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: flax ``Dense(dtype=...)``
    casts its input, kernel and bias to the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in ``compute_dtype``, as flax ``Conv(dtype=...)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class RMSNorm(nn.Module):
    """RMSNorm computed in fp32; default eps matches torch.nn.RMSNorm on fp32."""

    def __init__(self, dim: int, eps: Optional[float]):
        super().__init__()
        self.eps = eps if eps is not None else 1.1920929e-7
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE in fp32. x: (B, T, H, D); positions: (B, T)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def dynamic_ntk_theta(theta: float, head_dim: int, seq_len: int, max_positions: int, factor: float) -> float:
    """HF dynamic-NTK base rescaling; identity while seq_len fits the trained range."""
    if seq_len <= max_positions or factor <= 0:
        return theta
    scale = (factor * seq_len / max_positions) - (factor - 1)
    return theta * scale ** (head_dim / (head_dim - 2))


def sliding_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """True where |q_pos - k_pos| <= window // 2."""
    return (q_pos[:, None] - k_pos[None, :]).abs() <= window // 2


def attend(q, k, v, mask: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D); scaled, softmax in fp32,
    masked logits at finfo(fp32).min (the JAX ``_attend``)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * q.shape[-1] ** -0.5
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Attention(nn.Module):
    """Self or cross attention with RoPE, causal and sliding-window masks and
    a preallocated cache for step-by-step decode."""

    def __init__(self, cfg: TransformerConfig, num_heads: int, is_cross: bool = False,
                 is_causal: bool = False, is_decoder: bool = False, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.num_heads = num_heads
        self.is_cross = is_cross
        self.is_causal = is_causal
        self.is_decoder = is_decoder
        self.is_local = layer_idx % cfg.global_attn_every_n_layers != 0
        # attention calls that the flash kernel covers go to it; cleared, they
        # take the plain path (chip_smoke.py holds the two against each other)
        self.use_flash = cfg.use_flash_attention
        inner = num_heads * (cfg.d_model // num_heads)
        bias, dt = cfg.attention_bias, cfg.dtype
        if is_cross:
            self.wq = Dense(cfg.d_model, inner, bias, dt)
            self.wkv = Dense(cfg.d_model, 2 * inner, bias, dt)
        else:
            self.wqkv = Dense(cfg.d_model, 3 * inner, bias, dt)
        self.wo = Dense(inner, cfg.d_model, bias, dt)

    @property
    def rope_theta(self) -> float:
        return self.cfg.rope_local_theta if self.is_local else self.cfg.rope_global_theta

    def forward(
        self,
        x: torch.Tensor,
        kv_source: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        cache_index: Optional[int] = None,
    ):
        """Returns (out, cache). ``cache`` holds (B, max_len, H, D) k/v written
        in place at ``cache_index``; cross attention reads its k/v from the
        cache when one is given. ``attn_mask`` is a (B, 1, 1, S) key mask."""
        cfg = self.cfg
        b, t, _ = x.shape
        h = self.num_heads

        if self.is_cross:
            q = self.wq(x).view(b, t, h, -1)
            if cache is not None:
                k, v = cache["k"], cache["v"]
            else:
                kv = self.wkv(kv_source)
                kv = kv.view(b, kv.shape[1], 2 * h, -1)
                k, v = kv[:, :, :h], kv[:, :, h:]
            if cache is None and self.use_flash and _key_mask_only(attn_mask):
                out = flash_attention(q, k, v, _key_mask(attn_mask))
            else:
                out = attend(q, k, v, attn_mask, cfg.dtype)
            return self.wo(out.reshape(b, t, -1)), cache

        qkv = self.wqkv(x).view(b, t, 3 * h, -1)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
        theta = self.rope_theta
        if cfg.rope_type == "dynamic":
            seq_len = cache["k"].shape[1] if cache is not None else t
            max_pos = cfg.max_target_positions if self.is_decoder else cfg.max_source_positions
            factor = cfg.rope_decoder_scaling_factor if self.is_decoder else cfg.rope_encoder_scaling_factor
            theta = dynamic_ntk_theta(theta, cfg.head_dim, seq_len, max_pos, factor)
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)

        if cache is not None:
            # keys past the last written slot are causally masked for every
            # query, so only the live prefix of the buffer is read
            end = cache_index + t
            cache["k"][:, cache_index:end] = k.to(cache["k"].dtype)
            cache["v"][:, cache_index:end] = v.to(cache["v"].dtype)
            k, v = cache["k"][:, :end], cache["v"][:, :end]
            k_pos = torch.arange(end, device=x.device)
            q_pos = cache_index + torch.arange(t, device=x.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if self.is_local:
                mask = mask & sliding_window_mask(q_pos, k_pos, cfg.local_attention)
            mask = mask[None, None]
            if attn_mask is not None:
                mask = mask & attn_mask[..., :end]
            out = attend(q, k, v, mask, cfg.dtype)
        elif self.use_flash and _key_mask_only(attn_mask):
            out = flash_attention(
                q, k, v, _key_mask(attn_mask),
                causal=self.is_causal,
                window=cfg.local_attention if self.is_local else 0,
            )
        else:
            pos = positions[0]
            mask = attn_mask
            if self.is_causal:
                causal = (pos[:, None] >= pos[None, :])[None, None]
                mask = causal if mask is None else mask & causal
            if self.is_local:
                band = sliding_window_mask(pos, pos, cfg.local_attention)[None, None]
                mask = band if mask is None else mask & band
            out = attend(q, k, v, mask, cfg.dtype)
        return self.wo(out.reshape(b, t, -1)), cache


def _key_mask_only(attn_mask: Optional[torch.Tensor]) -> bool:
    return attn_mask is None or (attn_mask.dim() == 4 and attn_mask.shape[1] == 1 and attn_mask.shape[2] == 1)


def _key_mask(attn_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return attn_mask[:, 0, 0, :] if attn_mask is not None else None


class FeedForward(nn.Module):
    def __init__(self, cfg: TransformerConfig, ffn_dim: int):
        super().__init__()
        self.fc1 = Dense(cfg.d_model, ffn_dim, cfg.mlp_bias, cfg.dtype)
        self.fc2 = Dense(ffn_dim, cfg.d_model, cfg.mlp_bias, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, layer_idx: int):
        super().__init__()
        self.self_attn = Attention(cfg, cfg.encoder_heads, layer_idx=layer_idx)
        self.ffn = FeedForward(cfg, cfg.encoder_ffn)
        self.self_attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def forward(self, x, positions, attn_mask=None):
        x = x + self.self_attn(self.self_attn_norm(x), positions=positions, attn_mask=attn_mask)[0]
        return x + self.ffn(self.final_norm(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, layer_idx: int):
        super().__init__()
        self.self_attn = Attention(cfg, cfg.decoder_heads, is_causal=True, is_decoder=True, layer_idx=layer_idx)
        self.cross_attn = Attention(cfg, cfg.decoder_heads, is_cross=True)
        self.ffn = FeedForward(cfg, cfg.decoder_ffn)
        self.self_attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.cross_attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def forward(self, x, encoder_states, positions, self_mask=None, cross_mask=None,
                cache: Optional[dict] = None, cache_index: Optional[int] = None):
        attn_out, _ = self.self_attn(
            self.self_attn_norm(x), positions=positions, attn_mask=self_mask,
            cache=cache["self"] if cache is not None else None, cache_index=cache_index,
        )
        x = x + attn_out
        cross_out, _ = self.cross_attn(
            self.cross_attn_norm(x), kv_source=encoder_states, attn_mask=cross_mask,
            cache=cache["cross"] if cache is not None else None,
        )
        x = x + cross_out
        return x + self.ffn(self.final_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1, compute_dtype=cfg.dtype)
        self.conv2 = Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1, compute_dtype=cfg.dtype)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i) for i in range(cfg.encoder_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def forward(self, features: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, num_mel_bins) -> (B, ceil(T / 2), D)."""
        x = features.to(self.cfg.dtype).transpose(1, 2)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        b, t, _ = x.shape
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for layer in self.layers:
            x = layer(x, positions, attn_mask)
        return self.norm(x)


class Decoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, embed_inputs: bool):
        super().__init__()
        self.cfg = cfg
        if embed_inputs or cfg.tie_word_embeddings:
            self.embed_tokens = nn.Embedding(cfg.input_vocab_size or cfg.vocab_size, cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.decoder_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.norm_eps)

    def forward(self, inputs_embeds, encoder_states, positions=None, self_mask=None,
                cross_mask=None, cache: Optional[list] = None, cache_index: Optional[int] = None):
        x = inputs_embeds.to(self.cfg.dtype)
        b, t, _ = x.shape
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        for i, layer in enumerate(self.layers):
            x = layer(x, encoder_states, positions, self_mask, cross_mask,
                      cache[i] if cache is not None else None, cache_index)
        return self.norm(x)


class OsuTransformer(nn.Module):
    """Encoder-decoder with LM head. ``forward`` is the teacher-forced path;
    ``init_cache`` / ``decode_step`` the cached autoregressive one.
    ``embed_inputs`` gives the decoder its own token table (the JAX decoder
    creates it on first use; a wrapper that embeds its own ids has none)."""

    def __init__(self, cfg: TransformerConfig, embed_inputs: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, embed_inputs)
        if not cfg.tie_word_embeddings:
            self.proj_out = Dense(cfg.d_model, cfg.vocab_size, False, cfg.dtype)

    def lm_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_word_embeddings:
            return x @ self.decoder.embed_tokens.weight.to(x.dtype).T
        return self.proj_out(x)

    def encode(self, features: torch.Tensor) -> torch.Tensor:
        return self.encoder(features)

    def forward(self, features=None, decoder_inputs_embeds=None, decoder_input_ids=None,
                decoder_attention_mask=None, encoder_states=None) -> torch.Tensor:
        """Teacher-forced forward -> logits (B, T, vocab)."""
        if encoder_states is None:
            encoder_states = self.encoder(features)
        if decoder_inputs_embeds is None:
            decoder_inputs_embeds = self.decoder.embed_tokens(decoder_input_ids)
        self_mask = None
        if decoder_attention_mask is not None:
            self_mask = decoder_attention_mask[:, None, None, :].bool()
        return self.lm_head(self.decoder(decoder_inputs_embeds, encoder_states, self_mask=self_mask))

    def init_cache(self, batch: int, max_len: int, encoder_states: torch.Tensor) -> list:
        """Preallocated self-attention k/v and the cross k/v, computed once."""
        cfg = self.cfg
        h, d = cfg.decoder_heads, cfg.head_dim
        caches = []
        for layer in self.decoder.layers:
            kv = layer.cross_attn.wkv(encoder_states)
            kv = kv.view(kv.shape[0], kv.shape[1], 2 * h, d)
            zeros = lambda: torch.zeros((batch, max_len, h, d), dtype=cfg.dtype, device=encoder_states.device)  # noqa: E731
            caches.append({
                "self": {"k": zeros(), "v": zeros()},
                "cross": {"k": kv[:, :, :h].to(cfg.dtype), "v": kv[:, :, h:].to(cfg.dtype)},
            })
        return caches

    def decode_step(self, input_embeds, cache: list, cache_index: int, self_mask=None,
                    cross_mask=None, positions=None):
        """One step (or a chunk) of cached decode: ``input_embeds`` (B, t, D)
        are written at cache slots ``cache_index .. cache_index + t``;
        ``positions`` (B, t) are the RoPE positions (default: the slots).
        Returns (logits, cache)."""
        b, t, _ = input_embeds.shape
        if positions is None:
            positions = (cache_index + torch.arange(t, device=input_embeds.device))[None].expand(b, t)
        x = self.decoder(input_embeds, None, positions=positions, self_mask=self_mask,
                         cross_mask=cross_mask, cache=cache, cache_index=cache_index)
        return self.lm_head(x), cache
