"""The seq2seq transformer (``models/transformer.py``): the whisper, T5,
nGPT and moonshine families.

Every position scheme and block structure of the JAX ``TransformerConfig``
that a published backbone uses is ported. ``rope``
(VarWhisper, v32; RoPEWhisper, v30 and v31): rotate-half RoPE in fp32 with
the dynamic-NTK base, RMSNorm, alternating local/global self-attention.
``whisper_abs`` (stock whisper, v28 and v29): fixed sinusoids added after
the encoder's conv stem, a learned decoder position table
(``embed_positions``, indexed by each token's logical position) and
LayerNorm, with no rotation. Both are pre-norm with exact-erf GELU
feed-forwards, a whisper conv stem and fused ``wqkv`` / ``wkv`` projections
(an HF checkpoint's split q / k / v are concatenated on load,
:mod:`.convert`). ``t5_relpos`` (T5 v1.1, the legacy osuT5 backbone): no
conv stem, a learned relative-position bias per stack
(:class:`RelativePositionBias`) added to every self-attention's logits,
unscaled and bias-free attention of ``head_dim_override`` wide heads, and a
gated tanh-GELU (or ReLU) feed-forward with no biases, RMSNorm at eps 1e-6.
``norm_scheme="ngpt"`` (NWhisper, ``OliBomby/nwhisper-*``): hidden states
and weight rows on the unit sphere, every projection a :class:`NormDense`
(its weight l2-normalised on each forward), separate ``wq`` / ``wk`` /
``wv`` / ``wo``, q and k l2-normalised per head after the cache is read and
scaled by a learned ``qk_scale`` (q by sqrt(D) too) with unscaled logits,
slerp residuals (:class:`HyperResidual`) in place of norms, a learned
encoder position table (``embed_positions``, a bare parameter) and the
decoder's table each reached by a slerp, and a normalised head times a
learned ``logit_scale``. Moonshine (``UsefulSensors/moonshine-*``): a
raw-wave conv stem (conv 127 / 64 without bias, tanh, a one-group
GroupNorm, conv 7 / 3 and conv 3 / 2 with GELUs), a partial GPT-J style
rotation (:func:`apply_rope_interleaved_partial`) of ``rope_partial_factor``
of each head, bias-free LayerNorms and attention, and a gated-concat SiLU
decoder feed-forward that stays a plain ``Dense`` under int8.
``position_scheme="none"`` (a CM3P tower may use it) adds no position
information anywhere, as the JAX modules' branches do.

Dtypes follow the flax modules op by op rather than ``torch.autocast``: the
projections and the conv stem compute in ``cfg.dtype`` whatever the dtype of
their parameters (flax's ``dtype`` / ``param_dtype``: bf16 mixed-precision
training keeps fp32 parameters), while RoPE, RMSNorm, LayerNorm, GroupNorm
(flax's statistics: ``E[x^2] - E[x]^2``, clipped at 0), the nGPT
normalisations and the softmax compute in fp32 and cast back.

Attention follows the JAX routing. A call that is structurally eligible for
the flash kernel (no cache, no position bias, at most a key-padding mask)
goes to :func:`..ops.attention_kernel.flash_attention`, for every shape, at
``sm_scale`` 1.0 where the attention is unscaled (T5's cross attention and
every nGPT call; the JAX package sends those to its plain ``_attend``
because its TPU gate refuses unscaled calls, and both compute the same
function): the JAX package's ``flash_min_logits`` gate is a TPU v5e
measurement and is not carried over. ``banded_local_attention`` changes
nothing: the JAX chunked band computes the band mask's function, which the
kernel's ``window`` computes. A call with a position bias (T5's
self-attention) is plain :func:`attend`. On a CUDA tensor a head width the
kernels refuse raises at the call, as for every family. Cached decode
attention is plain PyTorch
over a static prefix of the cache: the end of the ``decode_attend_bucket``
bucket that holds the write slot, which the caller passes as ``limit``, so
that a step indexed by a device tensor has static shapes and can be
captured in a CUDA graph. The KV cache is preallocated and updated in place (the JAX package
returns a new cache; the dicts returned here are the same objects that were
passed in).

On the tensor axis (``parallel.tensor_axis``) each attention and
feed-forward block computes on its rank's share (:class:`TensorBlock`,
:mod:`..parallel.tensor`), where GSPMD partitions the unchanged JAX modules.

The int8 options follow the JAX package too: ``quantized_weights`` makes
every attention projection, feed-forward layer and untied LM head a
:class:`QDense` (int8 kernel, fp32 per-column scale, routed through kernel D
where the JAX gate admits the shape), but for nGPT's :class:`NormDense`
sites and moonshine's gated decoder feed-forward, which stay as they are;
``quantized_kv`` stores the cache as
int8 with an fp32 scale per token and head, quantized after RoPE on write and
dequantized in ``cfg.dtype`` on read (nGPT caches its raw keys).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention_kernel import NEG_INF, flash_attention
from ..ops.qmm_kernel import qmm, qmm_plain, qmm_supported
from ..parallel.tensor import column, row, whole_columns, whole_rows


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


# (field, the values the port builds): every value the JAX modules branch on
_SUPPORTED = (
    ("position_scheme", ("rope", "whisper_abs", "t5_relpos", "none")),
    ("norm", ("rms", "layer")),
    ("norm_scheme", ("prenorm", "ngpt")),
    ("stem_type", ("whisper", "moonshine")),
)

# the feed-forward activations: torch's exact-erf GELU, the tanh form (HF's
# gelu_new, T5 v1.1's gated-gelu), ReLU and SiLU (moonshine's decoder)
ACTIVATIONS = {"gelu": F.gelu, "gelu_tanh": functools.partial(F.gelu, approximate="tanh"), "relu": F.relu,
               "silu": F.silu}

def check_supported(cfg: TransformerConfig) -> None:
    """Raise for a config the port cannot build: a value no JAX branch
    takes, or an activation it does not know. A head dim the attention
    kernels do not take builds; on a card its first kernel call raises."""
    for field, values in _SUPPORTED:
        if getattr(cfg, field) not in values:
            raise NotImplementedError(f"TransformerConfig.{field}={getattr(cfg, field)!r}: the port builds "
                                      f"{' or '.join(map(repr, values))}")
    for field in ("activation", "decoder_activation"):
        if getattr(cfg, field) not in (*ACTIVATIONS, None):
            raise NotImplementedError(f"TransformerConfig.{field}={getattr(cfg, field)!r}: the port builds "
                                      f"{' or '.join(map(repr, ACTIVATIONS))}")


class Dense(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype``: flax ``Dense(dtype=...)``
    casts its input, kernel and bias to the compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, self.weight, self.bias)

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The layer's product with the given weight and bias (a tensor
        rank's shards of them, :mod:`..parallel.tensor`)."""
        dt = self.compute_dtype
        return F.linear(x.to(dt), weight.to(dt), None if bias is None else bias.to(dt))


class QDense(nn.Module):
    """Weight-only int8 dense layer, the JAX ``QDense``:
    ``(x @ kernel_q) * scale + bias`` with ``kernel_q`` (in, out) int8 and
    ``scale`` (out,) fp32 held as buffers (int8 cannot take a gradient) and
    the bias a parameter. Where the JAX gate :func:`qmm_supported` admits the
    shape, the product is :func:`qmm` (kernel D on a CUDA tensor), summed and
    scaled in fp32; elsewhere it is the JAX fallback expression in the
    compute dtype, which rounds at other places in bf16. :func:`quantize_model`
    fills the buffers from a trained model."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = compute_dtype
        self.register_buffer("kernel_q", torch.zeros((in_features, out_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        # gated calls go to qmm; cleared, to its plain version (chip_smoke.py
        # holds the two against each other)
        self.use_kernel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k, n = self.compute_dtype, self.in_features, self.out_features
        lead = x.shape[:-1]
        if qmm_supported(k, n, math.prod(lead)):
            product = qmm if self.use_kernel else qmm_plain
            y = product(x.to(dt).reshape(-1, k).contiguous(), self.kernel_q, self.scale).reshape(*lead, n)
        else:
            y = (x.to(dt) @ self.kernel_q.to(dt)) * self.scale.to(dt)
        if self.bias is not None:
            y = y + self.bias.to(dt)
        return y

    def _apply(self, fn, recurse=True):
        # a dtype cast (``model.to(bf16)``) leaves the scale fp32, as the JAX
        # quantize_params stores it; a move to another device moves it
        scale = self.scale
        super()._apply(fn, recurse)
        self.scale = scale.to(fn(scale[:0]).device)
        return self


def quantize_weight(kernel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An (in, out) kernel -> (int8 kernel, fp32 per-output-channel scale), the
    JAX ``quantize_params`` rule: ``scale = max(max |W| over in, 1e-8) / 127``,
    then ``clip(round_half_even(W / scale), -128, 127)``, all in fp32."""
    w = kernel.float()
    scale = w.abs().amax(dim=0).clamp(min=1e-8) / 127
    return torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8), scale


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, H, D) -> (int8 values, (B, T, H) fp32 scales): symmetric
    max-abs quantization per token and head, in fp32."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp(min=1e-8) / 127.0
    return torch.round(xf / scale[..., None]).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, in ``dtype``."""
    return q.to(dtype) * scale[..., None].to(dtype)


def _read_kv(cache: dict, end: Optional[int], dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The cached k and v up to slot ``end`` (all slots for None), sliced
    before an int8 cache is dequantized."""
    k, v = cache["k"][:, :end], cache["v"][:, :end]
    if "k_scale" in cache:
        k = dequantize_kv(k, cache["k_scale"][:, :end], dtype)
        v = dequantize_kv(v, cache["v_scale"][:, :end], dtype)
    return k, v


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` that computes in ``compute_dtype``, as flax ``Conv(dtype=...)``."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), None if self.bias is None else self.bias.to(dt))


class RMSNorm(nn.Module):
    """RMSNorm computed in fp32; default eps matches torch.nn.RMSNorm on fp32.
    flax nests it in the ``Norm`` wrapper as ``RMSNorm_0``."""

    flax_scope = "RMSNorm_0"

    def __init__(self, dim: int, eps: Optional[float]):
        super().__init__()
        self.eps = eps if eps is not None else 1.1920929e-7
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """The flax ``nn.LayerNorm`` of the JAX ``Norm``: statistics in fp32 with
    the fast variance ``E[x^2] - E[x]^2`` clipped at 0, then
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, cast back; default
    eps 1e-5. flax nests it in the ``Norm`` wrapper as ``LayerNorm_0``."""

    flax_scope = "LayerNorm_0"

    def __init__(self, dim: int, eps: Optional[float], bias: bool = True):
        super().__init__()
        self.eps = eps if eps is not None else 1e-5
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp(min=0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(x.dtype)


def norm_layer(cfg: TransformerConfig) -> nn.Module:
    """The JAX ``Norm`` for ``cfg.norm``; the identity under nGPT, whose
    hidden states are unit vectors already."""
    if cfg.norm_scheme == "ngpt":
        return nn.Identity()
    if cfg.norm == "rms":
        return RMSNorm(cfg.d_model, cfg.norm_eps)
    return LayerNorm(cfg.d_model, cfg.norm_eps, cfg.norm_bias)


class GroupNorm(nn.Module):
    """The flax ``nn.GroupNorm(num_groups=1)`` of moonshine's stem on a
    (B, C, L) tensor: statistics over C and L in fp32 with the fast
    variance clipped at 0, then ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` per channel, cast back."""

    flax_weight = "scale"

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean((1, 2), keepdim=True)
        var = ((xf * xf).mean((1, 2), keepdim=True) - mean * mean).clamp(min=0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float()[:, None]) + self.bias.float()[:, None]
        return y.to(x.dtype)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||, eps)`` along ``dim``, the JAX ``l2norm``: a zero
    vector stays 0."""
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp(min=eps)


class HyperScale(nn.Module):
    """The JAX ``HyperScale``: a (dim,) parameter stored at ``scale`` and
    multiplied by ``init / scale`` on each forward, in fp32."""

    flax_weight = "scale"

    def __init__(self, dim: int, init: float, scale: float):
        super().__init__()
        self.init_value, self.stored = init, scale
        self.weight = nn.Parameter(torch.full((dim,), scale))

    def flax_init(self, leaf: str) -> torch.Tensor:
        """The value flax initialises ``leaf`` to."""
        return torch.full_like(self.weight, self.stored)

    def forward(self) -> torch.Tensor:
        return self.weight.float() * (self.init_value / self.stored)


class NormDense(Dense):
    """The JAX ``NormDense``: a dense layer whose weight is l2-normalised on
    every forward, in fp32, along its input axis (``norm_dim_in``) or else
    its output axis. flax normalises axis 0 of its (in, out) kernel under
    ``norm_dim_in``: axis 1 of the (out, in) weight here."""

    def __init__(self, in_features: int, out_features: int, bias: bool, compute_dtype: torch.dtype,
                 norm_dim_in: bool = True):
        super().__init__(in_features, out_features, bias, compute_dtype)
        self.norm_dim_in = norm_dim_in

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        # per output row (norm_dim_in) or per input column: local to a column or a row shard
        return super().linear(x, l2norm(weight.float(), dim=1 if self.norm_dim_in else 0), bias)


class HyperResidual(nn.Module):
    """The JAX ``HyperResidual``: ``l2norm(x + alpha (l2norm(branch) - x))``
    with a learned per-dim rate ``alpha`` (``branch_scale``)."""

    def __init__(self, dim: int, alpha_init: float):
        super().__init__()
        self.branch_scale = HyperScale(dim, alpha_init, dim**-0.5)

    def forward(self, x: torch.Tensor, branch_out: torch.Tensor) -> torch.Tensor:
        return l2norm(x + self.branch_scale() * (l2norm(branch_out) - x))


def whisper_sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal positions (length, channels), in fp32."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv_timescales = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv_timescales[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5's bucket of each ``key - query`` distance (int64): exact below
    ``max_exact``, log-spaced up to ``max_distance``, then the last bucket;
    the JAX ``relative_position_bucket`` op for op (an fp32 ``log``,
    truncated toward zero). :class:`RelativePositionBias` evaluates it once,
    on the CPU, where its values are held to the JAX package's."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(ret.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(ret.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    """One stack's T5 position bias (the JAX ``RelativePositionBias``, flax
    ``rel_bias/embedding``): a (num_buckets, H) table indexed by each (query,
    key) distance's bucket. The bucket of every distance is computed once,
    on the CPU, into ``buckets``, an int table over the distances
    -``span`` .. ``span``; past ``max_distance`` every distance shares the
    last bucket of its sign, so a distance is clamped into that span and
    the table is gathered on the device. No ``log`` is evaluated there: an
    fp32 ``log`` on the card may differ from XLA's by an ulp, which moves a
    distance at a bucket boundary into the next bucket."""

    def __init__(self, cfg: TransformerConfig, num_heads: int, bidirectional: bool):
        super().__init__()
        self.embedding = nn.Embedding(cfg.relative_attention_num_buckets, num_heads)
        self.span = cfg.relative_attention_max_distance + 1
        distances = torch.arange(-self.span, self.span + 1, device="cpu")
        self.register_buffer("buckets", relative_position_bucket(
            distances, bidirectional, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance),
            persistent=False)

    def forward(self, q_pos: torch.Tensor, k_pos: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """1-D positions -> (1, H, Tq, Tk); per-row (B, Tq) and (B, Tk) ->
        (B, H, Tq, Tk). The table is read in ``dtype`` (flax ``Embed``'s
        compute dtype, so a bf16 model's bias is rounded to bf16)."""
        if q_pos.dim() == 2:
            rel = k_pos[:, None, :] - q_pos[:, :, None]
        else:
            rel = (k_pos[None, :] - q_pos[:, None])[None]
        buckets = self.buckets[rel.clamp(-self.span, self.span) + self.span]
        return F.embedding(buckets, self.embedding.weight.to(dtype)).permute(0, 3, 1, 2)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE in fp32. x: (B, T, H, D); positions: (B, T)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions[..., None].float() * inv_freq
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope_interleaved_partial(x: torch.Tensor, positions: torch.Tensor, theta: float,
                                   rotary_dim: int) -> torch.Tensor:
    """Moonshine's rotation in fp32: the first ``rotary_dim`` dims of each
    head rotate in pairs (x0, x1) -> (-x1, x0), GPT-J style, with each
    frequency's cos and sin repeated for the two dims of its pair; the rest
    pass through. x: (B, T, H, D); positions: (B, T)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32, device=x.device) / rotary_dim))
    angles = positions[..., None].float() * inv_freq
    cos = torch.repeat_interleave(torch.cos(angles), 2, dim=-1)[:, :, None, :]
    sin = torch.repeat_interleave(torch.sin(angles), 2, dim=-1)[:, :, None, :]
    xf = x.float()
    x_rot, x_pass = xf[..., :rotary_dim], xf[..., rotary_dim:]
    rot = torch.stack([-x_rot[..., 1::2], x_rot[..., 0::2]], dim=-1).reshape(x_rot.shape)
    return torch.cat([x_rot * cos + rot * sin, x_pass], dim=-1).to(x.dtype)


def dynamic_ntk_theta(theta: float, head_dim: int, seq_len: int, max_positions: int, factor: float) -> float:
    """HF dynamic-NTK base rescaling; identity while seq_len fits the trained range."""
    if seq_len <= max_positions or factor <= 0:
        return theta
    scale = (factor * seq_len / max_positions) - (factor - 1)
    return theta * scale ** (head_dim / (head_dim - 2))


def decode_read_limit(bucket: int, cache_index: int, buffer_len: int) -> int:
    """The slots a one-token cached step at ``cache_index`` reads: the end of
    the ``decode_attend_bucket`` bucket that holds it (the JAX
    ``_bucketed_decode_attend``), or the whole buffer where ``bucket`` is 0 or
    covers it. Each bucket is one static shape."""
    if bucket <= 0 or buffer_len <= bucket:
        return buffer_len
    return min((cache_index // bucket + 1) * bucket, buffer_len)


def sliding_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """True where |q_pos - k_pos| <= window // 2."""
    return (q_pos[:, None] - k_pos[None, :]).abs() <= window // 2


def attend(q, k, v, mask: Optional[torch.Tensor], dtype: torch.dtype, bias: Optional[torch.Tensor] = None,
           scaled: bool = True) -> torch.Tensor:
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D), the JAX ``_attend``:
    logits in fp32, scaled by D^-0.5 where ``scaled``, plus ``bias`` (cast to
    fp32, broadcast over (B, H, Tq, Tk)), masked at finfo(fp32).min, softmax
    in fp32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    if scaled:
        logits = logits * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class TensorBlock(nn.Module):
    """A block whose projections may lie on the tensor axis: ``tp`` is its
    :class:`..parallel.tensor.TensorGroup` (None: whole, the module's own
    layers), set by :func:`..parallel.sharding.shard_params`. On a rank's
    heads (``tp.local``) a column projection gives the rank's columns and a
    row projection sums the ranks' partial products; otherwise each gives
    the whole output on every rank."""

    tp = None

    def _col(self, dense, x: torch.Tensor) -> torch.Tensor:
        tg = self.tp
        if tg is None:
            return dense(x)
        return column(dense, x, tg) if tg.local else whole_columns(dense, x, tg)

    def _row(self, dense, y: torch.Tensor) -> torch.Tensor:
        tg = self.tp
        if tg is None:
            return dense(y)
        return row(dense, y, tg) if tg.local else whole_rows(dense, y, tg)


class Attention(TensorBlock):
    """Self or cross attention with RoPE (under ``position_scheme="rope"``,
    moonshine's partial rotation where ``rope_partial_factor`` < 1) or a
    position bias (``t5_relpos``), causal and sliding-window masks, nGPT's
    normalised q and k, and a preallocated cache for step-by-step decode.
    On the tensor axis (:class:`TensorBlock`) it computes on
    :attr:`local_heads` heads: the rank's share where the axis divides the
    heads (nGPT's ``qk_scale`` and T5's position bias then read the rank's
    heads of their whole tables), all of them otherwise."""

    def __init__(self, cfg: TransformerConfig, num_heads: int, is_cross: bool = False,
                 is_causal: bool = False, is_decoder: bool = False, layer_idx: int = 0):
        super().__init__()
        self.cfg = cfg
        self.num_heads = num_heads
        self.is_cross = is_cross
        self.is_causal = is_causal
        self.is_decoder = is_decoder
        self.is_local = layer_idx % cfg.global_attn_every_n_layers != 0
        self.ngpt = cfg.norm_scheme == "ngpt"
        # attention calls that the flash kernel covers go to it; cleared, they
        # take the plain path (chip_smoke.py holds the two against each other)
        self.use_flash = cfg.use_flash_attention
        inner = num_heads * (cfg.head_dim_override or cfg.d_model // num_heads)
        bias, dt = cfg.attention_bias, cfg.dtype
        if self.ngpt:  # q and v carry biases, k none; wo normalises along its output axis
            self.wq = NormDense(cfg.d_model, inner, True, dt)
            self.wk = NormDense(cfg.d_model, inner, False, dt)
            self.wv = NormDense(cfg.d_model, inner, True, dt)
            self.wo = NormDense(inner, cfg.d_model, True, dt, norm_dim_in=False)
            self.qk_scale = HyperScale(inner, 1.0, cfg.d_model**-1)
            return
        dense = QDense if cfg.quantized_weights else Dense
        if is_cross:
            self.wq = dense(cfg.d_model, inner, bias, dt)
            self.wkv = dense(cfg.d_model, 2 * inner, bias, dt)
        else:
            self.wqkv = dense(cfg.d_model, 3 * inner, bias, dt)
        self.wo = dense(inner, cfg.d_model, bias, dt)

    @property
    def local_heads(self) -> int:
        """The heads this rank computes (and caches)."""
        tg = self.tp
        return self.num_heads // tg.size if tg is not None and tg.local else self.num_heads

    def _heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's heads of a whole per-head tensor along ``dim``."""
        tg = self.tp
        if tg is None or not tg.local:
            return t
        return t.narrow(dim, tg.rank * self.local_heads, self.local_heads)

    @property
    def rope_theta(self) -> float:
        return self.cfg.rope_local_theta if self.is_local else self.cfg.rope_global_theta

    @property
    def scaled(self) -> bool:
        """Whether the logits are scaled by D^-0.5: not in T5, nor in nGPT,
        whose q carries its own scale."""
        return self.cfg.attention_scale and not self.ngpt

    def kv(self, source: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The k and v heads (B, S, H, D) of ``source``, before any
        normalisation: the cross cache's contents."""
        b, s, _ = source.shape
        h = self.local_heads
        if self.ngpt:
            return self._col(self.wk, source).view(b, s, h, -1), self._col(self.wv, source).view(b, s, h, -1)
        kv = self._col(self.wkv, source).view(b, s, 2 * h, -1)
        return kv[:, :, :h], kv[:, :, h:]

    def _qk(self, q: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """nGPT: q and k l2-normalised per head in fp32 and scaled by the
        learned ``qk_scale``, q by sqrt(D) too, then cast to the compute
        dtype; q and k as they are otherwise."""
        if not self.ngpt:
            return q, k
        d = q.shape[-1]
        sqk = self._heads(self.qk_scale().view(self.num_heads, d), 0).view(1, 1, -1, d)
        dt = self.cfg.dtype
        return (sqk * l2norm(q.float()) * d**0.5).to(dt), (sqk * l2norm(k.float())).to(dt)

    def forward(
        self,
        x: torch.Tensor,
        kv_source: Optional[torch.Tensor] = None,
        positions: Optional[torch.Tensor] = None,
        attn_mask: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
        cache_index=None,
        limit: Optional[int] = None,
        pos_bias: Optional[torch.Tensor] = None,
    ):
        """Returns (out, cache). ``cache`` holds (B, max_len, H, D) k/v written
        in place at ``cache_index`` (int8 with (B, max_len, H) ``k_scale`` /
        ``v_scale`` under ``quantized_kv``): a Python int, or a 0-d long
        tensor on the device. Self attention then reads the first ``limit``
        slots, a static length past the last slot written (default: that
        slot, which needs an int index); masked slots add exactly 0. Cross
        attention reads its k/v from the cache when one is given.
        ``attn_mask`` is a (B, 1, 1, S) key mask; ``pos_bias`` a (B | 1, H,
        t, keys) position bias over the keys read (the first ``limit`` slots
        with a cache)."""
        cfg = self.cfg
        b, t, _ = x.shape
        h = self.local_heads
        scale = None if self.scaled else 1.0  # flash_attention's sm_scale
        if pos_bias is not None:
            pos_bias = self._heads(pos_bias, 1)

        if self.is_cross:
            q = self._col(self.wq, x).view(b, t, h, -1)
            k, v = _read_kv(cache, None, cfg.dtype) if cache is not None else self.kv(kv_source)
            q, k = self._qk(q, k)
            if cache is None and self.use_flash and _key_mask_only(attn_mask):
                out = flash_attention(q, k, v, _key_mask(attn_mask), sm_scale=scale)
            else:
                out = attend(q, k, v, attn_mask, cfg.dtype, scaled=self.scaled)
            return self._row(self.wo, out.reshape(b, t, -1)), cache

        if self.ngpt:
            q, (k, v) = self._col(self.wq, x).view(b, t, h, -1), self.kv(x)
        else:
            qkv = self._col(self.wqkv, x).view(b, t, 3 * h, -1)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        if cfg.position_scheme == "rope":
            theta = self.rope_theta
            if cfg.rope_type == "dynamic":
                seq_len = cache["k"].shape[1] if cache is not None else t
                max_pos = cfg.max_target_positions if self.is_decoder else cfg.max_source_positions
                factor = cfg.rope_decoder_scaling_factor if self.is_decoder else cfg.rope_encoder_scaling_factor
                theta = dynamic_ntk_theta(theta, cfg.head_dim, seq_len, max_pos, factor)
            if cfg.rope_partial_factor < 1.0:
                rotary_dim = int(cfg.head_dim * cfg.rope_partial_factor)
                q = apply_rope_interleaved_partial(q, positions, theta, rotary_dim)
                k = apply_rope_interleaved_partial(k, positions, theta, rotary_dim)
            else:
                q = apply_rope(q, positions, theta)
                k = apply_rope(k, positions, theta)

        if cache is not None:
            # keys past the last written slot are causally masked for every
            # query, so only a prefix of the buffer that holds them is read
            q_pos = cache_index + torch.arange(t, device=x.device)
            if limit is None:
                limit = cache_index + t
            for name, x_new in (("k", k), ("v", v)):
                if "k_scale" in cache:
                    x_new, kv_scale = quantize_kv(x_new)
                    cache[f"{name}_scale"].index_copy_(1, q_pos, kv_scale)
                cache[name].index_copy_(1, q_pos, x_new.to(cache[name].dtype))
            k, v = _read_kv(cache, limit, cfg.dtype)
            q, k = self._qk(q, k)  # the cache holds raw keys; an unwritten slot's 0 stays 0
            k_pos = torch.arange(limit, device=x.device)
            mask = k_pos[None, :] <= q_pos[:, None]
            if self.is_local:
                mask = mask & sliding_window_mask(q_pos, k_pos, cfg.local_attention)
            mask = mask[None, None]
            if attn_mask is not None:
                mask = mask & attn_mask[..., :limit]
            out = attend(q, k, v, mask, cfg.dtype, pos_bias, self.scaled)
        elif pos_bias is None and self.use_flash and _key_mask_only(attn_mask):
            q, k = self._qk(q, k)
            out = flash_attention(
                q, k, v, _key_mask(attn_mask),
                causal=self.is_causal,
                window=cfg.local_attention if self.is_local else 0,
                sm_scale=scale,
            )
        else:
            q, k = self._qk(q, k)
            pos = positions[0]
            mask = attn_mask
            if self.is_causal:
                causal = (pos[:, None] >= pos[None, :])[None, None]
                mask = causal if mask is None else mask & causal
            if self.is_local:
                band = sliding_window_mask(pos, pos, cfg.local_attention)[None, None]
                mask = band if mask is None else mask & band
            out = attend(q, k, v, mask, cfg.dtype, pos_bias, self.scaled)
        return self._row(self.wo, out.reshape(b, t, -1)), cache


def _key_mask_only(attn_mask: Optional[torch.Tensor]) -> bool:
    return attn_mask is None or (attn_mask.dim() == 4 and attn_mask.shape[1] == 1 and attn_mask.shape[2] == 1)


def _key_mask(attn_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return attn_mask[:, 0, 0, :] if attn_mask is not None else None


class FeedForward(TensorBlock):
    """The JAX ``FeedForward``: ``fc2(act(fc1(x)))``; under ``ffn_gated``
    (T5 v1.1) ``fc2(act(fc1(x)) * fc1_gate(x))``; in a decoder under
    ``decoder_ffn_gated_concat`` (moonshine) one ``fc1`` of twice the width
    split into (hidden, gate), ``fc2(act(gate) * hidden)``, plain ``Dense``
    layers even under int8; under nGPT two :class:`NormDense` without
    biases, ``fc2`` normalised along its output axis. On the tensor axis
    (:class:`TensorBlock`) a rank computes its share of the hidden width
    (moonshine's ``fc1`` held as [hidden | gate] of the rank's columns)."""

    def __init__(self, cfg: TransformerConfig, ffn_dim: int, is_decoder: bool = False):
        super().__init__()
        dense = QDense if cfg.quantized_weights else Dense
        self.act = ACTIVATIONS[(is_decoder and cfg.decoder_activation) or cfg.activation]
        self.gated_concat = is_decoder and cfg.decoder_ffn_gated_concat
        if self.gated_concat:
            self.fc1 = Dense(cfg.d_model, 2 * ffn_dim, cfg.mlp_bias, cfg.dtype)
            self.fc2 = Dense(ffn_dim, cfg.d_model, cfg.mlp_bias, cfg.dtype)
            return
        if cfg.norm_scheme == "ngpt":
            self.fc1 = NormDense(cfg.d_model, ffn_dim, False, cfg.dtype)
            self.fc2 = NormDense(ffn_dim, cfg.d_model, False, cfg.dtype, norm_dim_in=False)
            return
        self.fc1 = dense(cfg.d_model, ffn_dim, cfg.mlp_bias, cfg.dtype)
        if cfg.ffn_gated:
            self.fc1_gate = dense(cfg.d_model, ffn_dim, cfg.mlp_bias, cfg.dtype)
        self.fc2 = dense(ffn_dim, cfg.d_model, cfg.mlp_bias, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated_concat:
            hidden, gate = self._col(self.fc1, x).chunk(2, dim=-1)
            return self._row(self.fc2, self.act(gate) * hidden)
        h = self.act(self._col(self.fc1, x))
        if hasattr(self, "fc1_gate"):
            h = h * self._col(self.fc1_gate, x)
        return self._row(self.fc2, h)


class EncoderLayer(nn.Module):
    """Pre-norm residuals, or nGPT's slerps (``attn_residual``,
    ``ffn_residual``) with no norms."""

    def __init__(self, cfg: TransformerConfig, layer_idx: int):
        super().__init__()
        self.ngpt = cfg.norm_scheme == "ngpt"
        self.self_attn = Attention(cfg, cfg.encoder_heads, layer_idx=layer_idx)
        self.ffn = FeedForward(cfg, cfg.encoder_ffn)
        if self.ngpt:
            self.attn_residual = HyperResidual(cfg.d_model, cfg.ngpt_alpha_init)
            self.ffn_residual = HyperResidual(cfg.d_model, cfg.ngpt_alpha_init)
        else:
            self.self_attn_norm = norm_layer(cfg)
            self.final_norm = norm_layer(cfg)

    def forward(self, x, positions, attn_mask=None, pos_bias=None):
        if self.ngpt:
            x = self.attn_residual(x, self.self_attn(x, positions=positions, attn_mask=attn_mask)[0])
            return self.ffn_residual(x, self.ffn(x))
        x = x + self.self_attn(self.self_attn_norm(x), positions=positions, attn_mask=attn_mask,
                               pos_bias=pos_bias)[0]
        return x + self.ffn(self.final_norm(x))


class DecoderLayer(nn.Module):
    """Pre-norm residuals, or nGPT's slerps (``attn_residual``,
    ``cross_residual``, ``ffn_residual``) with no norms."""

    def __init__(self, cfg: TransformerConfig, layer_idx: int):
        super().__init__()
        self.ngpt = cfg.norm_scheme == "ngpt"
        self.self_attn = Attention(cfg, cfg.decoder_heads, is_causal=True, is_decoder=True, layer_idx=layer_idx)
        self.cross_attn = Attention(cfg, cfg.decoder_heads, is_cross=True)
        self.ffn = FeedForward(cfg, cfg.decoder_ffn, is_decoder=True)
        if self.ngpt:
            for name in ("attn_residual", "cross_residual", "ffn_residual"):
                setattr(self, name, HyperResidual(cfg.d_model, cfg.ngpt_alpha_init))
        else:
            self.self_attn_norm = norm_layer(cfg)
            self.cross_attn_norm = norm_layer(cfg)
            self.final_norm = norm_layer(cfg)

    def forward(self, x, encoder_states, positions, self_mask=None, cross_mask=None,
                cache: Optional[dict] = None, cache_index=None, limit: Optional[int] = None, pos_bias=None):
        ngpt = self.ngpt
        attn_out, _ = self.self_attn(
            x if ngpt else self.self_attn_norm(x), positions=positions, attn_mask=self_mask,
            cache=cache["self"] if cache is not None else None, cache_index=cache_index, limit=limit,
            pos_bias=pos_bias,
        )
        x = self.attn_residual(x, attn_out) if ngpt else x + attn_out
        cross_out, _ = self.cross_attn(
            x if ngpt else self.cross_attn_norm(x), kv_source=encoder_states, attn_mask=cross_mask,
            cache=cache["cross"] if cache is not None else None,
        )
        x = self.cross_residual(x, cross_out) if ngpt else x + cross_out
        if ngpt:
            return self.ffn_residual(x, self.ffn(x))
        return x + self.ffn(self.final_norm(x))


def moonshine_stem_length(samples: int) -> int:
    """Encoder positions of a window of raw samples through moonshine's stem
    (conv 127 / 64, conv 7 / 3, conv 3 / 2, all unpadded)."""
    for kernel, stride in ((127, 64), (7, 3), (3, 2)):
        samples = (samples - kernel) // stride + 1
    return samples


class Encoder(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        if cfg.conv_stem and cfg.stem_type == "moonshine":  # raw samples, one channel
            self.conv1 = Conv1d(1, cfg.d_model, 127, stride=64, bias=False, compute_dtype=dt)
            self.groupnorm = GroupNorm(cfg.d_model)
            self.conv2 = Conv1d(cfg.d_model, 2 * cfg.d_model, 7, stride=3, compute_dtype=dt)
            self.conv3 = Conv1d(2 * cfg.d_model, cfg.d_model, 3, stride=2, compute_dtype=dt)
        elif cfg.conv_stem:
            self.conv1 = Conv1d(cfg.num_mel_bins, cfg.d_model, 3, padding=1, compute_dtype=dt)
            self.conv2 = Conv1d(cfg.d_model, cfg.d_model, 3, stride=2, padding=1, compute_dtype=dt)
        if cfg.norm_scheme == "ngpt":  # learned rows, initialised to the sinusoids
            self.embed_positions = nn.Parameter(whisper_sinusoids(cfg.max_source_positions, cfg.d_model))
            self.alpha_positions = HyperScale(cfg.d_model, cfg.ngpt_alpha_pos_init, cfg.d_model**-0.5)
        if cfg.position_scheme == "t5_relpos":
            self.rel_bias = RelativePositionBias(cfg, cfg.encoder_heads, bidirectional=True)
        self.layers = nn.ModuleList(EncoderLayer(cfg, i) for i in range(cfg.encoder_layers))
        self.norm = norm_layer(cfg)

    def flax_init(self, leaf: str) -> torch.Tensor:
        """The value flax initialises ``leaf`` (``embed_positions``) to."""
        return whisper_sinusoids(self.cfg.max_source_positions, self.cfg.d_model, self.embed_positions.device)

    def forward(self, features: torch.Tensor, attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, num_mel_bins) -> (B, ceil(T / 2), D) through the whisper
        stem, (B, n, 1) raw samples -> (B, :func:`moonshine_stem_length`
        (n), D) through moonshine's, (B, T, D) from (B, T, D) features
        without one."""
        cfg = self.cfg
        x = features.to(cfg.dtype)
        if cfg.conv_stem and cfg.stem_type == "moonshine":
            x = self.groupnorm(torch.tanh(self.conv1(x.transpose(1, 2))))
            x = F.gelu(self.conv2(x))
            x = F.gelu(self.conv3(x)).transpose(1, 2)
        elif cfg.conv_stem:
            x = F.gelu(self.conv1(x.transpose(1, 2)))
            x = F.gelu(self.conv2(x)).transpose(1, 2)
        b, t, _ = x.shape
        if cfg.norm_scheme == "ngpt":  # slerp toward the learned position rows
            if t > cfg.max_source_positions:
                raise ValueError(f"{t} source positions: the model has {cfg.max_source_positions}")
            xf = l2norm(x.float())
            x = l2norm(xf + self.alpha_positions() * (self.embed_positions[:t].float() - xf)).to(cfg.dtype)
        elif cfg.position_scheme == "whisper_abs":
            if t > cfg.max_source_positions:
                raise ValueError(f"{t} source positions: the model has {cfg.max_source_positions}")
            x = x + whisper_sinusoids(t, cfg.d_model, x.device).to(cfg.dtype)
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        pos_bias = None
        if cfg.position_scheme == "t5_relpos":  # one table for the stack, shared by every layer
            pos_bias = self.rel_bias(positions[0], positions[0], cfg.dtype)
        for layer in self.layers:
            x = layer(x, positions, attn_mask, pos_bias)
        return self.norm(x)


class Decoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, embed_inputs: bool):
        super().__init__()
        self.cfg = cfg
        ngpt = cfg.norm_scheme == "ngpt"
        if embed_inputs or (cfg.tie_word_embeddings and not ngpt):
            self.embed_tokens = nn.Embedding(cfg.input_vocab_size or cfg.vocab_size, cfg.d_model)
        if cfg.position_scheme == "whisper_abs":
            self.embed_positions = nn.Embedding(cfg.max_target_positions, cfg.d_model)
        if ngpt:
            self.alpha_positions = HyperScale(cfg.d_model, cfg.ngpt_alpha_pos_init, cfg.d_model**-0.5)
        if cfg.position_scheme == "t5_relpos":
            self.rel_bias = RelativePositionBias(cfg, cfg.decoder_heads, bidirectional=False)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i) for i in range(cfg.decoder_layers))
        self.norm = norm_layer(cfg)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The token rows of ``input_ids``; l2-normalised under nGPT, whose
        rows live on the unit sphere."""
        e = self.embed_tokens(input_ids)
        return l2norm(e) if self.cfg.norm_scheme == "ngpt" else e

    def forward(self, inputs_embeds, encoder_states, positions=None, self_mask=None,
                cross_mask=None, cache: Optional[list] = None, cache_index=None, limit: Optional[int] = None,
                k_positions: Optional[torch.Tensor] = None):
        """``positions`` (B, t): each token's logical position, the RoPE
        position or the row of the learned position table (default: 0 ..
        t - 1). A table lookup past its last row fails (on a card, as a device
        assert), so the callers keep positions below ``max_target_positions``
        (:attr:`OsuTransformer.position_table`). Under ``scale_embedding``
        the input rows are first multiplied by sqrt(d_model). Under nGPT the
        token rows are slerped toward the table's rows, else the rows are
        added. Under
        ``t5_relpos`` the
        position bias is computed once for every layer, from ``positions``
        to ``k_positions`` (B, buffer slots), the logical position of each
        cache slot, over the slots the self-attention reads (``limit``);
        without ``k_positions`` from the first row's positions to the slot
        indices, as the JAX decoder does."""
        cfg = self.cfg
        x = inputs_embeds.to(cfg.dtype)
        if cfg.scale_embedding:
            x = x * math.sqrt(cfg.d_model)
        b, t, _ = x.shape
        if positions is None:
            if cfg.position_scheme == "whisper_abs" and t > cfg.max_target_positions:
                raise ValueError(f"{t} target positions: the model has {cfg.max_target_positions}")
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        if cfg.position_scheme == "whisper_abs":
            p = self.embed_positions(positions).to(cfg.dtype)
            if cfg.norm_scheme == "ngpt":
                xf = x.float()
                x = l2norm(xf + self.alpha_positions() * (p.float() - xf)).to(cfg.dtype)
            else:
                x = x + p
        pos_bias = None
        if cfg.position_scheme == "t5_relpos":
            if cache is not None and limit is None:
                limit = cache_index + t
            keys = t if cache is None else limit
            if k_positions is not None:
                pos_bias = self.rel_bias(positions, k_positions[:, :keys], cfg.dtype)
            else:
                pos_bias = self.rel_bias(positions[0], torch.arange(keys, device=x.device), cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, encoder_states, positions, self_mask, cross_mask,
                      cache[i] if cache is not None else None, cache_index, limit, pos_bias)
        return self.norm(x)


class OsuTransformer(nn.Module):
    """Encoder-decoder with LM head. ``forward`` is the teacher-forced path;
    ``init_cache`` / ``decode_step`` the cached autoregressive one.
    ``embed_inputs`` gives the decoder its own token table (the JAX decoder
    creates it on first use; a wrapper that embeds its own ids has none), and
    ``head`` the LM head (a wrapper that reads the hidden states, as the
    classifier does, has none)."""

    def __init__(self, cfg: TransformerConfig, embed_inputs: bool = True, head: bool = True):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, embed_inputs)
        if not head:
            return
        if cfg.norm_scheme == "ngpt":  # a normalised head and a learned logit scale
            self.proj_out = NormDense(cfg.d_model, cfg.vocab_size, False, cfg.dtype)
            self.logit_scale = HyperScale(cfg.vocab_size, 1.0, cfg.d_model**-0.5)
        elif not cfg.tie_word_embeddings:
            head = QDense if cfg.quantized_weights else Dense
            self.proj_out = head(cfg.d_model, cfg.vocab_size, False, cfg.dtype)

    @property
    def position_table(self) -> Optional[int]:
        """Rows of the learned decoder position table (``whisper_abs``), the
        logical positions a decode can reach; None where positions are
        unbounded (RoPE)."""
        return self.cfg.max_target_positions if self.cfg.position_scheme == "whisper_abs" else None

    def lm_head(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.norm_scheme == "ngpt":
            return self.proj_out(x) * self.logit_scale().to(self.cfg.dtype)
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
            decoder_inputs_embeds = self.decoder.embed(decoder_input_ids)
        self_mask = None
        if decoder_attention_mask is not None:
            self_mask = decoder_attention_mask[:, None, None, :].bool()
        return self.lm_head(self.decoder(decoder_inputs_embeds, encoder_states, self_mask=self_mask))

    def init_cache(self, batch: int, max_len: int, encoder_states: torch.Tensor) -> list:
        """Preallocated self-attention k/v and the cross k/v, computed once;
        int8 with fp32 scales under ``quantized_kv``."""
        cfg = self.cfg
        h, d = self.decoder.layers[0].self_attn.local_heads, cfg.head_dim
        dev = encoder_states.device
        if cfg.quantized_kv:
            parts = {"k": torch.int8, "k_scale": torch.float32, "v": torch.int8, "v_scale": torch.float32}
        else:
            parts = {"k": cfg.dtype, "v": cfg.dtype}
        return [{"self": {name: torch.zeros((batch, max_len, h) + (() if "scale" in name else (d,)), dtype=dt,
                                            device=dev) for name, dt in parts.items()},
                 "cross": cross}
                for cross in self.cross_cache(encoder_states)]

    def cross_cache(self, encoder_states: torch.Tensor) -> list:
        """Each decoder layer's cross-attention k/v of ``encoder_states``, in
        the cache's format."""
        cfg = self.cfg
        out = []
        for layer in self.decoder.layers:
            k, v = layer.cross_attn.kv(encoder_states)
            if cfg.quantized_kv:
                (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
                out.append({"k": kq, "k_scale": ks, "v": vq, "v_scale": vs})
            else:
                out.append({"k": k.to(cfg.dtype), "v": v.to(cfg.dtype)})
        return out

    def decode_step(self, input_embeds, cache: list, cache_index, self_mask=None,
                    cross_mask=None, positions=None, limit: Optional[int] = None,
                    k_positions: Optional[torch.Tensor] = None):
        """One step (or a chunk) of cached decode: ``input_embeds`` (B, t, D)
        are written at cache slots ``cache_index .. cache_index + t``
        (``cache_index`` a Python int, or a 0-d long tensor on the device);
        self attention reads the first ``limit`` slots (:class:`Attention`);
        ``positions`` (B, t) are the logical positions (default: the slots)
        and ``k_positions`` (B, buffer slots) those of each cache slot, which
        the ``t5_relpos`` bias reads (:class:`Decoder`). Returns (logits,
        cache)."""
        b, t, _ = input_embeds.shape
        if positions is None:
            positions = (cache_index + torch.arange(t, device=input_embeds.device))[None].expand(b, t)
        x = self.decoder(input_embeds, None, positions=positions, self_mask=self_mask,
                         cross_mask=cross_mask, cache=cache, cache_index=cache_index, limit=limit,
                         k_positions=k_positions)
        return self.lm_head(x), cache
