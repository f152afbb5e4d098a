"""The DiT coordinate-refinement model in PyTorch: a port of the JAX
``models/dit.py`` (reference: ``osu_diffusion/utils/models.py:20-405``,
``positional_embedding.py:29-78``).

A 1-D DiT over hit-object coordinate sequences: sin/cos position-frequency
embedding of (x, y) * 512 concatenated with a 272-wide per-object context,
adaLN-Zero blocks, timestep and class-vector embedders, learned-sigma
output, and the dual-half CFG forward. Sequences are time-major (N, T, C).

Attention. The JAX block computes it in plain XLA under a dense boolean mask,
which the diffusion pipeline builds as ``banded_attention_mask(bucket, band)
& key_valid``: |q - k| <= band and the key is not bucket padding. Here the
block takes that mask as ``(band, key_valid)`` and hands it to
:func:`..ops.attention_kernel.flash_attention`, with ``window = 2 * band``
(the kernels' band is |q - k| <= window // 2) and ``key_valid`` as the key
mask: on a CUDA tensor kernel B's fp32 route (``csrc/flash_attention.cu``),
on the CPU its plain version. A query row whose keys are all masked (bucket
padding far from every real key) averages v over all keys, as the reference
does; the pipeline slices such rows away. A call the kernel refuses raises.
``DiTBlock.use_flash = False`` sends a block to the plain version on any
device, which ``chip_smoke.py`` uses to hold the kernel path against it.

The Dense layers are ``nn.Linear`` in fp32 (TF32 off, as the port's
inference sets it): the DiT bundle's ``dit_config.json`` carries no dtype,
and the JAX loader builds the model in fp32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_kernel import attention_plain, flash_attention

DIT_SIZES = {
    "DiT-XL": dict(depth=28, hidden_size=1152, num_heads=16),
    "DiT-L": dict(depth=24, hidden_size=1024, num_heads=16),
    "DiT-B": dict(depth=12, hidden_size=768, num_heads=12),
    "DiT-S": dict(depth=12, hidden_size=384, num_heads=6),
    "DiT-T": dict(depth=1, hidden_size=32, num_heads=2),  # test/smoke size
}


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 2
    context_size: int = 272
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    class_size: int = 256
    learn_sigma: bool = True

    @classmethod
    def from_name(cls, name: str, **kw) -> "DiTConfig":
        return cls(**{**DIT_SIZES[name], **kw})

    @property
    def out_channels(self) -> int:
        return self.in_channels * 2 if self.learn_sigma else self.in_channels


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """GLIDE-style sinusoidal embedding, [cos | sin] halves, fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def position_sequence_embedding(x: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """(N, T, D) positions -> (N, T, D * dim) sinusoid features."""
    n, t, d = x.shape
    return timestep_embedding(x.reshape(-1), dim, max_period).reshape(n, t, d * dim)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``LayerNorm(use_bias=False, use_scale=False, epsilon=1e-6)``."""
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.fc1 = nn.Linear(frequency_embedding_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(timestep_embedding(t, self.frequency_embedding_size))))


class LabelEmbedder(nn.Module):
    def __init__(self, class_size: int, hidden_size: int):
        super().__init__()
        self.fc1 = nn.Linear(class_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(labels)))


class FirstLayer(nn.Module):
    def __init__(self, in_channels: int, context_size: int, hidden_size: int, frequency_embedding_size: int = 128):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.proj = nn.Linear(in_channels * frequency_embedding_size + context_size, hidden_size)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """x: (N, T, C) coords in [-1, 1]; c: (N, T, E) context."""
        x_freq = position_sequence_embedding(x * 512, self.frequency_embedding_size)
        return self.proj(torch.cat([x_freq, c], dim=-1))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.use_flash = True
        self.adaln = nn.Linear(d, 6 * d)
        self.qkv = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.mlp_fc1 = nn.Linear(d, int(d * cfg.mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(d * cfg.mlp_ratio), d)

    def forward(self, x, cond, band: Optional[int] = None, key_valid: Optional[torch.Tensor] = None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.adaln(F.silu(cond)).chunk(6, dim=-1)
        h = modulate(_layer_norm(x), shift_msa, scale_msa)
        x = x + gate_msa[:, None] * self._attention(h, band, key_valid)
        h = modulate(_layer_norm(x), shift_mlp, scale_mlp)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + gate_mlp[:, None] * h

    def _attention(self, x, band, key_valid):
        b, t, d = x.shape
        h = self.num_heads
        qkv = self.qkv(x).view(b, t, 3, h, d // h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attend = flash_attention if self.use_flash else attention_plain
        out = attend(q, k, v, key_valid, window=0 if band is None else 2 * band)
        return self.out_proj(out.reshape(b, t, d))


class FinalLayer(nn.Module):
    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.adaln = nn.Linear(cfg.hidden_size, 2 * cfg.hidden_size)
        self.proj = nn.Linear(cfg.hidden_size, cfg.out_channels)

    def forward(self, x, cond):
        shift, scale = self.adaln(F.silu(cond)).chunk(2, dim=-1)
        return self.proj(modulate(_layer_norm(x), shift, scale))


class DiT(nn.Module):
    """``forward(x, t, c, y, band, key_valid)``: x (N, T, C) coordinates, t
    (N,) timesteps, c (N, T, E) context, y (N, class_size) class vectors;
    attention over |q - k| <= ``band`` (all pairs when None) and the keys
    where ``key_valid`` ((N, T) or (T,) bool, all when None) holds."""

    def __init__(self, cfg: DiTConfig):
        super().__init__()
        self.cfg = cfg
        self.context_embedder = FirstLayer(cfg.in_channels, cfg.context_size, cfg.hidden_size)
        self.t_embedder = TimestepEmbedder(cfg.hidden_size)
        self.y_embedder = LabelEmbedder(cfg.class_size, cfg.hidden_size)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)

    def forward(self, x, t, c, y, band: Optional[int] = None, key_valid: Optional[torch.Tensor] = None):
        if band is not None and band < 1:
            raise ValueError(f"band {band}: the kernels' window 2 * band must be at least 2")
        if key_valid is not None:
            key_valid = key_valid.to(device=x.device, dtype=torch.bool).expand(x.shape[0], x.shape[1]).contiguous()
        h = self.context_embedder(x, c)
        cond = self.t_embedder(t) + self.y_embedder(y)
        for block in self.blocks:
            h = block(h, cond, band, key_valid)
        return self.final_layer(h, cond)  # (N, T, out_channels)

    def forward_with_cfg(self, x, t, c, y, cfg_scale: float, band: Optional[int] = None,
                         key_valid: Optional[torch.Tensor] = None):
        """Dual-half CFG (reference: models.py:301-317): the rows are [cond;
        uncond], both run on the first half's x, and both halves get the
        mixed eps."""
        c_in = self.cfg.in_channels
        half = x[: x.shape[0] // 2]
        out = self(torch.cat([half, half]), t, c, y, band, key_valid)
        eps, rest = out[..., :c_in], out[..., c_in:]
        cond_eps, uncond_eps = eps.chunk(2)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=-1)
