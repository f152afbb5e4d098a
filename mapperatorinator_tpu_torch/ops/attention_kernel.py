"""Flash attention: the CUDA kernels, forward and backward, and their plain
PyTorch versions.

Replaces ``mapperatorinator_tpu/ops/attention_kernel.py``: the forward
``_attention_kernel`` (via ``_flash_forward``, behind ``flash_attention``)
and the backward ``_attention_bwd_kernel`` (via ``_bwd_call`` /
``_flash_backward``, which the JAX ``custom_vjp`` runs). Both kernels live in
``csrc/flash_attention.cu``, whose header says what bounds each on the H100.

:func:`flash_attention` runs the plain version for a tensor on the CPU, where
ordinary autograd differentiates it, and the kernels for a tensor on a CUDA
device: :class:`FlashAttentionFunction` when a gradient is wanted (the
forward kernel also writes the row log-sum-exp, and the backward kernel
recomputes the probabilities from it), the forward kernel alone otherwise. It
never falls back from one to the other.

The gradient is the exact one of the masked softmax: a masked logit gets
none. The Pallas backward differs from it in one place only, a query row
whose keys are all masked, where it gives dq and dk a nonzero term.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = float(torch.finfo(torch.float32).min)

_FWD_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 10
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 13
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


def _structural_mask(t: int, s: int, kv_mask, causal: bool, window: int, device) -> torch.Tensor:
    """(B or 1, 1, T, S) bool, True = attend."""
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window:
        mask = mask & ((q_pos - k_pos).abs() <= window // 2)
    mask = mask[None, None]
    if kv_mask is not None:
        mask = mask & kv_mask.bool()[:, None, None, :]
    return mask


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """What the forward kernel computes, in plain PyTorch. q: (B, T, H, D);
    k, v: (B, S, H, D); kv_mask: (B, S) bool, True = attend. Logits, softmax
    and the weighted sum in fp32; returns q's dtype."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(_structural_mask(t, s, kv_mask, causal, window, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def attention_backward_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor],
    do: torch.Tensor,
    *,
    causal: bool = False,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the backward kernel computes, in plain PyTorch: the exact
    gradient of :func:`attention_plain` (masked logits get none), in fp32,
    returned as (dq, dk, dv) in the dtypes of q, k, v."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    mask = _structural_mask(t, s, kv_mask, causal, window, q.device)
    logits = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = torch.where(mask, probs * (dp - (probs * dp).sum(-1, keepdim=True)), 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", probs, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, kv_mask, what: str) -> Optional[torch.Tensor]:
    """Raise on what the kernels do not take; the key mask as contiguous bool."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k, v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: fp32 or bf16 operands of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, s, h, d) or v.shape != (b, s, h, d):
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d % 8 or d > 128 or t == 0 or s == 0:
        raise ValueError(f"{what}: head dim {d} (multiple of 8, at most 128), T {t}, S {s}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError(f"{what}: operands need a unit stride along the head dim")
    if kv_mask is not None:
        if kv_mask.shape != (b, s) or kv_mask.device != q.device:
            raise ValueError(f"{what}: kv_mask must be ({b}, {s}) on {q.device}")
        kv_mask = kv_mask.to(torch.bool).contiguous()
    return kv_mask


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_fwd(q, k, v, kv_mask, causal: bool, window: int, scale: float,
                        with_lse: bool = False) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel (checked operands, a contiguous bool mask or
    None). Returns (out, lse): out (B, T, H, D) in q's dtype, lse (B, H, T)
    fp32 when ``with_lse``, else None."""
    b, t, h, d = q.shape
    s = k.shape[1]
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v),
        s if kv_mask is not None else 0,
        int(causal), int(window), float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, causal: bool, window: int,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on checked operands. ``out`` and ``lse``
    come from :func:`flash_attention_fwd` on the same inputs; ``do`` is the
    gradient of ``out``. Returns (dq, dk, dv) in the operands' dtype; dq is
    summed in an fp32 buffer with atomics, so its last bits vary from run to
    run."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if do.shape != out.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention_bwd: dO {tuple(do.shape)} {do.dtype} for out {tuple(out.shape)} {q.dtype}")
    if do.stride(3) != 1:
        do = do.contiguous()
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None,
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v), *_strides(do),
        s if kv_mask is not None else 0,
        int(causal), int(window), float(scale), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq.to(q.dtype), dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the CUDA backward kernel
    (the JAX ``custom_vjp`` around ``_flash_forward`` / ``_flash_backward``).
    Saves q, k, v, the output and its row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal: bool, window: int, scale: float):
        out, lse = flash_attention_fwd(q, k, v, kv_mask, causal, window, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, out, lse, do, ctx.causal, ctx.window, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Same contract as :func:`attention_plain`, and differentiable. On a
    CUDA tensor: the kernels, which take fp32 or bf16 with D a multiple of 8
    up to 128, each (B, T, H, D) operand with a unit stride along D; anything
    else raises. ``flash_attention.launches`` counts forward launches and
    ``flash_attention_bwd.launches`` backward ones."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask, causal=causal, window=window, sm_scale=sm_scale)
    kv_mask = _check(q, k, v, kv_mask, "flash_attention")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, kv_mask, bool(causal), int(window), float(scale))
    return flash_attention_fwd(q, k, v, kv_mask, causal, window, scale)[0]


flash_attention.launches = 0
