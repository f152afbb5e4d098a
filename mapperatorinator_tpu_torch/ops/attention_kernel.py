"""Flash attention: the CUDA kernels, forward and backward, and their plain
PyTorch versions.

Replaces ``mapperatorinator_tpu/ops/attention_kernel.py``: the forward
``_attention_kernel`` (via ``_flash_forward``, behind ``flash_attention``)
and the backward ``_attention_bwd_kernel`` (via ``_bwd_call`` /
``_flash_backward``, which the JAX ``custom_vjp`` runs). Each has two CUDA
kernels, and :func:`attention_route` picks one by dtype and head dim: the
fp32 kernels of ``csrc/flash_attention.cu`` (split-TF32 products on the
tensor cores, for fp32 at any head dim up to 128) and the bf16 kernels of
``csrc/flash_attention_sm90.cu`` (wgmma, for bf16 with D 64, v32's head
dim); bf16 at another head dim raises. Each source's header says what bounds
its kernels on the H100. The ``*_fp32_tc`` and ``*_bf16_tc`` plain versions
round where the kernels of each route round; the tests and
``chip_smoke.py`` hold the kernels against them and against the fp32 plain
versions.

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

# both routes' forward kernels take these; the bf16 backward takes one more
# scratch pointer (the live keys' sum) than the fp32 one
_FWD_ARGTYPES = tuple(
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 10
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = tuple(
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 5
    + [ctypes.c_longlong] * 13
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)
_SM90_BWD_ARGTYPES = (ctypes.c_void_p,) + _BWD_ARGTYPES


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


def attention_plain_bf16_tc(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """What the tensor-core forward kernel computes, rounding where it
    rounds: fp32 logits and softmax from the bf16 inputs, the probabilities
    rounded to bf16 before P·V (as the model's own bf16 ``_attend`` rounds
    them), the sum in fp32; returns q's dtype."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(_structural_mask(t, s, kv_mask, causal, window, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def attention_backward_plain_bf16_tc(
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
    """What the tensor-core backward kernel computes, rounding where it
    rounds: P, dP and dS = P (dP - delta) in fp32, with delta = rowsum(dO O)
    from the forward's output in q's dtype; P rounded to bf16 before dV =
    P^T dO, dS rounded to bf16 before dK = dS^T Q and dQ = dS (K - k_mean),
    with k_mean the mean of each (batch, head)'s live keys and K - k_mean
    rounded to bf16 (each row of the exact dS sums to 0, so the centring
    changes nothing but the rounding); sums in fp32. The exact gradient
    otherwise (masked logits get none), returned as (dq, dk, dv) in the
    dtypes of q, k, v."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    mask = _structural_mask(t, s, kv_mask, causal, window, q.device)
    logits = torch.where(mask, torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = attention_plain_bf16_tc(q, k, v, kv_mask, causal=causal, window=window, sm_scale=scale)
    delta = (gf * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = torch.where(mask, probs * (dp - delta), 0.0).to(torch.bfloat16).float()
    live = kv_mask.bool() if kv_mask is not None else torch.ones(k.shape[:2], dtype=torch.bool, device=k.device)
    live = live.float()[:, :, None, None]
    k_mean = (kf * live).sum(1, keepdim=True) / live.sum(1, keepdim=True).clamp(min=1.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, (kf - k_mean).to(torch.bfloat16).float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", probs.to(torch.bfloat16).float(), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) fp32 tensors with ``hi = tf32(x)`` and ``lo = tf32(x - hi)``,
    each rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``),
    as the fp32 kernels split every operand."""

    def tf32(y: torch.Tensor) -> torch.Tensor:
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = tf32(x.float())
    return hi, tf32(x.float() - hi)


def _einsum_3tf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as three TF32 products of the split operands:
    the small ones hi·lo' + lo·hi' and the big one hi·hi' summed apart, then
    added, all in fp32."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)) + torch.einsum(eq, ah, bh)


def attention_plain_fp32_tc(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    window: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """What the fp32 forward kernel computes, rounding where it rounds: the
    logits q·kᵀ and P·V each as three TF32 products of the split operands
    (:func:`tf32_split`), the masks, softmax and sums in fp32."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    logits = _einsum_3tf32("bqhd,bkhd->bhqk", q, k) * scale
    logits = torch.where(_structural_mask(t, s, kv_mask, causal, window, q.device), logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return _einsum_3tf32("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def attention_backward_plain_fp32_tc(
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
    """What the fp32 backward kernel computes, rounding where it rounds: the
    five products (logits, dP, dV, dK, dQ) each as three TF32 products of
    the split operands, P, dS = P (dP - delta) and every sum in fp32, with
    delta = rowsum(dO O) from :func:`attention_plain_fp32_tc`'s output. The
    exact gradient otherwise (masked logits get none)."""
    t, s, d = q.shape[1], k.shape[1], q.shape[-1]
    scale = d**-0.5 if sm_scale is None else sm_scale
    mask = _structural_mask(t, s, kv_mask, causal, window, q.device)
    logits = torch.where(mask, _einsum_3tf32("bqhd,bkhd->bhqk", q, k) * scale, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = attention_plain_fp32_tc(q, k, v, kv_mask, causal=causal, window=window, sm_scale=scale)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, T, 1)
    dp = _einsum_3tf32("bqhd,bkhd->bhqk", do, v)
    ds = torch.where(mask, probs * (dp - delta), 0.0)
    dq = _einsum_3tf32("bhqk,bkhd->bqhd", ds, k) * scale
    dk = _einsum_3tf32("bhqk,bqhd->bkhd", ds, q) * scale
    dv = _einsum_3tf32("bhqk,bqhd->bkhd", probs, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


SM90_HEAD_DIMS = (64,)


def attention_route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel pair that takes an attention call on the card: ``"fp32"``
    (``csrc/flash_attention.cu``) for fp32 at any head dim the kernels take,
    every product as three TF32 tensor-core products of split operands,
    which hold the fp32 bar of 2e-5 where one TF32 or bf16 product does not;
    ``"sm90"`` (``csrc/flash_attention_sm90.cu``, wgmma on the tensor cores,
    bf16 operands, fp32 sums) for bf16 with a head dim in
    :data:`SM90_HEAD_DIMS`. Anything else raises: no ported model runs bf16
    at another head dim. The route is decided here alone; a kernel that
    fails raises, and no call moves to the other route or to the plain
    version."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    raise ValueError(f"flash_attention: no kernel takes {dtype} with head dim {head_dim} (fp32, or bf16 with head "
                     f"dim in {SM90_HEAD_DIMS})")


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


def _check_aligned(what: str, **xs: torch.Tensor) -> None:
    """The tensor-core kernels load rows 16 bytes a thread (cp.async): every
    base address and every stride but the head dim's must be a multiple of
    16 bytes."""
    for name, x in xs.items():
        if x.data_ptr() % 16 or any(x.stride(i) * x.element_size() % 16 for i in range(3)):
            raise ValueError(f"{what}: {name} needs a 16-byte aligned base and 16-byte multiple strides, got "
                             f"address {x.data_ptr()} and strides {x.stride()} of {x.element_size()}-byte elements")


def _strides(x: torch.Tensor) -> tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def flash_attention_fwd(q, k, v, kv_mask, causal: bool, window: int, scale: float,
                        with_lse: bool = False) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the forward kernel of the route :func:`attention_route` picks
    (checked operands, a contiguous bool mask or None). Returns (out, lse):
    out (B, T, H, D) in q's dtype, lse (B, H, T) fp32 when ``with_lse``, else
    None."""
    if attention_route(q.dtype, q.shape[-1]) == "sm90":
        return flash_fwd_sm90(q, k, v, kv_mask, causal, window, scale, with_lse)
    return flash_fwd_fp32(q, k, v, kv_mask, causal, window, scale, with_lse)


def flash_attention_bwd(q, k, v, kv_mask, out, lse, do, causal: bool, window: int,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel of the route :func:`attention_route`
    picks, on checked operands. ``out`` and ``lse`` come from
    :func:`flash_attention_fwd` on the same inputs (one route writes what the
    same route reads); ``do`` is the gradient of ``out``. Returns (dq, dk,
    dv) in the operands' dtype; dq is summed in an fp32 buffer with atomics,
    so its last bits vary from run to run."""
    if do.shape != out.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"flash_attention_bwd: dO {tuple(do.shape)} {do.dtype} for out {tuple(out.shape)} {q.dtype}")
    if do.stride(3) != 1:
        do = do.contiguous()
    if attention_route(q.dtype, q.shape[-1]) == "sm90":
        return flash_bwd_sm90(q, k, v, kv_mask, out, lse, do, causal, window, scale)
    return flash_bwd_fp32(q, k, v, kv_mask, out, lse, do, causal, window, scale)


def flash_fwd_fp32(q, k, v, kv_mask, causal, window, scale, with_lse):
    """The fp32 forward kernel (``csrc/flash_attention.cu``, split-TF32).
    The key mask goes in as int32 flags."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if q.dtype != torch.float32:
        raise ValueError(f"flash_fwd_fp32: fp32 operands, got {q.dtype}")
    _check_aligned("flash_fwd_fp32", q=q, k=k, v=v)
    flags = kv_mask.to(torch.int32) if kv_mask is not None else None
    fn = _build.function("flash_attention", "flash_attention_fwd", _FWD_ARGTYPES)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), flags.data_ptr() if flags is not None else None,
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v), s,
        int(causal), int(window), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(fn.lib, err, "flash_fwd_fp32")
    flash_fwd_fp32.launches += 1
    return out, lse


def flash_bwd_fp32(q, k, v, kv_mask, out, lse, do, causal, window, scale):
    """The fp32 backward kernel (``csrc/flash_attention.cu``, split-TF32),
    after its delta kernel; ``out`` and ``lse`` from :func:`flash_fwd_fp32`."""
    b, t, h, d = q.shape
    s = k.shape[1]
    if q.dtype != torch.float32:
        raise ValueError(f"flash_bwd_fp32: fp32 operands, got {q.dtype}")
    _check_aligned("flash_bwd_fp32", q=q, k=k, v=v, do=do)
    if not out.is_contiguous():
        raise ValueError("flash_bwd_fp32: out must be the forward's contiguous output")
    flags = kv_mask.to(torch.int32) if kv_mask is not None else None
    fn = _build.function("flash_attention", "flash_attention_bwd", _BWD_ARGTYPES)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    dq = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), flags.data_ptr() if flags is not None else None,
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v), *_strides(do), s,
        int(causal), int(window), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(fn.lib, err, "flash_bwd_fp32")
    flash_bwd_fp32.launches += 1
    return dq, dk, dv


def flash_fwd_sm90(q, k, v, kv_mask, causal, window, scale, with_lse):
    """The tensor-core forward kernel (``csrc/flash_attention_sm90.cu``),
    bf16 with D 64. The key mask goes in as int32 flags, which the kernel
    loads 4 bytes a key beside each k/v tile."""
    b, t, h, d = q.shape
    s = k.shape[1]
    _check_aligned("flash_fwd_sm90", q=q, k=k, v=v)
    flags = kv_mask.to(torch.int32) if kv_mask is not None else None
    fn = _build.function("flash_attention_sm90", "flash_attention_sm90_fwd", _FWD_ARGTYPES)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), flags.data_ptr() if flags is not None else None,
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v), s,
        int(causal), int(window), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(fn.lib, err, "flash_fwd_sm90")
    flash_fwd_sm90.launches += 1
    return out, lse


def flash_bwd_sm90(q, k, v, kv_mask, out, lse, do, causal, window, scale):
    """The tensor-core backward kernel (``csrc/flash_attention_sm90.cu``),
    bf16 with D 64, after its per-row kernel (delta and the keys' sum);
    ``out`` and ``lse`` from :func:`flash_fwd_sm90`."""
    b, t, h, d = q.shape
    s = k.shape[1]
    _check_aligned("flash_bwd_sm90", q=q, k=k, v=v, do=do, out=out)
    if not out.is_contiguous():
        raise ValueError("flash_bwd_sm90: out must be the forward's contiguous output")
    flags = kv_mask.to(torch.int32) if kv_mask is not None else None
    fn = _build.function("flash_attention_sm90", "flash_attention_sm90_bwd", _SM90_BWD_ARGTYPES)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    k_sums = torch.zeros((b, h, d + 1), dtype=torch.float32, device=q.device)  # the live keys' sum and count
    dq = torch.zeros((b, t, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), flags.data_ptr() if flags is not None else None,
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(), k_sums.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        b, t, s, h, d, *_strides(q), *_strides(k), *_strides(v), *_strides(do), s,
        int(causal), int(window), float(scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(fn.lib, err, "flash_bwd_sm90")
    flash_bwd_sm90.launches += 1
    return dq.to(q.dtype), dk, dv


flash_fwd_fp32.launches = flash_bwd_fp32.launches = 0
flash_fwd_sm90.launches = flash_bwd_sm90.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the CUDA backward kernel of
    the same route (the JAX ``custom_vjp`` around ``_flash_forward`` /
    ``_flash_backward``). Saves q, k, v, the output and its row
    log-sum-exp."""

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
    CUDA tensor: the kernels of the route :func:`attention_route` picks,
    which take fp32 with D a multiple of 8 up to 128, or bf16 with D 64, each
    (B, T, H, D) operand with a unit stride along D and 16-byte aligned
    rows; anything else raises. Each kernel counts its launches:
    ``flash_fwd_fp32.launches``, ``flash_bwd_fp32.launches``,
    ``flash_fwd_sm90.launches``, ``flash_bwd_sm90.launches``."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask, causal=causal, window=window, sm_scale=sm_scale)
    kv_mask = _check(q, k, v, kv_mask, "flash_attention")
    scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, kv_mask, bool(causal), int(window), float(scale))
    return flash_attention_fwd(q, k, v, kv_mask, causal, window, scale)[0]
