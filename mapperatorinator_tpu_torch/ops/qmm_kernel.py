"""Int8 weight-only matrix product: the CUDA kernel and its plain PyTorch
version.

Replaces ``mapperatorinator_tpu/ops/qmm_kernel.py`` (``_qmm_kernel`` via
``qmm``): ``(x @ upcast(wq)) * scale`` with an int8 (K, N) weight, a
per-column fp32 scale, fp32 accumulation and the output in x's dtype. The
kernel (``csrc/qmm.cu``) reads only int8 weight bytes from device memory; its
header says what bounds it on the H100. It has two paths: a GEMV for up to
``GEMV_ROWS`` rows (a decode step), and above that a GEMM on the tensor cores,
which takes an fp32 x as two TF32 products (:func:`qmm_plain_tf32x2` rounds
as it does). :func:`qmm` runs the plain version for a tensor on the CPU and
the kernel for a tensor on a CUDA device; it never falls back from one to the
other.

:func:`qmm_supported` is the JAX package's gate, unchanged: it decides which
of two roundings a ``QDense`` layer gets (this product, or the plain
expression in the compute dtype), so a gate derived for the H100 would change
bf16 results.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention_kernel import tf32_split

_LANE = 128  # the TPU lane width the JAX gate tiles N by
GEMV_ROWS = 4  # the kernel's GEMV path takes up to this many rows, the tensor-core path more

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _pick_block_n(n: int, cap: int = 512) -> int:
    bn = min(cap, n)
    while n % bn:
        bn -= _LANE
    return bn


def qmm_supported(k: int, n: int, rows: int = 1) -> bool:
    """Shapes the fused kernel handles: lane-tileable N, an int8 weight block
    that fits VMEM comfortably, and a small row count (the x/out blocks scale
    with the flattened batch — decode steps have 1..tens of rows; prefill and
    encoder calls with hundreds+ rows fall back to the XLA expression, where
    the one-off dequant is amortized over the large matmul anyway)."""
    if n % _LANE:
        return False
    bn = _pick_block_n(n)
    if k * bn > 2**21:  # <=2 MB int8 weight block
        return False
    # x (rows,K) bf16 + out (rows,bn) fp32 per grid step, <=2 MB each
    return rows * k * 2 <= 2**21 and rows * bn * 4 <= 2**21


def qmm_plain(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """What the kernel computes, in plain PyTorch: x (rows, K), wq (K, N)
    int8, scale (N,) fp32 -> (rows, N) in x's dtype, summed and scaled in fp32."""
    return ((x.float() @ wq.float()) * scale.float()).to(x.dtype)


def qmm_plain_tf32x2(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """What the kernel's tensor-core path computes, rounding where it rounds:
    x split into ``hi + lo`` (:func:`tf32_split`), two fp32 products with the
    int8 weight (exact in TF32 and in bf16, so it needs no split), summed,
    scaled and rounded to x's dtype. A bf16 x has ``lo = 0``: this is then
    :func:`qmm_plain`."""
    hi, lo = tf32_split(x)
    w = wq.float()
    return (((hi @ w) + (lo @ w)) * scale.float()).to(x.dtype)


def qmm_kernel(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch kernel D. x: contiguous fp32 or bf16 (rows, K) on a CUDA
    device; wq: contiguous int8 (K, N), N a multiple of 16, 16-byte aligned;
    scale: contiguous fp32 (N,); anything else raises."""
    if not x.is_cuda or wq.device != x.device or scale.device != x.device:
        raise ValueError(f"qmm: x, wq, scale must share one CUDA device, got {x.device}, {wq.device}, "
                         f"{scale.device}")
    if x.dim() != 2 or x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"qmm: x must be a contiguous fp32 or bf16 (rows, K) matrix, got {x.dtype} "
                         f"{tuple(x.shape)} strides {x.stride()}")
    rows, k = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k or not wq.is_contiguous():
        raise ValueError(f"qmm: wq must be a contiguous int8 ({k}, N) matrix, got {wq.dtype} {tuple(wq.shape)}")
    n = wq.shape[1]
    if scale.dtype != torch.float32 or scale.shape != (n,) or not scale.is_contiguous():
        raise ValueError(f"qmm: scale must be a contiguous fp32 ({n},) vector, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if rows == 0 or k == 0 or n % 16 or wq.data_ptr() % 16:
        raise ValueError(f"qmm: rows {rows} and K {k} must be positive, N {n} a multiple of 16 and the "
                         "weight 16-byte aligned")
    lib = _build.load("qmm")
    fn = lib.qmm_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n,
             int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "qmm")
    if rows <= GEMV_ROWS:
        qmm.launches_gemv += 1
    else:
        qmm.launches_tc += 1
    qmm.launches += 1
    return out


def _forward(x, wq, scale) -> torch.Tensor:
    if x.device.type == "cpu":
        return qmm_plain(x, wq, scale)
    return qmm_kernel(x, wq, scale)


class QMMFunction(torch.autograd.Function):
    """The product, differentiated in x only (the JAX ``custom_vjp``): the int8
    weight and its scale are storage, not parameters. The backward is the
    plain matrix product ``(dy * scale) @ dequant(wq).T`` of the JAX
    ``_qmm_bwd``, with ``dy * scale`` rounded to x's dtype first."""

    @staticmethod
    def forward(ctx, x, wq, scale):
        ctx.save_for_backward(wq, scale)
        ctx.dtype = x.dtype
        return _forward(x, wq, scale)

    @staticmethod
    def backward(ctx, dy):
        wq, scale = ctx.saved_tensors
        dys = (dy.float() * scale).to(ctx.dtype)
        return (dys.float() @ wq.float().T).to(ctx.dtype), None, None


def qmm(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ wq) * scale``, differentiable in x. On a CUDA tensor: kernel D
    (:func:`qmm_kernel` says what it takes). ``qmm.launches`` counts kernel
    launches, ``qmm.launches_gemv`` and ``qmm.launches_tc`` those of each
    path."""
    if torch.is_grad_enabled() and x.requires_grad:
        return QMMFunction.apply(x, wq, scale)
    return _forward(x, wq, scale)


qmm.launches = qmm.launches_gemv = qmm.launches_tc = 0
