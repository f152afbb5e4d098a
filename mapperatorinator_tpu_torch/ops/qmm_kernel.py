"""Int8 weight-only matrix product: the CUDA kernel and its plain PyTorch
version.

Replaces ``mapperatorinator_tpu/ops/qmm_kernel.py`` (``_qmm_kernel`` via
``qmm``): ``(x @ upcast(wq)) * scale`` with an int8 (K, N) weight, a
per-column fp32 scale, fp32 accumulation and the output in x's dtype. The
kernel (``csrc/qmm.cu``) reads only int8 weight bytes from device memory; its
header says what bounds it on the H100. It has two paths: a GEMV for up to
``GEMV_ROWS`` rows (a decode step), whose K is split across the blocks of a
thread-block cluster as :func:`gemv_plan` says, and above that a GEMM on the
tensor cores, which takes an fp32 x as two TF32 products
(:func:`qmm_plain_tf32x2` rounds as it does). :func:`qmm` runs the plain
version for a tensor on the CPU and the kernel for a tensor on a CUDA device;
it never falls back from one to the other.

:func:`qmm_supported` is the JAX package's gate, unchanged: it decides which
of two roundings a ``QDense`` layer gets (this product, or the plain
expression in the compute dtype), so a gate derived for the H100 would change
bf16 results.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, launches
from .attention_kernel import tf32_split

_LANE = 128  # the TPU lane width the JAX gate tiles N by
GEMV_ROWS = 4  # the kernel's GEMV path takes up to this many rows, the tensor-core path more
GEMV_MAX_CLUSTER = 8  # blocks a cluster at most: the portable size (csrc/qmm.cu GV_MAX_CLUSTER)
GEMV_MIN_SLICE = 64  # rows of K a block of the cluster sums at least
GEMV_SMS = 132  # the H100 SXM's SMs: the plan gives each at least one block
GEMV_TILES = (128, 64, 32)  # the GEMV's column tiles, widest first

# x, wq, scale, out; rows, K, N, bf16 (and the GEMV's plan: bn, cluster, k_slice); the stream
_GEMV_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)
_TC_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


class GemvPlan(NamedTuple):
    """How the GEMV path splits (rows, K) x (K, N): ``cluster`` blocks own
    each tile of ``bn`` columns, block r of a cluster sums rows
    [r k_slice, min(K, (r + 1) k_slice)) of K, and the cluster's first block
    adds the blocks' partial sums."""

    bn: int
    cluster: int
    k_slice: int

    def blocks(self, n: int) -> int:
        return self.cluster * _ceil_div(n, self.bn)


@functools.cache
def gemv_plan(rows: int, k: int, n: int) -> GemvPlan:
    """The GEMV path's split for ``rows`` (1 to ``GEMV_ROWS``) of x (rows, K)
    times an int8 (K, N) weight: K in up to ``GEMV_MAX_CLUSTER`` slices of at
    least ``GEMV_MIN_SLICE`` rows (a multiple of 16, none empty), one a block
    of a cluster, and the widest column tile of ``GEMV_TILES`` that still
    gives one block for each of ``GEMV_SMS`` SMs (the narrowest where none
    does): wider tiles read longer runs of a weight row, more blocks put more
    of the weight in flight. At v32's decode shapes: qkv (768 x 2304) and fc1
    (768 x 3072) take tiles of 128 (144 and 192 blocks), the 768 x 768
    products and fc2 (3072 x 768) tiles of 32 (192 blocks). The plan does
    not depend on the row count."""
    if not 1 <= rows <= GEMV_ROWS or k < 1 or n < 1:
        raise ValueError(f"gemv_plan: rows {rows} must be 1 to {GEMV_ROWS}, K {k} and N {n} positive")
    cluster = min(GEMV_MAX_CLUSTER, _ceil_div(k, GEMV_MIN_SLICE))
    k_slice = 16 * _ceil_div(_ceil_div(k, cluster), 16)
    cluster = _ceil_div(k, k_slice)  # rounding k_slice up may leave the last slices empty: drop them
    bn = next((bn for bn in GEMV_TILES if cluster * _ceil_div(n, bn) >= GEMV_SMS), GEMV_TILES[-1])
    return GemvPlan(bn, cluster, k_slice)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


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


def _check(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> tuple[int, int, int, int]:
    """(rows, K, N, CUDA device index) of operands the kernel takes; anything
    else raises."""
    device = x.get_device()
    if device < 0 or wq.get_device() != device or scale.get_device() != device:
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
    return rows, k, n, device


def qmm_kernel(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch kernel D on PyTorch's current stream: up to ``GEMV_ROWS`` rows
    its GEMV path (entry ``qmm_gemv``, split by :func:`gemv_plan`), more its
    tensor-core path (entry ``qmm_tc``). x: contiguous fp32 or bf16 (rows, K)
    on a CUDA device; wq: contiguous int8 (K, N), N a multiple of 16, 16-byte
    aligned; scale: contiguous fp32 (N,); anything else raises, and so does a
    launch the card refuses."""
    rows, k, n, device = _check(x, wq, scale)
    out = x.new_empty((rows, n))
    stream = torch._C._cuda_getCurrentRawStream(device)
    bf16 = int(x.dtype == torch.bfloat16)
    if rows <= GEMV_ROWS:
        fn = _build.function("qmm", "qmm_gemv", _GEMV_ARGTYPES)
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n, bf16,
                 *gemv_plan(rows, k, n), stream)
        _build.check(fn.lib, err, "qmm (GEMV)")
        launches.count(qmm, "launches", "launches_gemv")
    else:
        fn = _build.function("qmm", "qmm_tc", _TC_ARGTYPES)
        err = fn(x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n, bf16, stream)
        _build.check(fn.lib, err, "qmm (tensor cores)")
        launches.count(qmm, "launches", "launches_tc")
    return out


def _forward(x, wq, scale) -> torch.Tensor:
    if x.is_cpu:
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
    path, replays of a captured :class:`.launches.Graph` included."""
    if torch.is_grad_enabled() and x.requires_grad:
        return QMMFunction.apply(x, wq, scale)
    return _forward(x, wq, scale)


qmm.launches = qmm.launches_gemv = qmm.launches_tc = 0
