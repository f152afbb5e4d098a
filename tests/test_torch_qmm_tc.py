"""Kernel D's tensor-core path (more than 4 rows): its plain version and the
exactness its design rests on, on the CPU.

* ``qmm_plain_tf32x2``, the path's rounding in plain PyTorch (x split into
  two TF32 parts, each times the int8 weight, summed in fp32), against the
  JAX ``qmm`` in Pallas interpret mode at rows above 4 with ragged K: fp32 at
  the reference's bar (test_qmm_kernel.py:30), bf16 at 2e-2;
* every int8 value is unchanged by the port's TF32 rounding, by a bf16 cast
  and by the kernel's upcast (the byte as the low mantissa byte of 2^23), so
  the weight needs no split;
* ``qmm_plain_tf32x2`` within 1e-6 (relative to the largest output) of
  ``qmm_plain``;
* ``chip_smoke.device_kernels`` on stand-in profiler events: a CPU op and the
  kernel it launched count once.

The kernel itself is held against both plain versions on a card by
``tests/test_torch_kernels.py``.
"""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.ops import qmm_kernel as jax_qmm
from mapperatorinator_tpu_torch.ops.attention_kernel import tf32_split
from mapperatorinator_tpu_torch.ops.qmm_kernel import GEMV_ROWS, qmm_plain, qmm_plain_tf32x2
from tests.test_torch_qmm import QMM_TOL, quantized

torch.set_num_threads(1)

BF16_TOL = 2e-2  # times max(1, max |reference output|): one bf16 rounding of the output
PLAIN_TOL = 1e-6  # qmm_plain_tf32x2 against qmm_plain, times max(1, max |output|)
SHAPES = [(5, 128, 512), (70, 200, 128), (64, 256, 384)]  # rows > GEMV_ROWS; K 200 is ragged


def inputs(rows: int, k: int, n: int, seed: int = 1):
    x = np.random.default_rng(seed).standard_normal((rows, k)).astype(np.float32)
    wq, scale = quantized(k, n)
    return x, wq, scale


@pytest.mark.parametrize("rows,k,n", SHAPES)
def test_tf32x2_plain_matches_jax_fp32(rows, k, n):
    assert rows > GEMV_ROWS
    x, wq, scale = inputs(rows, k, n)
    want = np.asarray(jax_qmm.qmm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), True))
    got = qmm_plain_tf32x2(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=QMM_TOL, atol=QMM_TOL)


@pytest.mark.parametrize("rows,k,n", SHAPES)
def test_tf32x2_plain_matches_jax_bf16(rows, k, n):
    x, wq, scale = inputs(rows, k, n, seed=2)
    # both frameworks round the same fp32 values to bf16 to nearest even
    want = np.asarray(jax_qmm.qmm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wq), jnp.asarray(scale),
                                  True).astype(jnp.float32))
    got = qmm_plain_tf32x2(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (rows, n)
    tol = BF16_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_every_int8_value_is_exact_in_tf32_bf16_and_the_kernels_upcast():
    q = torch.arange(-128, 128, dtype=torch.int8)
    f = q.float()
    hi, lo = tf32_split(f)
    assert torch.equal(hi, f) and not lo.any()
    assert torch.equal(f.to(torch.bfloat16).float(), f)
    # csrc/qmm.cu:int8x4_to_float: byte q ^ 0x80 = q + 128 as the low mantissa
    # byte of 2^23, minus 2^23 + 128
    biased = (q.numpy().view(np.uint8) ^ 0x80).astype(np.uint32)
    upcast = (np.uint32(0x4B000000) | biased).view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(upcast, f.numpy())


@pytest.mark.parametrize("rows,k,n", SHAPES + [(1024, 768, 256)])
def test_tf32x2_plain_is_within_1e_6_of_plain(rows, k, n):
    x, wq, scale = (torch.from_numpy(a) for a in inputs(rows, k, n, seed=3))
    want = qmm_plain(x, wq, scale)
    got = qmm_plain_tf32x2(x, wq, scale)
    tol = PLAIN_TOL * max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_device_kernels_count_a_kernel_once():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(key, device_type, self_us, total_us, annotation=False):
        return SimpleNamespace(key=key, device_type=device_type, is_user_annotation=annotation, count=1,
                               self_device_time_total=self_us, device_time_total=total_us)

    events = [
        event("aten::linear", cpu, 0, 100),  # the op and the one it calls carry their kernel's time
        event("aten::addmm", cpu, 100, 100),
        event("sm90_xmma_gemm_f32f32", cuda, 100, 100),  # the kernel itself
        event("qmm_tc_kernel", cuda, 50, 50),  # a ctypes kernel: no op above it
        event("decode step", cuda, 150, 150, annotation=True),  # a user annotation on the device timeline
    ]
    kept = chip_smoke().device_kernels(events)
    assert [e.key for e in kept] == ["sm90_xmma_gemm_f32f32", "qmm_tc_kernel"]
    assert sum(e.self_device_time_total for e in kept) == 150
    assert sum(e.self_device_time_total for e in events) == 400  # what summing every event gave
