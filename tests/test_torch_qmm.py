"""Kernel D's plain version and the int8 quantization against the JAX package.

* ``qmm`` (on the CPU, its plain version) against the JAX ``qmm`` in Pallas
  interpret mode at the reference's shapes and bar (test_qmm_kernel.py:21-30),
  and its dx against ``jax.grad``;
* ``qmm_supported``, the JAX gate, over a grid of shapes;
* ``quantize_model`` against the JAX ``quantize_checkpoint`` on the tiny
  checkpoint at lane-tileable widths: the same sites, int8 kernels and
  scales equal bit for bit;
* ``quantize_kv`` / ``dequantize_kv`` against the JAX functions.
"""

import flax.traverse_util
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models import transformer as jax_transformer
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu.ops import qmm_kernel as jax_qmm
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model
from mapperatorinator_tpu_torch.models.params import flax_paths
from mapperatorinator_tpu_torch.models.transformer import QDense, dequantize_kv, quantize_kv, quantize_weight
from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm, qmm_supported
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint

torch.set_num_threads(1)

QMM_TOL = 1e-5  # test_qmm_kernel.py:30


def quantized(k: int, n: int, seed: int = 0):
    """test_qmm_kernel.py:15-18, on a seeded numpy weight."""
    w = np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.05
    scale = np.maximum(np.abs(w).max(axis=0), 1e-8) / 127
    q = np.clip(np.round(w / scale[None, :]), -128, 127).astype(np.int8)
    return q, scale.astype(np.float32)


@pytest.fixture(scope="module")
def lane_tiny(tmp_path_factory):
    """The tiny checkpoint at the lane-tileable widths of
    test_quantize_checkpoint.py:19-23, so the JAX QDense takes its qmm kernel."""
    directory = make_tiny_checkpoint(tmp_path_factory.mktemp("qckpt") / "ckpt", d_model=128, heads=4, ffn=256)
    jmodel, jparams, vocab = jax_load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


@pytest.mark.parametrize("b,k,n", [(1, 256, 384), (4, 128, 512), (3, 200, 128)])
def test_qmm_matches_jax(b, k, n):
    x = np.random.default_rng(1).standard_normal((b, k)).astype(np.float32)
    wq, scale = quantized(k, n)
    want = np.asarray(jax_qmm.qmm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), True))
    got = qmm(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=QMM_TOL, atol=QMM_TOL)


def test_qmm_dx_matches_jax_grad():
    x = np.random.default_rng(2).standard_normal((2, 128)).astype(np.float32)
    wq, scale = quantized(128, 256, seed=3)
    want = jax.grad(lambda a: jax_qmm.qmm(a, jnp.asarray(wq), jnp.asarray(scale), True).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    qmm(xt, torch.from_numpy(wq), torch.from_numpy(scale)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)  # test_qmm_kernel.py:45


def test_qmm_supported_is_the_jax_gate():
    # the reference's cases (test_qmm_kernel.py:45-55), v32's shapes and a grid around them
    ks = [32, 128, 200, 768, 3072, 4096, 32768]
    ns = [64, 100, 128, 512, 768, 1536, 2304, 3072, 4097, 8192]
    rows = [1, 2, 16, 64, 256, 512, 1024, 2048, 4096]
    for k in ks:
        for n in ns:
            for r in rows:
                assert qmm_supported(k, n, r) == jax_qmm.qmm_supported(k, n, r), (k, n, r)
    assert qmm_supported(768, 3072) and not qmm_supported(768, 4097)


def test_quantize_model_is_bit_equal_to_jax(lane_tiny):
    _, jmodel, jparams, tmodel, _ = lane_tiny
    _, qparams = quantize_checkpoint(jmodel, jparams)
    want = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(qparams, sep="/").items()}
    qmodel = quantize_model(tmodel)
    paths = flax_paths(qmodel)
    got = {paths[name]: t.numpy() for name, t in qmodel.state_dict().items()}
    assert set(got) == set(want)
    sites = sorted(p for p in want if p.endswith("/kernel_q"))
    assert sites == sorted(p for p in got if p.endswith("/kernel_q"))
    assert len(sites) == sum(isinstance(m, QDense) for m in qmodel.modules()) == 23
    for path in sites:
        for leaf in ("kernel_q", "scale"):
            leaf_path = path[: -len("kernel_q")] + leaf
            assert got[leaf_path].dtype == want[leaf_path].dtype
            np.testing.assert_array_equal(got[leaf_path], want[leaf_path], err_msg=leaf_path)


def test_quantize_weight_matches_the_reference_rule():
    w = np.random.default_rng(4).standard_normal((200, 128)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero column takes the 1e-8 floor
    q, scale = quantize_weight(torch.from_numpy(w))
    want_q, want_scale = quantized(200, 128, seed=4)
    want_q[:, 3] = 0
    want_scale[3] = np.float32(1e-8) / np.float32(127)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(scale.numpy(), want_scale)


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 7, 3, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0
    jq, js = jax_transformer.quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (2, 7, 3)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = dequantize_kv(tq, ts, dtype)
        want = np.asarray(jax_transformer.dequantize_kv(jq, js, jdtype).astype(jnp.float32))
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=0)
    # max-abs symmetric int8: error within scale / 2 = max|x| / 254 per token and head
    # (test_quantized_kv.py:31-40)
    err = (dequantize_kv(tq, ts, torch.float32) - torch.from_numpy(x)).abs().amax(-1)
    assert (err <= torch.from_numpy(np.abs(x).max(-1) / 254.0 + 1e-6)).all()


def test_qdense_keeps_int8_and_fp32_scales_through_a_cast():
    layer = QDense(128, 256, True, torch.bfloat16)
    q, scale = quantize_weight(torch.randn(128, 256, generator=torch.Generator().manual_seed(0)))
    layer.kernel_q.copy_(q)
    layer.scale.copy_(scale)
    layer = layer.to(torch.bfloat16)
    assert layer.kernel_q.dtype == torch.int8 and layer.bias.dtype == torch.bfloat16
    assert layer.scale.dtype == torch.float32 and torch.equal(layer.scale, scale)
    assert set(dict(layer.named_buffers())) == {"kernel_q", "scale"}
    assert [n for n, _ in layer.named_parameters()] == ["bias"]
