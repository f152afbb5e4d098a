"""Kernel D's GEMV path (up to 4 rows, K split across a thread-block cluster)
on the CPU: its plan, its plain version against the JAX package, and the
names ``chip_smoke.py`` profiles it by.

* ``gemv_plan`` over rows 1-4, K 1-4 096 and N any multiple of 16 up to
  8 192 (a hypothesis property): the K slices cover [0, K) exactly, without
  overlap and none empty, in clusters of at most 8 blocks, and the column
  tiles cover N; the plan's limits are those ``csrc/qmm.cu`` takes;
* at v32's decode shapes the plan gives at least one block for each of the
  H100's 132 SMs;
* ``qmm`` on the CPU (its plain version) against the JAX ``qmm`` in Pallas
  interpret mode at those shapes, at the reference's bar
  (test_qmm_kernel.py:30);
* every kernel name that ``chip_smoke.py``'s decode profile looks for is a
  ``__global__`` function of ``csrc/qmm.cu``, so a renamed kernel fails here
  before it reads 0 on the card.

The kernel itself is held against the plain version on a card by
``tests/test_torch_kernels.py``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mapperatorinator_tpu.ops import qmm_kernel as jax_qmm
from mapperatorinator_tpu_torch.ops.qmm_kernel import (
    GEMV_MAX_CLUSTER,
    GEMV_ROWS,
    gemv_plan,
    qmm,
    qmm_supported,
)
from tests.test_torch_qmm import QMM_TOL, quantized
from tests.test_torch_qmm_tc import chip_smoke

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
QMM_CU = REPO / "mapperatorinator_tpu_torch" / "csrc" / "qmm.cu"
SMS = 132  # the H100 SXM's streaming multiprocessors
# a decode step's products on the GEMV path: qkv, the 768-wide ones, fc1, fc2,
# and with CFG (2 rows) a 768-wide one
DECODE_SHAPES = [(1, 768, 2304), (1, 768, 768), (1, 768, 3072), (1, 3072, 768), (2, 768, 768)]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(rows=st.integers(1, GEMV_ROWS), k=st.integers(1, 4096), n=st.integers(1, 512).map(lambda t: 16 * t))
def test_gemv_plan_covers_k_and_n(rows, k, n):
    plan = gemv_plan(rows, k, n)
    assert 1 <= plan.cluster <= GEMV_MAX_CLUSTER
    # block r of a cluster sums rows [r k_slice, min(K, (r + 1) k_slice)), as csrc/qmm.cu does
    slices = [(r * plan.k_slice, min(k, (r + 1) * plan.k_slice)) for r in range(plan.cluster)]
    assert slices[0][0] == 0 and slices[-1][1] == k
    assert all(lo < hi for lo, hi in slices)  # none empty
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # adjacent: no gap, no overlap
    # what csrc/qmm.cu:qmm_gemv takes: bn 32, 64 or 128, the slice a multiple of 4
    assert plan.bn in (32, 64, 128) and plan.k_slice % 4 == 0
    tiles = plan.blocks(n) // plan.cluster
    assert (tiles - 1) * plan.bn < n <= tiles * plan.bn


@pytest.mark.parametrize("rows,k,n", DECODE_SHAPES)
def test_gemv_plan_fills_the_card_at_decode_shapes(rows, k, n):
    plan = gemv_plan(rows, k, n)
    assert plan.blocks(n) >= SMS, plan


def test_gemv_plan_refuses_rows_off_the_gemv_path():
    with pytest.raises(ValueError, match="rows"):
        gemv_plan(GEMV_ROWS + 1, 768, 768)


@pytest.mark.parametrize("rows,k,n", DECODE_SHAPES)
def test_qmm_matches_jax_at_decode_shapes(rows, k, n):
    assert qmm_supported(k, n, rows)  # the JAX gate sends these to its kernel
    x = np.random.default_rng(k + n + rows).standard_normal((rows, k)).astype(np.float32)
    wq, scale = quantized(k, n, seed=rows)
    want = np.asarray(jax_qmm.qmm(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale), True))
    got = qmm(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (rows, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=QMM_TOL, atol=QMM_TOL)


def global_functions(source: str) -> set[str]:
    return set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", source))


def test_profiled_kernel_names_are_kernels_of_qmm_cu():
    kernels = global_functions(QMM_CU.read_text())
    names = chip_smoke().QMM_KERNELS
    assert set(names) == {"qmm_gemv", "qmm_tc"}
    missing = {path: name for path, name in names.items() if name not in kernels}
    assert not missing, f"chip_smoke.py profiles {missing}, which csrc/qmm.cu does not define ({sorted(kernels)})"


def test_plan_limits_match_the_kernel_source():
    source = QMM_CU.read_text()
    assert int(re.search(r"constexpr int GV_MAX_CLUSTER = (\d+);", source).group(1)) == GEMV_MAX_CLUSTER
    # the old SIMT GEMV and its static_cast<float> of each int8 weight are gone
    assert "qmm_gemv_kernel" not in global_functions(source)
    assert "static_cast<float>(q[" not in source
