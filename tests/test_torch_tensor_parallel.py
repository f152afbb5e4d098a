"""The tensor axis of the port (``parallel/tensor.py``, ``parallel/sharding.py``)
on the CPU over gloo, against the JAX package's rule and the port's one
process.

* The rule: ``param_specs(tensor_axis=...)`` equals the JAX
  ``param_specs`` leaf for leaf, and ``describe_sharding``'s counts, on the
  tiny v32, stock whisper, T5, nGPT and moonshine trees and an int8 tree,
  on tensor meshes of 2, 3 and 4 and beside data and fsdp axes (the tensor
  spec first, as in JAX).
* Forward and backward: each family at tensor 2 (the blocks on the rank's
  heads) gives the one-process loss, logits and every gradient, gathered in
  flax order, within ``TP_TOL`` (fp32, of each tensor's largest entry);
  so do the tiny v32 at tensor 3 (4 heads: its fused ``wqkv`` sharded
  mid-head as a contiguous chunk, the other projections whole) and a
  moonshine of 8 heads of 36 at tensor 3 (``inner`` 288: every attention
  projection sharded, the heads gathered; the feed-forward on the rank's
  share).
* ``train.main`` with ``parallel.axis_names=[tensor] parallel.mesh_shape=[2]
  parallel.tensor_axis=tensor`` on 2 processes: one process's losses at
  the JAX bar; after two Muon updates its Muon-branch matrices at the JAX
  suite's Muon bar (``tests/test_train.py:91``) and its other leaves
  together within the model bar.

Training steps, checkpoints, adafactor and decode on the tensor axis are
``tests/test_torch_tensor_parallel_train.py``'s.

The ranks are child processes of ``tests/fixtures/torch_parallel_worker.py``
(torch and the port only), all started at once by a module fixture.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

from mapperatorinator_tpu import parallel as jax_parallel
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu_torch import parallel
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import quantize_model
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.params import flax_layout, flax_paths, init_params
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.parallel.sharding import flax_shape, torch_dim
from mapperatorinator_tpu_torch.train import optim
from tests.test_torch_backbone_train import TINY_OVERRIDES, batch_arrays, port_model
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)
from tests.test_torch_data import write_ors
from tests.test_torch_parallel_train import JAX_BAR, free_port, launch, main_argv, results, wait
from tests.test_torch_train import MODEL_TOL, MUON_TOL, without_key_biases

torch.set_num_threads(1)

TP_TOL = 1e-5  # fp32: |port tensor 2 - one process| <= TP_TOL x the tensor's largest entry (and 1e-5 on the loss)
FAMILIES = ["v32", "v28", "t5_base", "nwhisper_base", "moonshine_tiny"]
# moonshine at tensor 3: 8 heads of 36 (inner 288, which 3 divides; 8 heads, which it does not), ffn 96
MOONSHINE_288 = ["model.overwrite.d_model=288", "model.overwrite.encoder_attention_heads=8",
                 "model.overwrite.decoder_attention_heads=8", "model.overwrite.encoder_ffn_dim=96",
                 "model.overwrite.decoder_ffn_dim=96", "model.overwrite.encoder_layers=1",
                 "model.overwrite.decoder_layers=1"]

TENSOR_MAIN = ['parallel.axis_names=["tensor"]', "parallel.mesh_shape=[2]", "parallel.tensor_axis=tensor"]

# (mesh shape, axis names, fsdp axis)
MESHES = {"tp2": ((2,), ("tensor",), None), "tp3": ((3,), ("tensor",), None), "tp4": ((4,), ("tensor",), None),
          "dp4tp2": ((4, 2), ("data", "tensor"), None), "fsdp2tp2": ((2, 2), ("fsdp", "tensor"), "fsdp"),
          "dp2fsdp2tp2": ((2, 2, 2), ("data", "fsdp", "tensor"), "fsdp")}


def jax_specs(jparams, mesh: Mesh, fsdp_axis) -> dict:
    specs = jax_parallel.param_specs(jparams, tensor_axis="tensor", fsdp_axis=fsdp_axis, mesh=mesh)
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(k.key) for k in path): tuple(spec) for path, spec in leaves}, specs


def tree(tiny, name: str):  # noqa: F811
    """(JAX params, port model) of one tree."""
    _, jmodel, jparams, tmodel, _ = tiny
    if name == "v32":
        return jparams, tmodel
    if name == "int8":
        return quantize_checkpoint(jmodel, jparams)[1], quantize_model(tmodel)
    _, jp, _, tm = port_model(name)
    return jp, tm


@pytest.mark.parametrize("layout", list(MESHES))
@pytest.mark.parametrize("name", ["v32", "v28", "t5_base", "nwhisper_base", "moonshine_tiny", "int8"])
def test_tensor_specs_match_jax_leaf_for_leaf(tiny, name, layout):  # noqa: F811
    """Each leaf's spec, the counts, and the torch dimension a spec names."""
    jparams, tmodel = tree(tiny, name)
    shape, axes, fsdp = MESHES[layout]
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), axes)
    want, jspecs = jax_specs(jparams, mesh, fsdp)
    got = parallel.param_specs(tmodel, tensor_axis="tensor", fsdp_axis=fsdp, mesh=dict(zip(axes, shape)))
    assert got == want
    assert parallel.describe_sharding(got) == jax_parallel.describe_sharding(jparams, jspecs)
    sharded = [p for p, spec in got.items() if "tensor" in spec]
    if name == "int8":  # QDense's int8 kernel is `kernel_q`, not `kernel`: the projections stay whole on the axis
        assert not sharded
    else:  # every tiny width is even; 3 divides some
        assert sharded or layout == "tp3"
        assert all(p.split("/")[-2] in parallel.sharding.COLUMN_PARALLEL + parallel.sharding.ROW_PARALLEL
                   for p in sharded)
    paths, tensors = flax_paths(tmodel), tmodel.state_dict(keep_vars=True)
    for name_, path in paths.items():
        spec = got[path]
        for axis in ("tensor", fsdp):
            if axis and axis in spec:
                dim = spec.index(axis)
                t = tensors[name_]
                assert t.shape[torch_dim(dim, t.dim(), path)] == flax_shape(t.shape, path)[dim]


def family_inputs(root, case: str, name: str, overrides=(), seed: int = 0) -> dict:
    """A family's tiny training config, its seeded parameters and a batch,
    written for the ranks; and the one-process loss, logits and gradients."""
    overrides = TINY_OVERRIDES + list(overrides)
    args = load_train_config(name, overrides)
    model = Mapperatorinator(build_config(args, build_vocabulary(args)))
    init_params(model, seed)
    state, batch = root / f"{name}_{seed}.pt", root / f"{name}_{seed}.npz"
    torch.save(model.state_dict(), state)
    arrays = batch_arrays(model.cfg)
    np.savez(batch, **arrays)
    model.train()
    logits, loss = model(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    loss.backward()
    paths = flax_paths(model)
    grads = {paths[n]: flax_layout(p.grad, paths[n]).numpy() for n, p in model.named_parameters()}
    return {"task": {"task": "grads", "name": case, "config": name, "overrides": overrides, "state": str(state),
                     "batch": str(batch)},
            "want": {"loss": loss.item(), "logits": logits.detach().numpy(), "grads": grads}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each layout's cases run one after another in one set of ranks; then
    ``train.main`` on one process and on two at tensor 2."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    work = root / "runs"
    ors = write_ors(root / "ors")
    cases = {f"{name}_tp2": family_inputs(root, f"{name}_tp2", name) for name in FAMILIES}
    cases["v32_tp3"] = family_inputs(root, "v32_tp3", "v32", seed=1)
    cases["moonshine288_tp3"] = family_inputs(root, "moonshine288_tp3", "moonshine_tiny", MOONSHINE_288, seed=2)

    def main_task(name, processes, *extra):
        return [{"task": "main", "name": "main", "log_dir": str(work / f"{name}_logs"),
                 "argv": main_argv(ors, work / f"{name}_ckpt", free_port(), processes) + list(extra)}]

    # two waves of at most 5 processes: the suite's other files share the cores
    children = []
    for layout in ("tp2", "tp3"):
        children += launch(work / layout, layout, int(layout[-1]),
                           [inputs["task"] for case, inputs in cases.items() if case.endswith(layout)])
    wait(children)
    wait(launch(work / "main1", "main", 1, main_task("main1", 1))
         + launch(work / "main2_tp", "main", 2, main_task("main2_tp", 2, *TENSOR_MAIN)))
    ranks = {layout: results(work / layout, int(layout[-1])) for layout in ("tp2", "tp3")}
    out = {case: {"want": inputs["want"], "ranks": [r[case] for r in ranks[case[-3:]]],
                  "got": dict(np.load(work / case[-3:] / f"{case}.npz"))} for case, inputs in cases.items()}
    return {**out, "work": work, "main1": results(work / "main1", 1), "main2_tp": results(work / "main2_tp", 2)}


def assert_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=TP_TOL * scale, err_msg=what)


@pytest.mark.parametrize("case", [f"{name}_tp2" for name in FAMILIES] + ["v32_tp3", "moonshine288_tp3"])
def test_forward_and_backward_match_one_process(runs, case):
    run = runs[case]
    want, got, ranks = run["want"], run["got"], run["ranks"]
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)
    assert abs(ranks[0]["loss"] - want["loss"]) <= 1e-5, (ranks[0]["loss"], want["loss"])
    assert_close(got["logits"], want["logits"], "logits")
    for path, g in want["grads"].items():
        assert_close(got[f"grad/{path}"], g, path)
    info = ranks[0]
    assert info["sharded"] > 0 and info["blocks"] > 0
    if case.endswith("tp2"):  # every block on the rank's heads (every tiny width is even)
        assert info["local_blocks"] == info["blocks"], info
    elif case == "v32_tp3":  # 4 heads, inner 64: only the fused wqkv (192 wide) lies on the axis, whole heads
        assert info["local_blocks"] == 0, info
    else:  # moonshine, 8 heads of 36: the attention blocks gather, the feed-forwards (96 wide) stay local
        assert 0 < info["local_blocks"] < info["blocks"], info
    if case.startswith(("t5", "nwhisper")) and case.endswith("tp2"):  # the bias table / qk_scale: summed over the axis
        assert info["partial"] > 0


def test_train_main_on_the_tensor_axis(runs):
    work = runs["work"]
    for r in runs["main2_tp"]:
        assert (r["main"]["step"], r["main"]["updates"], r["main"]["backend"]) == (2, 2, "gloo")
        assert r["main"]["sharded"] > 0

    def losses(name):
        lines = (work / f"{name}_logs" / "metrics.jsonl").read_text().splitlines()
        return [json.loads(line)["train/loss"] for line in lines if "train/loss" in line]

    np.testing.assert_allclose(losses("main2_tp"), losses("main1"), rtol=0, atol=JAX_BAR)
    # the parameters after two Muon updates: each Muon-branch matrix at the JAX suite's Muon bar (Newton-Schulz in
    # bf16 magnifies last-bit differences of the gradient, which the tensor ranks sum in another order), the
    # AdamW-branch leaves together within the model bar in norm (its normalisation turns a gradient element of
    # rounding size into a step of either size: one element of a cross-attention q bias moves 3.5e-3 relative);
    # the key biases, whose exact gradient is 0, aside (tests/test_torch_train.py)
    want = torch.load(work / "main1_ckpt" / "2" / "state.pt", weights_only=True)["model"]
    got = torch.load(work / "main2_tp_ckpt" / "2" / "state.pt", weights_only=True)["model"]
    assert sorted(got) == sorted(want)
    adamw = []
    for name in want:
        a, b = (without_key_biases(name.replace(".", "/"), t.numpy()) for t in (got[name], want[name]))
        if optim.muon_branch_mask(name, want[name]):
            np.testing.assert_allclose(a, b, rtol=MUON_TOL[0], atol=MUON_TOL[1], err_msg=name)
        else:
            adamw.append((a.ravel(), b.ravel()))
    a, b = (np.concatenate([pair[i] for pair in adamw]) for i in (0, 1))
    assert np.linalg.norm(a - b) <= MODEL_TOL * np.linalg.norm(b)
