"""Training and serving on the port's tensor axis on the CPU over gloo: the
train step, checkpoints, ``adafactor``, ``train.main`` and ``DecodeEngine``
against the port's one process, the JAX package and optax.

* One step: two adamwscale updates on ``tests/test_train.py``'s batch
  under tensor 2 (8 rows), under (data 2 x tensor 2) (4 rows a data group)
  and under (fsdp 2 x tensor 2) (FSDP on the leaves the tensor axis leaves
  whole) equal one process's losses, norms and parameters at the model
  bar, fp32; the first loss is within that test's 2e-3 of the JAX
  ``dp4tp2`` step on the same batch (bf16, ``tests/test_train.py:180``).
* Checkpoints: one process, 2 FSDP ranks and 2 tensor ranks each restore
  the checkpoints of one process, FSDP, tensor 2 and (data 2 x tensor 2):
  the full parameters and optimizer buffers equal the file's (flax order,
  whatever the layout), and the next step's loss is one process's.
* ``Adafactor``: 3 updates (6 micro-steps under ``MultiSteps`` 2, after
  ``ClipByGlobalNorm``) equal ``optax.adafactor`` fed the same gradients,
  on a factored matrix, an unfactored one (a dim below 128) and a vector;
  then 3 updates of the tiny model under FSDP and under tensor 2, a save,
  a restore into a scrambled state and a fourth update equal one process's.
* LoRA on the tensor axis: the base and the factors whole, as JAX keeps
  them; two steps' losses and the factors' gradients equal one process's.
* Decode: greedy tokens through ``DecodeEngine`` under tensor 2 (4 rows)
  and under (data 2 x tensor 2) (2 rows a data group) equal the single
  engine's, as ``tests/test_decode.py:430`` asserts for JAX; each rank's
  cache holds its 2 of the 4 heads.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import __graft_entry__ as graft
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.parallel import shard_batch, shard_params
from mapperatorinator_tpu.parallel.mesh import ensure_on_mesh
from mapperatorinator_tpu.train import make_train_step as jax_make_train_step
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu.train.step import init_train_state
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.train import optim
from tests.fixtures.torch_parallel_worker import fsdp_batch
from tests.test_torch_model import audio, tiny  # noqa: F401  (module fixture)
from tests.test_torch_parallel_train import digest_checkpoints, launch, results, wait
from tests.test_torch_train import MODEL_TOL

TP_BAR = 2e-3  # tests/test_train.py:224
MAX_LEN = 48


def jax_dp4tp2_loss(checkpoint) -> float:
    """``tests/test_train.py``'s dp4tp2 step: its loss."""
    model, params, vocab = jax_load_checkpoint(checkpoint)
    _, args, _ = graft._tiny_v32_model(d_model=32, layers=1, heads=2, ffn=64, tgt_len=32, src_len=64)
    args.optim.name, args.optim.warmup_steps, args.optim.total_steps = "adamwscale", 10, 100
    tx = jax_optim.build_optimizer(args)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("data", "tensor"))
    state = ensure_on_mesh(mesh, init_train_state(shard_params(mesh, params, tensor_axis="tensor"), tx))
    _, metrics = jax_make_train_step(model, tx, mesh=mesh)(state, shard_batch(mesh, fsdp_batch(vocab)),
                                                           jax.random.PRNGKey(1))
    return float(metrics["loss"])


def decode_inputs(root, checkpoint) -> tuple[dict, np.ndarray]:
    """4 rows of audio and prompts ending in SOS, written for the ranks; the
    single engine's greedy tokens."""
    model, vocab = load_checkpoint(checkpoint)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, vocab.vocab_size_out, (4, 12)).astype(np.int32)
    ids[:, -1] = vocab.sos_id
    frames = audio(4)
    np.savez(root / "decode.npz", frames=frames, ids=ids)
    engine = DecodeEngine(model.eval(), MAX_LEN, vocab.pad_id, device="cpu")
    tokens, _ = engine.generate(engine.encode_with_cond(frames), ids, build_logits_pipeline(vocab, do_sample=False),
                                [vocab.eos_id], seed=0)
    task = {"task": "decode", "name": "decode", "checkpoint": str(checkpoint), "inputs": str(root / "decode.npz"),
            "max_length": MAX_LEN}
    return task, tokens


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny):  # noqa: F811
    root = tmp_path_factory.mktemp("tensor_parallel_train")
    bf16, fp32 = digest_checkpoints(root)
    work = root / "runs"
    decode, decode_want = decode_inputs(root, tiny[0])

    def layout(name):
        return {"task": "layout", "name": "layout8", "checkpoint": str(fp32), "ckpt_dir": str(work / "ckpt" / name)}

    def adafactor(name):
        return {"task": "adafactor", "name": "adafactor", "checkpoint": str(fp32),
                "ckpt_dir": str(work / "adafactor_ckpt" / name)}

    lora = {"task": "lora_train", "name": "lora_train", "checkpoint": str(fp32)}
    # waves of at most 5 processes: the suite's other files share the cores
    children = (launch(work / "single", "single", 1, [layout("single"), adafactor("single"), lora])
                + launch(work / "tp2", "tp2", 2, [layout("tp2"), adafactor("tp2"), lora, decode])
                + launch(work / "fsdp", "fsdp", 2, [layout("fsdp"), adafactor("fsdp")]))
    jax_loss = jax_dp4tp2_loss(bf16)
    wait(children)
    wait(launch(work / "dp2tp2", "dp2tp2", 4, [layout("dp2tp2"), decode]))

    sources = {name: str(work / "ckpt" / name) for name in ("single", "fsdp", "tp2", "dp2tp2")}
    restore = [{"task": "restore", "name": "restore", "checkpoint": str(fp32), "sources": sources}]
    wait(launch(work / "restore_single", "single", 1, restore) + launch(work / "restore_fsdp", "fsdp", 2, restore)
         + launch(work / "restore_tp2", "tp2", 2, restore))
    wait(launch(work / "fsdp2tp2", "fsdp2tp2", 4, [layout("fsdp2tp2")]))
    worlds = {"single": 1, "tp2": 2, "dp2tp2": 4, "fsdp2tp2": 4, "fsdp": 2, "restore_single": 1, "restore_fsdp": 2,
              "restore_tp2": 2}
    return {"work": work, "jax": jax_loss, "decode": decode_want,
            **{name: results(work / name, world) for name, world in worlds.items()}}


def npz(runs, layout: str, name: str) -> dict:
    with np.load(runs["work"] / layout / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("layout", ["tp2", "dp2tp2", "fsdp2tp2"])
def test_tensor_step_matches_one_process_and_jax(runs, layout):
    got, want = runs[layout][0]["layout8"], runs["single"][0]["layout8"]
    assert all(r["layout8"] == got for r in runs[layout])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=MODEL_TOL, atol=MODEL_TOL)
    np.testing.assert_allclose(got["grad_l2"], want["grad_l2"], rtol=MODEL_TOL)
    np.testing.assert_allclose(got["weights_l2"], want["weights_l2"], rtol=MODEL_TOL)
    params, ref = npz(runs, layout, "layout8"), npz(runs, "single", "layout8")
    assert sorted(params) == sorted(ref) and got["sharded"] > 0
    for path in ref:
        np.testing.assert_allclose(params[path], ref[path], rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)
    assert abs(got["losses"][0] - runs["jax"]) < TP_BAR, (got["losses"][0], runs["jax"])


@pytest.mark.parametrize("restorer", ["restore_single", "restore_fsdp", "restore_tp2"])
def test_every_layout_restores_tensor_checkpoints(runs, restorer):
    result = runs[restorer][0]["restore"]
    assert all(r["restore"] == result for r in runs[restorer])
    want_loss = runs["restore_single"][0]["restore"]["single"]["loss"]
    for source, r in result.items():
        assert r["model_equal"] and r["optimizer_equal"] and r["step"] == 2, (source, r)
        assert abs(r["loss"] - want_loss) <= MODEL_TOL * abs(want_loss), (source, r["loss"], want_loss)


def test_adafactor_matches_optax():
    """A factored (256, 192) kernel, an unfactored (64, 300) one (64 < 128)
    and a vector, 6 micro-steps of gradients of two scales, so that both the
    global clip and the block clip act."""
    rng = np.random.default_rng(0)
    shapes = {"params/a/wq/kernel": (256, 192), "params/a/fc1/kernel": (64, 300), "params/a/norm/scale": (77,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    schedule = optax.linear_schedule(0.01, 0.001, 10)
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(schedule)), 2)
    state = tx.init(params)

    def torch_layout(x):
        return torch.from_numpy(np.ascontiguousarray(x.T if x.ndim == 2 else x))

    named = [(k, torch.nn.Parameter(torch_layout(v))) for k, v in params.items()]
    port = optim.MultiSteps(optim.ClipByGlobalNorm(optim.Adafactor(named, lambda c: float(schedule(c))), 1.0), 2,
                            [p for _, p in named])
    assert [optim.factored_dims(s) for s in shapes.values()] == [(1, 0), None, None]
    for i in range(6):
        grads = {k: (rng.standard_normal(s) * (3.0 if i % 2 else 0.1)).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        port.step([torch_layout(g) for g in grads.values()])
    assert port.count == 3
    inner = state.inner_opt_state[1][0]
    saved = port.state_dict()["inner"]
    for i, (path, p) in enumerate(named):
        got = p.detach().numpy()
        np.testing.assert_allclose(got.T if got.ndim == 2 else got, params[path], rtol=1e-5, atol=1e-6, err_msg=path)
        for key in ("v_row", "v_col", "v"):
            np.testing.assert_allclose(saved[key][i].numpy(), np.asarray(getattr(inner, key)[path]), rtol=1e-5,
                                       atol=1e-30, err_msg=f"{path} {key}")


@pytest.mark.parametrize("layout", ["fsdp", "tp2"])
def test_adafactor_across_layouts(runs, layout):
    got, want = runs[layout][0]["adafactor"], runs["single"][0]["adafactor"]
    assert got["count"] == want["count"] == 4
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=MODEL_TOL, atol=MODEL_TOL)
    params, ref = npz(runs, layout, "adafactor"), npz(runs, "single", "adafactor")
    for path in ref:
        np.testing.assert_allclose(params[path], ref[path], rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)


def test_lora_on_the_tensor_axis(runs):
    got, want = runs["tp2"][0]["lora_train"], runs["single"][0]["lora_train"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=MODEL_TOL)
    grads, ref = npz(runs, "tp2", "lora_train"), npz(runs, "single", "lora_train")
    assert sorted(grads) == sorted(ref) and len(ref) > 0
    for key in ref:
        np.testing.assert_allclose(grads[key], ref[key], rtol=MODEL_TOL, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("layout", ["tp2", "dp2tp2"])
def test_sharded_decode_matches_the_single_engine(runs, layout):
    want, ranks = runs["decode"], runs[layout]
    rows_per_group = 4 if layout == "tp2" else 2
    for rank, r in enumerate(ranks):
        group = rank // 2 if layout == "dp2tp2" else 0
        rows = want[group * rows_per_group:(group + 1) * rows_per_group]
        np.testing.assert_array_equal(np.asarray(r["decode"]["tokens"]), rows)
        assert r["decode"]["cache_heads"] == 2  # the tiny checkpoint's 4 heads over the axis
