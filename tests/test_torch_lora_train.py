"""LoRA fine-tuning on the port against the JAX package, on the tiny
v32-architecture checkpoint, in fp32.

* one step of ``make_lora_train_step`` against the JAX one, with AdamW
  (``lora.yaml``) and Muon (``lora_v32.yaml``), at B = 0 (A's gradient is
  exactly 0 there, and Muon's Newton-Schulz must turn a zero matrix into a
  zero update) and at B != 0: the loss and ``grad_l2`` against the JAX
  step's and the factors' gradients against ``jax.grad`` at the model bar,
  the updated factors against optax's update from those gradients at the
  optimizer bars of ``test_torch_train.py``, and the base weights unchanged;
* ``train.main -cn lora`` with ``pretrained_path``: the ``gamemode=0``
  subfolder is chosen, the adapter written to ``<checkpoint_path>/lora``
  loads in the JAX ``load_lora``, a resumed run restores the factors and the
  optimizer's count, and ``enable_lora`` without ``pretrained_path`` raises;
* the ``profile`` window: a trace starts before the step that begins at
  ``wait`` completed steps and stops at ``wait + warmup + active``, where
  ``early_stop`` ends the loop;
* ``step_flops`` under LoRA: the JAX figure (the factors' 6 N and
  attention) and the port's numerator beside it; the loop logs each gauge
  of the ``flops`` callable ``train.main`` hands it over the peak times the
  seconds per step.
"""

import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapperatorinator_tpu.models import lora as jax_lora
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.train import loop as jax_loop
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu.train.step import init_train_state, make_lora_train_step as jax_make_lora_train_step
from mapperatorinator_tpu.train.step import wrap_grad_acc
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models import lora
from mapperatorinator_tpu_torch.models.mapperatorinator import MapperatorinatorConfig
from mapperatorinator_tpu_torch.models.params import flatten, lora_from_flax, torch_name, unflatten
from mapperatorinator_tpu_torch.train import loop, optim
from mapperatorinator_tpu_torch.train import main as train_main
from mapperatorinator_tpu_torch.train.step import TrainState, make_lora_train_step, named_flax_params
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint
from tests.test_torch_data import data_overrides, ors_root  # noqa: F401  (module fixture)
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)
from tests.test_torch_train import ADAMW_TOL, MODEL_TOL, MUON_TOL, batch_arrays, configs, port_model

torch.set_num_threads(1)

RANK, ALPHA = 8, 16.0
LORA_ARGS = ["enable_lora=true", "pretrained_path=base", f"lora.r={RANK}", f"lora.lora_alpha={ALPHA}",
             "optim.total_steps=50", "optim.warmup_steps=0", "optim.sustain_steps=0", "optim.lr_scheduler=cosine",
             "optim.weight_decay=0.01", "optim.base_lr=0.002", "optim.base_lr_2=0.001", "optim.grad_acc=1",
             "optim.grad_clip=0"]


def factor_tree(jparams, b_nonzero: bool) -> dict:
    tree = jax.device_get(jax_lora.init_lora_params(jax.random.PRNGKey(0), jparams, rank=RANK))
    if b_nonzero:
        rng = np.random.default_rng(1)
        tree = jax.tree.map(lambda x: x if not np.all(x == 0) else
                            (0.05 * rng.standard_normal(x.shape)).astype(np.float32), tree)
    return tree


@pytest.mark.parametrize("b_nonzero", [False, True], ids=["b0", "b"])
@pytest.mark.parametrize("name", ["adamw", "muon"])
def test_lora_step_matches_jax(tiny, name, b_nonzero):  # noqa: F811
    jax_args, args = configs(LORA_ARGS + [f"optim.name={name}"])
    jm, jparams, tm = port_model(tiny)
    tree = factor_tree(jparams, b_nonzero)
    tx = wrap_grad_acc(jax_optim.build_optimizer(jax_args), 1)
    jstate, jmetrics = jax_make_lora_train_step(jm, tx, jparams, alpha=ALPHA)(
        init_train_state(tree, tx), {k: jnp.asarray(v) for k, v in batch_arrays(tm.cfg.vocab_size_in).items()},
        jax.random.PRNGKey(0))

    def jax_loss(factors):
        merged = jax_lora.merge_lora(jparams, factors, alpha=ALPHA)
        return jm.apply(merged, **{k: jnp.asarray(v) for k, v in batch_arrays(tm.cfg.vocab_size_in).items()},
                        deterministic=True)[1]

    want_grads = flatten(jax.device_get(jax.jit(jax.grad(jax_loss))(tree)))

    adapter = lora.init_lora_params(tm, rank=RANK)
    adapter.load_state_dict(lora_from_flax(tree))
    base = {n: p.detach().clone() for n, p in tm.state_dict().items()}
    state = TrainState(step=0, model=adapter, optimizer=optim.build_optimizer(args, named_flax_params(adapter)))
    recorded = []
    inner = state.optimizer.step
    state.optimizer.step = lambda grads: (recorded.append([g.clone() for g in grads]), inner(grads))
    state, metrics = make_lora_train_step(tm, alpha=ALPHA)(state, batch_arrays(tm.cfg.vocab_size_in))

    assert state.step == int(jstate.step) == 1 and set(metrics) == set(jmetrics) == {"loss", "grad_l2"}
    for key in ("loss", "grad_l2"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=MODEL_TOL, err_msg=key)
    paths = [p for p, _ in named_flax_params(adapter)]
    for path, g in zip(paths, recorded[0]):
        np.testing.assert_allclose(g.numpy(), want_grads[path], rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)
        if not b_nonzero and path.endswith("/a"):
            assert not g.any(), path  # dL/dA = scale * dW^T B^T... = 0 at B = 0
    # the update against optax's, fed the gradients the port computed (held
    # to JAX's above): Adam's first step is lr * g / (|g| + eps) and
    # Newton-Schulz is chaotic along near-null directions, so gradient
    # entries that differ in their last bits would otherwise decide the test
    grads = unflatten({path: g.numpy() for path, g in zip(paths, recorded[0])})
    updates, _ = tx.update(grads, tx.init(tree), tree)
    fed = flatten(jax.device_get(optax.apply_updates(tree, updates)))
    tol = MUON_TOL if name == "muon" else ADAMW_TOL
    for path, p in named_flax_params(adapter):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(fed[path]), rtol=tol[0], atol=tol[1],
                                   err_msg=path)
        if not b_nonzero and path.endswith("/a") and name == "muon":
            np.testing.assert_array_equal(p.detach().numpy(), flatten(tree)[path])  # a zero update
    assert all(torch.equal(t, base[n]) for n, t in tm.state_dict().items())
    assert not any(p.requires_grad for p in tm.parameters())


@pytest.mark.parametrize("shape", [(8, 64), (64, 8), (8, 192)])
def test_newton_schulz_is_bit_equal_to_jax_on_factor_gradients(shape):
    """A factor's gradient is ill-conditioned (at B = 0, dB = scale A^T dW
    has singular values over three decades), and one ulp of the norm then
    moves the update by its own size: both iterations agree bit for bit on
    100 such matrices of a factor's shape."""
    rng = np.random.default_rng(0)
    jax_ns = jax.jit(jax_optim.newton_schulz5)  # as the optimizer runs it, inside a jitted update
    for _ in range(100):
        u, _ = np.linalg.qr(rng.standard_normal((shape[0], min(shape))))
        v, _ = np.linalg.qr(rng.standard_normal((shape[1], min(shape))))
        g = ((u * np.logspace(0, -3, min(shape))) @ v.T * rng.uniform(1e-3, 1.0)).astype(np.float32)
        want = np.asarray(jax_ns(jnp.asarray(g)).astype(jnp.float32))
        np.testing.assert_array_equal(optim.newton_schulz5(torch.from_numpy(g)).float().numpy(), want)


def lora_argv(root, base, ckpt, total_steps: int, *extra):
    return ["-cn", "lora", "device=cpu", f"pretrained_path={base}", "pretrained_gamemode=0",
            f"checkpoint_path={ckpt}", *data_overrides(root, src=128, tgt=192),
            # the tiny checkpoint's vocabulary: no mapper or tag tables
            "data.mappers_path=", "data.tags_metadata_path=", f"lora.r={RANK}", f"lora.lora_alpha={ALPHA}",
            "optim.batch_size=2", "optim.grad_acc=1", f"optim.total_steps={total_steps}",
            "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0", "logging.every_steps=1",
            "logging.log_with=none", "eval.every_steps=2", "eval.steps=1", "checkpoint.every_steps=2", *extra]


def test_train_main_fine_tunes_the_gamemode_checkpoint(ors_root, tmp_path):  # noqa: F811
    """A base at ``base/`` and another at ``base/gamemode=0``: the second is
    the one trained on. The adapter it writes loads in the JAX
    ``load_lora`` with the factors the run ended with, the profiler window
    writes its trace under ``<log_dir>/profile``, and a rerun resumes."""
    base = tmp_path / "base"
    make_tiny_checkpoint(base, seed=5)
    make_tiny_checkpoint(base / "gamemode=0", seed=6)
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    argv = lora_argv(ors_root, base, ckpt, 2, 'lora_metadata.ckpt_subfolders=["gamemode=0"]',
                     "profile.do_profile=true", "profile.wait=0", "profile.warmup=0", "profile.active=1")
    state = train_main.main(argv, log_dir=str(logs))
    assert isinstance(state.model, lora.LoraAdapter) and state.step == 2 and state.optimizer.count == 2
    assert (logs / "profile" / "trace.json").exists()

    _, jparams, _ = jax_load_checkpoint(base / "gamemode=0")
    got, config = jax_lora.load_lora(ckpt / "lora", jparams)
    assert config["ckpt_subfolders"] == ["gamemode=0"] and config["r"] == RANK and config["lora_alpha"] == ALPHA
    assert config["target_modules"] == ["wq", "wkv", "wo"]  # lora.yaml's peft names
    want = {path: p.detach().numpy() for path, p in named_flax_params(state.model)}
    assert flatten(jax.device_get(got)).keys() == want.keys()
    for path, leaf in flatten(jax.device_get(got)).items():
        np.testing.assert_array_equal(np.asarray(leaf), want[path], err_msg=path)
    assert any(np.any(v != 0) for p, v in want.items() if p.endswith("/b"))  # B moved off zero
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2]
    assert any(k.startswith("test/") for r in records for k in r)  # the eval merged and ran

    # the base trained on is gamemode=0's, and it did not move
    model, _, _ = train_main.build_model_and_data(load_train_config("lora", argv[2:]), torch.device("cpu"))
    _, other, _ = jax_load_checkpoint(base)
    kernel = "params/transformer/decoder/layers_0/self_attn/wqkv/kernel"
    np.testing.assert_array_equal(model.state_dict()[torch_name(kernel)].T.numpy(),
                                  np.asarray(flatten(jparams)[kernel]))
    assert not np.array_equal(np.asarray(flatten(jparams)[kernel]), np.asarray(flatten(other)[kernel]))

    # resume: the factors and the optimizer's count come back, and one more step runs
    resumed = train_main.main(lora_argv(ors_root, base, ckpt, 2), log_dir=str(logs))
    assert resumed.step == 2 and resumed.optimizer.count == 2
    for path, p in named_flax_params(resumed.model):
        np.testing.assert_array_equal(p.detach().numpy(), want[path], err_msg=path)
    resumed = train_main.main(lora_argv(ors_root, base, ckpt, 3), log_dir=str(logs))
    assert resumed.step == 3 and resumed.optimizer.count == 3


def test_enable_lora_without_pretrained_path_raises(ors_root, tmp_path):  # noqa: F811
    argv = lora_argv(ors_root, "", tmp_path / "ckpt", 1)
    with pytest.raises(ValueError, match="pretrained_path"):
        train_main.main(argv, log_dir=str(tmp_path / "logs"))


class RecordingProfile(loop.Profile):
    events: list = []

    def __init__(self, directory, device):
        super().__init__(directory, device)
        self.events.append(("start", STEPS_RUN[0]))

    def stop(self):
        self.events.append(("stop", STEPS_RUN[0]))
        return super().stop()


STEPS_RUN = [0]


@pytest.mark.parametrize("early_stop", [False, True])
def test_profile_window_follows_the_jax_arithmetic(tmp_path, monkeypatch, early_stop):
    """wait 2, warmup 1, active 2 over 8 steps: the trace covers the steps
    that begin at 2, 3 and 4 completed steps, and is written as a Chrome
    trace; ``early_stop`` returns after the fifth."""
    monkeypatch.setattr(loop, "Profile", RecordingProfile)
    RecordingProfile.events = []
    STEPS_RUN[0] = 0
    model = torch.nn.Linear(4, 4)
    model.cfg = SimpleNamespace(backbone=None)

    def train_step(state, batch):
        STEPS_RUN[0] += 1
        with torch.profiler.record_function(f"step{STEPS_RUN[0]}"):
            model(torch.ones(1, 4))
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    args = SimpleNamespace(optim=SimpleNamespace(total_steps=8),
                           profile=SimpleNamespace(wait=2, warmup=1, active=2, early_stop=early_stop))
    state = loop.train(train_step=train_step, eval_step=None, state=TrainState(0, model, None),
                       train_batch_factory=lambda: iter(range(100)), vocab=None, args=args,
                       profile_dir=tmp_path / "profile")
    assert RecordingProfile.events == [("start", 2), ("stop", 5)]
    assert state.step == (5 if early_stop else 8)
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"step3", "step4", "step5"} <= names and not names & {"step2", "step6"}


def test_an_open_trace_stops_when_the_loop_ends(tmp_path):
    model = torch.nn.Linear(4, 4)
    model.cfg = SimpleNamespace(backbone=None)

    def train_step(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    args = SimpleNamespace(optim=SimpleNamespace(total_steps=3),
                           profile=SimpleNamespace(wait=1, warmup=8, active=8, early_stop=True))
    state = loop.train(train_step=train_step, eval_step=None, state=TrainState(0, model, None),
                       train_batch_factory=lambda: iter(range(100)), vocab=None, args=args,
                       profile_dir=tmp_path / "profile")
    assert state.step == 3 and (tmp_path / "profile" / "trace.json").exists()
    assert not torch.autograd._profiler_enabled()


def test_step_flops_under_lora(tiny):  # noqa: F811
    """The JAX figure counts the factors (its state's parameters) as the
    model; the port's numerator counts the frozen base's forward and input
    gradients, the merged targets' weight gradients and the merges."""
    _, jmodel, jparams, tm, _ = tiny
    tree = factor_tree(jparams, False)
    adapter = lora.init_lora_params(tm, rank=RANK)
    batch = batch_arrays(tm.cfg.vocab_size_in)
    want_jax = jax_loop.step_flops(SimpleNamespace(params=tree), batch, jmodel.config.backbone)
    assert loop.step_flops(adapter, batch, tm.cfg) == pytest.approx(want_jax, rel=1e-12)

    tok_enc, tok_dec = loop._batch_token_split(batch, tm.cfg)
    n_enc = sum(p.numel() for n, p in tm.named_parameters() if "encoder" in n)
    n_dec = sum(p.numel() for n, p in tm.named_parameters() if "encoder" not in n)
    targets = {path: m.in_features * m.out_features for path, m in lora.target_kernels(tm, lora.DEFAULT_TARGETS).items()}
    t_enc = sum(n for path, n in targets.items() if "encoder" in path)
    t_dec = sum(targets.values()) - t_enc
    attention = loop._attention_flops(batch, tm.cfg)
    want = (4 * (n_enc * tok_enc + n_dec * tok_dec) + 2 * (t_enc * tok_enc + t_dec * tok_dec)
            + 6 * RANK * sum(targets.values()) + attention)
    got = loop.lora_step_flops(tm, adapter, batch, tm.cfg)
    assert got == pytest.approx(want, rel=1e-12)
    # the factors are a sliver of the base: the JAX figure is nearly attention alone
    assert attention < want_jax < 1.5 * attention < got


class GaugeLogger:
    """Collects what the loop logs."""

    def __init__(self):
        self.rows = []

    def log(self, stats, step):
        self.rows.append((step, stats))


@pytest.mark.parametrize("lora_gauges", [False, True])
def test_the_loop_logs_each_flops_gauge_over_peak_times_seconds(monkeypatch, lora_gauges):
    """With a published peak, each gauge ``flops(batch)`` names is logged as
    its FLOPs over the peak times the seconds per step; without ``flops``,
    ``mfu`` is :func:`loop.step_flops` of ``state.model``."""
    monkeypatch.setattr(loop, "device_peak_flops", lambda device: 1e12)
    model = torch.nn.Linear(4, 4)
    model.cfg = MapperatorinatorConfig()
    batch = {"decoder_input_ids": np.zeros((2, 8)), "frames": np.zeros((2, 1024))}

    def train_step(state, batch):
        time.sleep(1e-3)  # a step the host clock sees
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    gauges = {"mfu": 6e9, "mfu_jax_numerator": 2e9}
    args = SimpleNamespace(optim=SimpleNamespace(total_steps=2), logging=SimpleNamespace(every_steps=1),
                           profile=SimpleNamespace(wait=0, warmup=0, active=0, early_stop=False))
    logger = GaugeLogger()
    loop.train(train_step=train_step, eval_step=None, state=TrainState(0, model, None),
               train_batch_factory=lambda: iter([batch] * 4), vocab=None, args=args, logger=logger,
               flops=(lambda b: gauges) if lora_gauges else None)
    want = gauges if lora_gauges else {"mfu": loop.step_flops(model, batch, model.cfg)}
    assert [step for step, _ in logger.rows] == [1, 2]
    for _, stats in logger.rows:
        seconds = stats["train/seconds_per_step"]
        assert {k[len("train/"):] for k in stats if k.startswith("train/mfu")} == set(want)
        for gauge, n in want.items():
            assert stats[f"train/{gauge}"] == pytest.approx(n / (1e12 * seconds), rel=1e-12)
