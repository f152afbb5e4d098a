"""DiT training on the port (``diffusion/gaussian.py``'s training half,
``diffusion/schedule_sampler.py``, ``models/params.init_dit_flax`` and
``diffusion_train.py``) against the JAX package.

JAX draws from ``jax.random`` keys, which torch cannot reproduce, so each
test replays the JAX draws through the port's sources: the noise through a
``gaussian.Source`` callable, the timesteps through a
``schedule_sampler.TimestepSource`` callable.

* ``training_losses``: the same x_start, t (0, which takes the decoder NLL
  branch, and > 0) and noise, MSE and L1: the terms, and their gradient
  with respect to the model output (the VB term sees the mean through
  ``detach``, so its gradient reaches the variance half only), at rtol
  1e-5 / atol 1e-6 (the JAX sampler tests' own 1e-5), or, where the two
  differ by more, with the port at least as close as JAX to the same
  function evaluated in float64 (the decoder NLL at t = 0 takes logs of
  tanh near saturation, where XLA's CPU tanh is a few hundred ulps from
  libm's: at x_start = -0.9995 the JAX gradient is 8.7e-4 from the float64
  one and the port's 2.5e-6);
* both schedule samplers against the JAX ``ScheduleSampler``: weights cold
  and warm, importance weights at given t, and ``update`` with duplicate
  timesteps in a batch, exactly;
* three whole steps of a tiny DiT (depth 2, hidden 64, 4 heads, 16
  positions, batch 4) against ``diffusion_train.make_diffusion_train_step``
  under both samplers: losses and the sampler's history at 2e-5, its counts
  exactly, parameters and EMA at the AdamW tolerance of
  ``tests/test_torch_train.py`` (rtol 1e-5, atol 1e-6) against the JAX
  optimizer fed the port's gradients and at atol 1e-4 against the JAX
  step's own (the test says why), but for the key third of the qkv biases
  (their exact gradient is zero, so both frameworks step along rounding
  noise);
* ``init_dit_flax``: zeros where flax zeroes, flax's lecun spread and
  truncation elsewhere;
* ``main`` with ``device=cpu`` for 2 steps on a synthesized ORS set, writing
  an EMA bundle that flax reads to the JAX model's tree and both loaders
  read; without ``device=cpu`` and without a card it raises.
"""

import json
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import diffusion_train as jax_diffusion_train
import inference as jax_inference
from mapperatorinator_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapperatorinator_tpu.diffusion.schedule_sampler import make_schedule_sampler as jax_make_sampler
from mapperatorinator_tpu.models.dit import DiT as JaxDiT
from mapperatorinator_tpu.models.dit import DiTConfig as JaxDiTConfig
from mapperatorinator_tpu.train.optim import build_schedule as jax_build_schedule
from mapperatorinator_tpu_torch import diffusion_train
from mapperatorinator_tpu_torch.diffusion import create_diffusion
from mapperatorinator_tpu_torch.diffusion.schedule_sampler import make_schedule_sampler
from mapperatorinator_tpu_torch.inference import load_diffusion_model
from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
from mapperatorinator_tpu_torch.models.params import dit_params_from_flax, dit_params_to_flax, flatten, init_dit_flax
from mapperatorinator_tpu_torch.train.optim import build_adamw_chain
from tests.test_torch_data import write_ors

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
LOSS_TOL = 2e-5
ADAMW_TOL = (1e-5, 1e-6)  # tests/test_torch_train.py
STEP_TOL = (1e-5, 1e-4)  # test_three_steps_match_the_jax_train_step says why
TINY = dict(in_channels=2, context_size=20, hidden_size=64, depth=2, num_heads=4, class_size=8)
SEQ, BATCH = 16, 4
OPTIM = SimpleNamespace(base_lr=1e-3, warmup_steps=2, sustain_steps=0, total_steps=10, lr_scheduler="cosine",
                        final_cosine=1e-5, weight_decay=0.01, grad_clip=1.0)


def replay(draw):
    """A noise source handing out ``draw``."""
    return lambda shape: torch.tensor(np.asarray(draw)).reshape(shape)


@pytest.mark.parametrize("use_l1", [False, True], ids=["mse", "l1"])
def test_training_losses_and_their_gradient_match_jax(use_l1):
    jd = jax_create_diffusion("", noise_schedule="squaredcos_cap_v2", diffusion_steps=1000, use_l1=use_l1)
    pd = create_diffusion("", noise_schedule="squaredcos_cap_v2", diffusion_steps=1000, use_l1=use_l1)
    rng = np.random.default_rng(0)
    n, t_len = 6, 12
    x_start = rng.uniform(-1.1, 1.1, (n, t_len, 2)).astype(np.float32)
    x_start[0, :3] = [[-1.0, 1.0], [0.9995, -0.9995], [0.5, 1.05]]  # both edge branches of the decoder NLL
    t = np.array([0, 1, 0, 57, 500, 999], np.int32)
    out = (0.8 * rng.standard_normal((n, t_len, 4))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = jax.random.normal(key, x_start.shape, jnp.float32)

    def jax_loss(o, name):
        terms = jd.training_losses(lambda x, tt: o + 0.1 * jnp.concatenate([x, x], -1), jnp.asarray(x_start),
                                   jnp.asarray(t), key)
        return terms[name].sum(), terms

    def port_terms(dtype):
        out_t = torch.tensor(out, dtype=dtype, requires_grad=True)
        terms = pd.training_losses(lambda x, tt: out_t + 0.1 * torch.cat([x, x], -1),
                                   torch.tensor(x_start, dtype=dtype), torch.tensor(t, dtype=torch.int64),
                                   replay(np.asarray(noise, np.float64)))
        return out_t, terms

    out_t, terms = port_terms(torch.float32)
    out64, terms64 = port_terms(torch.float64)  # the same function (fp32 tables) in float64
    base = "l1" if use_l1 else "mse"
    assert set(terms) == {base, "vb", "loss"}
    for name in (base, "vb", "loss"):
        (_, want), grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(out), name)
        (got_grad,) = torch.autograd.grad(terms[name].sum(), out_t, retain_graph=True)
        (ref_grad,) = torch.autograd.grad(terms64[name].sum(), out64, retain_graph=True)
        for got, jax_value, ref in ((terms[name].detach(), want[name], terms64[name].detach()),
                                    (got_grad, grad, ref_grad)):
            got, jax_value, ref = got.double().numpy(), np.asarray(jax_value, np.float64), ref.numpy()
            close = np.abs(got - jax_value) <= ATOL + RTOL * np.abs(jax_value)
            closer = np.abs(got - ref) <= np.abs(jax_value - ref)
            assert (close | closer).all(), (name, got[~(close | closer)], jax_value[~(close | closer)])
            assert close.mean() > 0.99, name
        if name == "vb":  # the mean half is detached: only the variance half gets a gradient
            assert not got_grad[..., :2].any() and got_grad[..., 2:].abs().sum() > 0
        if name == base:
            assert not got_grad[..., 2:].any()


def warm_state(jsampler, seed=0):
    """A history that is full for every reachable timestep."""
    rng = np.random.default_rng(seed)
    history = rng.uniform(0.05, 2.0, (jsampler.num_timesteps, jsampler.history_per_term)).astype(np.float32)
    counts = np.where(np.arange(jsampler.num_timesteps) < jsampler.support_size, jsampler.history_per_term, 0)
    return ({"history": jnp.asarray(history), "counts": jnp.asarray(counts, jnp.int32)},
            {"history": torch.tensor(history), "counts": torch.tensor(counts, dtype=torch.int64)})


def assert_state_equal(port, jax_state):
    assert set(port) == set(jax_state)
    for key in jax_state:
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(jax_state[key]), err_msg=key)


@pytest.mark.parametrize("name", ["uniform", "loss-second-moment"])
@pytest.mark.parametrize("max_timestep", [None, 30])
def test_schedule_samplers_match_jax(name, max_timestep):
    kw = dict(num_timesteps=50, max_timestep=max_timestep, history_per_term=4)
    js, ps = jax_make_sampler(name, **kw), make_schedule_sampler(name, **kw)
    assert ps.support_size == js.support_size
    jstate, pstate = js.init(), ps.init()
    assert_state_equal(pstate, jstate)
    np.testing.assert_array_equal(ps.weights(pstate).numpy(), np.asarray(js.weights(jstate)))  # cold: uniform
    if name == "loss-second-moment":
        jstate, pstate = warm_state(js)
    np.testing.assert_allclose(ps.weights(pstate).numpy(), np.asarray(js.weights(jstate)), rtol=1e-6, atol=0)

    # importance weights at the timesteps JAX draws
    jt, jiw = js.sample(jstate, jax.random.PRNGKey(1), 64)
    seen = {}

    def source(p, n):
        seen["p"] = p
        return np.array(jt)

    t, iw = ps.sample(pstate, 64, source)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(iw.numpy(), np.asarray(jiw), rtol=1e-6, atol=0)
    w = np.asarray(js.weights(jstate))
    np.testing.assert_allclose(seen["p"].numpy(), w / w.sum(), rtol=1e-6, atol=0)
    g_t, g_iw = ps.sample(pstate, 8, torch.Generator().manual_seed(0))
    assert g_t.dtype == torch.int64 and int(g_t.max()) < ps.support_size and g_iw.shape == (8,)

    # the ring history: fills, overflows within a batch, duplicates in batch order
    rng = np.random.default_rng(2)
    cold_j, cold_p = js.init(), ps.init()
    for step in range(6):
        t = rng.integers(0, js.support_size, 24)
        t[:7] = t[0]  # one timestep seven times in a batch: more than its history holds
        losses = rng.uniform(0.0, 3.0, 24).astype(np.float32)
        for label, (jst, pst) in (("cold", (cold_j, cold_p)), ("warm", (jstate, pstate))):
            jst = js.update(jst, jnp.asarray(t), jnp.asarray(losses))
            pst = ps.update(pst, torch.tensor(t), torch.tensor(losses))
            assert_state_equal(pst, jst)
            if label == "cold":
                cold_j, cold_p = jst, pst
            else:
                jstate, pstate = jst, pst
    if name == "loss-second-moment":
        np.testing.assert_allclose(ps.weights(cold_p).numpy(), np.asarray(js.weights(cold_j)), rtol=1e-6, atol=0)


def tiny_models(seed=1):
    """(JAX DiT, its params drawn N(0, 0.05) leaf by leaf, port DiT, port EMA)."""
    jmodel = JaxDiT(JaxDiTConfig(**TINY))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ, 2)), jnp.zeros((1,), jnp.int32),
                         jnp.zeros((1, SEQ, TINY["context_size"])), jnp.zeros((1, TINY["class_size"])))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(0.0, 0.05, p.shape), jnp.float32), params)
    port, ema = DiT(DiTConfig(**TINY)), DiT(DiTConfig(**TINY))
    state = dit_params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    port.load_state_dict(state)
    ema.load_state_dict(state)
    return jmodel, params, port, ema.requires_grad_(False)


def batch(seed):
    rng = np.random.default_rng(100 + seed)
    return {"x": rng.uniform(-1.0, 1.0, (BATCH, SEQ, 2)).astype(np.float32),
            "c": rng.standard_normal((BATCH, SEQ, TINY["context_size"])).astype(np.float32),
            "y": (rng.random((BATCH, TINY["class_size"])) < 0.3).astype(np.float32)}


def without_key_bias(path, x):
    if path.endswith("qkv/bias"):
        third = x.shape[0] // 3
        return np.concatenate([x[:third], x[2 * third:]])
    return x


def assert_dit_close(port, jparams, tol):
    got = flatten(dit_params_to_flax(port.state_dict()))
    for path, leaf in flatten(jax.tree_util.tree_map(np.asarray, jparams)).items():
        np.testing.assert_allclose(without_key_bias(path, got[path]), without_key_bias(path, leaf),
                                   rtol=tol[0], atol=tol[1], err_msg=path)


@pytest.mark.parametrize("sampler_name", ["uniform", "loss-second-moment"])
def test_three_steps_match_the_jax_train_step(sampler_name):
    """The port's step against the JAX one, from the same weights, batches
    and draws: the loss of every step, the sampler's history, and the
    parameters and EMA after three steps two ways. Against the JAX optimizer
    and EMA fed the gradients the port's step computed, at the AdamW
    tolerance: the clip, AdamW on every leaf and the EMA are the JAX ones.
    Against the JAX step's own parameters at atol 1e-4, a tenth of a step at
    lr 1e-3 (a wrong gradient moves entries by a whole step): a gradient
    entry within fp32 rounding of zero (about 1e-8, Adam's eps, where the
    leaf's largest is 4e-3) has last bits that differ between the
    frameworks, and Adam's g / (|g| + eps) turns them into a few percent of
    a step (measured: at most 2.7e-5 over weight seeds 1-3 and both
    samplers)."""
    max_t, ema_decay = 100, 0.9
    jd = jax_create_diffusion("", noise_schedule="squaredcos_cap_v2", diffusion_steps=1000)
    pd = create_diffusion("", noise_schedule="squaredcos_cap_v2", diffusion_steps=1000)
    js = jax_make_sampler(sampler_name, 1000, max_timestep=max_t)
    ps = make_schedule_sampler(sampler_name, 1000, max_timestep=max_t)
    jmodel, params, port, ema = tiny_models()
    tx = optax.chain(optax.clip_by_global_norm(OPTIM.grad_clip),
                     optax.adamw(jax_build_schedule(OPTIM), weight_decay=OPTIM.weight_decay))
    jstep = jax_diffusion_train.make_diffusion_train_step(jmodel, jd, tx, ema_decay=ema_decay, max_t=max_t,
                                                          sampler=js)
    port_tx = build_adamw_chain(OPTIM, port)
    recorded = []
    inner_step = port_tx.step
    port_tx.step = lambda grads: (recorded.append([g.clone() for g in grads]), inner_step(grads))
    pstep = diffusion_train.make_diffusion_train_step(port, ema, pd, port_tx, ema_decay=ema_decay, max_t=max_t,
                                                      sampler=ps)
    jema, opt_state = params, tx.init(params)
    fed, fed_ema, fed_state = params, params, tx.init(params)
    names = [name for name, _ in port.named_parameters()]
    if sampler_name == "uniform":
        jstate, pstate = js.init(), ps.init()
    else:
        jstate, pstate = warm_state(js, seed=5)

    rng = jax.random.PRNGKey(7)
    for i in range(3):
        rng, sub = jax.random.split(rng)
        rng_t, rng_noise = jax.random.split(sub)
        b = batch(i)
        if sampler_name == "uniform":
            jt = jax.random.randint(rng_t, (BATCH,), 0, max_t)
        else:
            jt = js.sample(jstate, rng_t, BATCH)[0]
        noise = jax.random.normal(rng_noise, b["x"].shape, jnp.float32)
        params, jema, opt_state, jloss, jstate = jstep(params, jema, opt_state,
                                                       {k: jnp.asarray(v) for k, v in b.items()}, sub, jstate)
        loss, pstate = pstep({k: torch.tensor(v) for k, v in b.items()}, pstate, lambda p, n: np.array(jt),
                             replay(noise))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_TOL, atol=0, err_msg=f"step {i}")
        if sampler_name != "uniform":
            assert_state_equal({"counts": pstate["counts"]}, {"counts": jstate["counts"]})
            np.testing.assert_allclose(pstate["history"].numpy(), np.asarray(jstate["history"]), rtol=LOSS_TOL,
                                       atol=0)
        grads = dit_params_to_flax(dict(zip(names, recorded[-1])))
        updates, fed_state = tx.update(grads, fed_state, fed)
        fed = optax.apply_updates(fed, updates)
        fed_ema = jax.tree_util.tree_map(lambda e, p: e * ema_decay + p * (1 - ema_decay), fed_ema, fed)
    assert_dit_close(port, fed, ADAMW_TOL)
    assert_dit_close(ema, fed_ema, ADAMW_TOL)
    assert_dit_close(port, params, STEP_TOL)
    assert_dit_close(ema, jema, STEP_TOL)


def test_init_dit_flax_draws_as_flax():
    cfg = dict(TINY, hidden_size=128, context_size=272, class_size=48)
    jparams = JaxDiT(JaxDiTConfig(**cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ, 2)),
                                               jnp.zeros((1,), jnp.int32), jnp.zeros((1, SEQ, 272)),
                                               jnp.zeros((1, 48)))
    want = flatten(jax.tree_util.tree_map(np.asarray, jparams))
    port = DiT(DiTConfig(**cfg))
    init_dit_flax(port, 0)
    got = flatten(dit_params_to_flax(port.state_dict()))
    assert set(got) == set(want)
    zeros = [path for path, leaf in want.items() if not leaf.any()]
    assert {"params/blocks_0/adaln/kernel", "params/final_layer/adaln/kernel", "params/final_layer/proj/kernel",
            "params/final_layer/proj/bias", "params/blocks_1/qkv/bias"} <= set(zeros)
    for path, leaf in want.items():
        if not leaf.any():
            assert not got[path].any(), path
            continue
        fan_in = leaf.shape[0]
        assert path.endswith("/kernel") and leaf.ndim == 2, path
        # lecun normal truncated at two standard deviations of the underlying normal
        bound = 2 * fan_in**-0.5 / 0.87962566103423978
        assert np.abs(got[path]).max() <= bound * (1 + 1e-6), path
        if leaf.size >= 4096:
            assert abs(got[path].std() / (fan_in**-0.5) - 1) < 0.05, path
            assert abs(leaf.std() / (fan_in**-0.5) - 1) < 0.05, path
    again = DiT(DiTConfig(**cfg))
    init_dit_flax(again, 0)
    assert all(torch.equal(a, b) for a, b in zip(port.state_dict().values(), again.state_dict().values()))
    x = torch.zeros((2, SEQ, 2))
    out = port(x, torch.tensor([3, 40]), torch.zeros((2, SEQ, 272)), torch.zeros((2, 48)))
    assert not out.any()  # flax's start: eps = 0 and every block the identity


def test_main_trains_on_cpu_and_writes_a_bundle_both_packages_read(tmp_path, monkeypatch):
    ors = write_ors(tmp_path / "ors", tracks=2, seconds=8.0, maps=1, objects=16)
    monkeypatch.chdir(tmp_path)
    argv = ["-cn", "v1", "model.model=DiT-T", "data.seq_len=8", "data.stride=4", f"data.train_dataset_path={ors}",
            "data.start=0", "data.end=2", "optim.batch_size=2", "optim.total_steps=2", "optim.warmup_steps=1",
            "logging.every_steps=1", "logging.log_with=none", f"checkpoint_path={tmp_path / 'ckpt'}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card and no device=cpu: no CPU fallback
        diffusion_train.main(argv)
    model, ema = diffusion_train.main([*argv, "device=cpu"])
    logged = [json.loads(line) for line in (tmp_path / "logs" / "diffusion" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in logged] == [1, 2] and all(np.isfinite(r["train/loss"]) for r in logged)
    assert not all(torch.equal(a, b) for a, b in zip(model.parameters(), ema.parameters()))

    final = tmp_path / "ckpt" / "final"
    cfg = json.loads((final / "dit_config.json").read_text())
    jmodel = JaxDiT(JaxDiTConfig(**cfg))
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 2)), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 8, cfg["context_size"])), jnp.zeros((1, cfg["class_size"])))
    restored = flax.serialization.from_bytes(template, (final / "params.msgpack").read_bytes())
    want = flatten(dit_params_to_flax(ema.state_dict()))
    got = flatten(jax.tree_util.tree_map(np.asarray, restored))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)

    loaded = load_diffusion_model(str(final), torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), ema.state_dict().values()))
    jax_loaded, jax_params = jax_inference.load_diffusion_model(str(final))
    for path, leaf in flatten(jax.tree_util.tree_map(np.asarray, jax_params)).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    assert jax_loaded.config.class_size == cfg["class_size"] == 48
