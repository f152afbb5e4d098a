"""The port's training core against the JAX package's, on the tiny
v32-architecture checkpoint, in fp32.

* the flax paths the port derives for its parameters, and the optimizer
  masks on them, leaf for leaf;
* the LR schedule at the points of test_train.py;
* ``muon``, ``adamwscale`` and ``adamw`` for 3 steps on the tiny tree (conv
  stem and non-square matrices included) against the optax ones, at the
  bars of test_train.py: Muon's matrices 2e-2 / 2e-4 (its Newton-Schulz
  runs in bf16), the AdamW branch 1e-4 / 1e-6, ``adamwscale`` and ``adamw``
  1e-5 / 1e-6;
* clipping and ``grad_acc`` against ``optax.MultiSteps``;
* the loss and every gradient against ``jax.value_and_grad`` at the model
  bar (2e-4, test_model.py:77), with sample weights and ignored labels;
* the parameters after 3 steps of ``make_train_step`` against the JAX step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu.train.step import init_train_state, make_train_step as jax_make_train_step
from mapperatorinator_tpu.train.step import wrap_grad_acc
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.params import flatten, flax_layout, flax_paths, torch_name, unflatten
from mapperatorinator_tpu_torch.train import optim
from mapperatorinator_tpu_torch.train.step import TrainState, make_train_step, named_flax_params
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)

MODEL_TOL = 2e-4  # test_model.py:77
MUON_TOL = (2e-2, 2e-4)  # test_train.py:91, Newton-Schulz in bf16
ADAMW_BRANCH_TOL = (1e-4, 1e-6)  # test_train.py:92
ADAMW_TOL = (1e-5, 1e-6)  # test_train.py:57
# v32's learning rates (configs/train/v32.yaml), with a short warmup and sustain
OPTIM_ARGS = ["optim.total_steps=50", "optim.warmup_steps=2", "optim.sustain_steps=1", "optim.lr_scheduler=cosine",
              "optim.weight_decay=0.01", "optim.base_lr=0.002", "optim.base_lr_2=0.001", "optim.grad_acc=1",
              "optim.grad_clip=0"]


def configs(overrides):
    jax_args = compose(REPO_ROOT / "configs" / "train", "v32", overrides=list(overrides),
                       schema_cls=schema.TrainConfig)
    return jax_args, load_train_config("v32", overrides)


def port_model(tiny, **cfg_changes):  # noqa: F811
    _, jmodel, jparams, tmodel, _ = tiny
    jm = JaxMapperatorinator(dataclasses.replace(jmodel.config, **cfg_changes))
    tm = Mapperatorinator(dataclasses.replace(tmodel.cfg, **cfg_changes))
    tm.load_state_dict(tmodel.state_dict())
    return jm, jparams, tm


def assert_tree_close(tm, jparams, tol_of, keep=lambda path, x: x):
    """Every port parameter, in the flax layout, against its flax leaf
    (``keep`` selects the part of a leaf that is compared)."""
    state = dict(tm.named_parameters())
    for path, leaf in flatten(jax.device_get(jparams)).items():
        got = flax_layout(state[torch_name(path)].detach(), path).numpy()
        rtol, atol = tol_of(path, np.asarray(leaf))
        np.testing.assert_allclose(keep(path, got), keep(path, np.asarray(leaf)), rtol=rtol, atol=atol,
                                   err_msg=path)


def without_key_biases(path, x):
    """A leaf less the key part of the fused qkv / kv biases. Their exact
    gradient is zero (softmax ignores a shift shared by a row's logits), so
    both frameworks compute rounding noise there, and an Adam step follows
    the noise's sign."""
    if path.endswith("wqkv/bias"):
        inner = x.shape[0] // 3
        return np.concatenate([x[:inner], x[2 * inner:]])
    if path.endswith("wkv/bias"):
        return x[x.shape[0] // 2:]
    return x


def test_flax_paths_invert_the_parameter_table(tiny):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    want = {torch_name(path): path for path in flatten(jparams)}
    assert flax_paths(tmodel) == want
    assert [p for p, _ in named_flax_params(tmodel)] == [want[n] for n, _ in tmodel.named_parameters()]


def test_masks_match_jax_leaf_for_leaf(tiny):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    decay = flatten(jax_optim.decay_mask(jparams))
    branch = flatten(jax_optim.muon_branch_mask(jparams))
    for path, p in named_flax_params(tmodel):
        assert optim.decay_mask(path) == decay[path], path
        assert optim.muon_branch_mask(path, p) == branch[path], path
    assert any(branch.values()) and not all(branch.values()) and not all(decay.values())


@pytest.mark.parametrize("shape", [(64, 128), (192, 64), (3, 4096)])
def test_newton_schulz_is_bit_equal_to_jax(shape):
    """bf16 coefficients and a bf16 norm, as in the JAX trace: on the CPU the
    two iterations agree bit for bit (the conv stem's (3, in * out) included)."""
    g = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_optim.newton_schulz5(jnp.asarray(g)).astype(jnp.float32))
    np.testing.assert_array_equal(optim.newton_schulz5(torch.from_numpy(g)).float().numpy(), want)


@pytest.mark.parametrize("scheduler", ["cosine", "linear"])
def test_schedule_matches_jax(scheduler):
    overrides = ["optim.base_lr=0.01", "optim.warmup_steps=100", "optim.sustain_steps=50",
                 "optim.total_steps=1000", f"optim.lr_scheduler={scheduler}", "optim.final_cosine=1e-5"]
    jax_args, args = configs(overrides)
    want, got = jax_optim.build_schedule(jax_args.optim), optim.build_schedule(args.optim)
    for count in (0, 1, 50, 99, 100, 101, 125, 149, 150, 151, 500, 999, 1000, 1200):
        # the optax schedule computes in fp32: about 1e-9 absolute at lr 1e-2
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-9), count


def random_grads(jparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape)).astype(np.float32), jax.device_get(jparams))


def port_grads(tm, grads_tree):
    flat = flatten(grads_tree)
    return [flax_layout(torch.from_numpy(flat[path]), path).contiguous() for path, _ in named_flax_params(tm)]


def run_both(tiny, name, overrides, steps=3):  # noqa: F811
    jax_args, args = configs(OPTIM_ARGS + [f"optim.name={name}"] + overrides)
    _, jparams, tm = port_model(tiny)
    tx = wrap_grad_acc(jax_optim.build_optimizer(jax_args), jax_args.optim.grad_acc)
    params, opt_state = jparams, tx.init(jparams)
    port_tx = optim.build_optimizer(args, named_flax_params(tm))
    update = jax.jit(tx.update)
    for i in range(steps):
        grads = random_grads(jparams, seed=i)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_tx.step(port_grads(tm, grads))
    return params, tm, port_tx


def test_muon_matches_optax(tiny):  # noqa: F811
    params, tm, _ = run_both(tiny, "muon", [])
    branch = flatten(jax_optim.muon_branch_mask(params))
    assert_tree_close(tm, params, lambda path, x: MUON_TOL if branch[path] else ADAMW_BRANCH_TOL)


@pytest.mark.parametrize("name", ["adamwscale", "adamw"])
def test_adamw_variants_match_optax(tiny, name):  # noqa: F811
    params, tm, _ = run_both(tiny, name, [])
    assert_tree_close(tm, params, lambda path, x: ADAMW_TOL)


def test_adamw_without_a_mask_decays_every_leaf_as_optax(tiny):  # noqa: F811
    """``AdamW(mask=None)``, the optimizer of the diffusion, classifier and
    rhythm-complexion trainers, against ``optax.adamw`` without a mask at
    weight decay 0.01: every leaf decays, the biases and norm scales that
    ``decay_mask`` spares included."""
    jax_args, args = configs(OPTIM_ARGS + ["optim.name=adamw"])
    assert args.optim.weight_decay == 0.01
    _, jparams, tm = port_model(tiny)
    tx = optax.adamw(jax_optim.build_schedule(jax_args.optim), weight_decay=jax_args.optim.weight_decay)
    port_tx = optim.AdamW(named_flax_params(tm), optim.build_schedule(args.optim), args.optim.weight_decay,
                          mask=None)
    assert all(port_tx.decay) and not all(optim.decay_mask(path) for path in port_tx.paths)
    params, opt_state = jparams, tx.init(jparams)
    for i in range(3):
        grads = random_grads(jparams, seed=i)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        port_tx.step(port_grads(tm, grads))
    assert_tree_close(tm, params, lambda path, x: ADAMW_TOL)


def test_clipping_and_grad_acc_match_multisteps(tiny):  # noqa: F811
    """grad_acc=2 over 5 micro-steps (two updates, one accumulation left
    over), clipping at a norm the averaged gradients exceed."""
    params, tm, port_tx = run_both(tiny, "adamwscale", ["optim.grad_acc=2", "optim.grad_clip=0.5"], steps=5)
    assert port_tx.count == 2 and port_tx.mini_step == 1
    assert_tree_close(tm, params, lambda path, x: ADAMW_TOL)


def batch_arrays(vocab_in: int, seed: int = 0, rows: int = 2, length: int = 48):
    """White-noise audio: every encoder frame differs, so the gradient
    matrices are well conditioned. (A steady tone makes the cross-attention
    outputs of all positions alike and its gradients nearly rank one, and
    Newton-Schulz in bf16 then orthogonalises rounding noise.)"""
    rng = np.random.default_rng(seed)
    frames = (0.3 * rng.standard_normal((rows, (SRC_SEQ_LEN - 1) * 128))).astype(np.float32)
    ids = rng.integers(3, vocab_in, (rows, length)).astype(np.int64)
    mask = np.ones((rows, length), np.int64)
    ids[1, -6:], mask[1, -6:] = 0, 0  # right padding, as the data pipeline pads
    labels = rng.integers(3, 600, (rows, length)).astype(np.int64)
    labels[mask == 0] = -100
    labels[0, :5] = -100
    return {"frames": frames, "decoder_input_ids": ids, "decoder_attention_mask": mask, "labels": labels,
            "sample_weights": np.array([0.5, 1.7], np.float32)}


def test_loss_and_gradients_match_jax(tiny):  # noqa: F811
    """rhythm_weight 3 and label smoothing 0.1, so both weightings count."""
    jm, jparams, tm = port_model(tiny, rhythm_weight=3.0, label_smoothing=0.1)
    batch = batch_arrays(tm.cfg.vocab_size_in)

    def jax_loss(params):
        return jm.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)[1]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jparams)
    _, loss = tm(**{k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=MODEL_TOL, atol=MODEL_TOL)
    grads = dict((name, p.grad) for name, p in tm.named_parameters())
    for path, want in flatten(jax.device_get(want_grads)).items():
        got = flax_layout(grads[torch_name(path)], path).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)


@pytest.mark.parametrize("name", ["muon", "adamwscale"])
def test_train_steps_match_jax(tiny, name):  # noqa: F811
    """Three steps of ``make_train_step`` against the JAX step: the metrics at
    every step, and the parameters at the end.

    For Muon the parameters are held against the JAX optimizer fed the
    gradients the port's step computed (which test_loss_and_gradients_match_jax
    holds to the JAX ones at the model bar): given equal gradients its
    Newton-Schulz is bit-equal on the CPU, but from gradients that differ in
    their last bits it is chaotic wherever a gradient matrix has a near-null
    direction (the keys of a softmax row share a free shift), and a few
    entries of an update move by its own size."""
    jax_args, args = configs(OPTIM_ARGS + [f"optim.name={name}", "optim.grad_clip=1.0"])
    jm, jparams, tm = port_model(tiny)
    tx = wrap_grad_acc(jax_optim.build_optimizer(jax_args), jax_args.optim.grad_acc)
    jstep = jax_make_train_step(jm, tx)
    jstate = init_train_state(jparams, tx)
    fed_params, fed_state, fed_update = jparams, tx.init(jparams), jax.jit(tx.update)
    state = TrainState(step=0, model=tm, optimizer=optim.build_optimizer(args, named_flax_params(tm)))
    recorded = []
    inner_step = state.optimizer.step
    state.optimizer.step = lambda grads: (recorded.append([g.clone() for g in grads]), inner_step(grads))
    step = make_train_step()
    paths = [p for p, _ in named_flax_params(tm)]
    # one batch, three times: on fresh random batches the AdamW branch's
    # normalisation m / sqrt(v) would magnify, where gradients of successive
    # steps cancel, the bf16 Newton-Schulz difference of the first update
    batch = batch_arrays(tm.cfg.vocab_size_in)
    for i in range(3):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        state, metrics = step(state, batch)
        # after a Muon update the two models differ by its bf16 Newton-Schulz
        rtol = MUON_TOL[0] if name == "muon" and i > 0 else MODEL_TOL
        for key in ("loss", "grad_l2"):
            np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=rtol, err_msg=key)
        grads = unflatten({p: flax_layout(g, p).numpy() for p, g in zip(paths, recorded[-1])})
        updates, fed_state = fed_update(grads, fed_state, fed_params)
        fed_params = optax.apply_updates(fed_params, updates)
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(metrics["weights_l2"].item(), float(jmetrics["weights_l2"]), rtol=1e-5)
    if name == "muon":
        branch = flatten(jax_optim.muon_branch_mask(jparams))
        assert_tree_close(tm, fed_params, lambda path, x: MUON_TOL if branch[path] else ADAMW_BRANCH_TOL)
    else:
        assert_tree_close(tm, jstate.params, lambda path, x: ADAMW_TOL, without_key_biases)
