"""Three train steps of every other backbone family on the port against the
JAX train step, on ``tests/test_torch_backbone_train.py``'s tiny fp32
models (whisper_abs of ``-cn v28``, T5 of ``t5_base``, nGPT of
``nwhisper_base``, moonshine of ``moonshine_tiny``), each from the JAX
``model.init`` parameters: ``make_train_step`` with the recipe's optimizer
(``adamwscale``: no shipped recipe of these families selects ``muon``), its
clipping on, against the JAX step at ``tests/test_torch_train.py``'s bars:
the loss and gradient norm at every step, the parameters at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu.train.step import init_train_state, make_train_step as jax_make_train_step
from mapperatorinator_tpu.train.step import wrap_grad_acc
from mapperatorinator_tpu_torch.models.params import flax_layout, unflatten
from mapperatorinator_tpu_torch.train import optim
from mapperatorinator_tpu_torch.train.step import TrainState, make_train_step, named_flax_params
from tests.test_torch_backbone_train import FAMILIES, batch_arrays, family, port_model
from tests.test_torch_train import ADAMW_TOL, MODEL_TOL, assert_tree_close, without_key_biases

# the recipes' optimizer, with a short warmup (the cosine decay needs steps after it) and clipping on
OPTIM_ARGS = ("optim.total_steps=50", "optim.warmup_steps=2", "optim.grad_acc=1", "optim.grad_clip=1.0")

# the families whose parameters after the steps are held to the JAX step's directly; T5's only to the JAX optimizer
# fed the port's gradients (test_train_steps_match_jax says why)
DIRECT = ("v28", "nwhisper_base", "moonshine_tiny")


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_train_steps_match_jax(name):
    """Three steps of ``make_train_step`` with the recipe's ``adamwscale``
    against the JAX step on one batch: the loss and gradient norm at every
    step, and the parameters at the end, against the JAX optimizer fed the
    gradients the port's step computed (every family) and against the JAX
    step's own (``DIRECT``).

    T5's tiny model is not held to the JAX step's parameters directly, for
    the reason ``tests/test_torch_train.py`` gives for Muon: its unscaled
    attention over unit-variance embeddings gives gradients whose fp32
    rounding is a few percent of some small entries (both frameworks' fp32
    gradients differ from an fp64 one by up to 7e-6), and Adam's
    per-entry normalisation m / sqrt(v) passes that on to the update."""
    jax_args, _, _, _, _ = family(name, OPTIM_ARGS)
    jm, jparams, args, tm = port_model(name, OPTIM_ARGS)
    assert args.optim.name == jax_args.optim.name == "adamwscale"
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
    batch = batch_arrays(tm.cfg)
    for _ in range(3):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        state, metrics = step(state, batch)
        for key in ("loss", "grad_l2"):
            np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=MODEL_TOL, err_msg=key)
        grads = unflatten({p: flax_layout(g, p).numpy() for p, g in zip(paths, recorded[-1])})
        updates, fed_state = fed_update(grads, fed_state, fed_params)
        fed_params = optax.apply_updates(fed_params, updates)
    assert state.step == int(jstate.step) == 3
    np.testing.assert_allclose(metrics["weights_l2"].item(), float(jmetrics["weights_l2"]), rtol=1e-5)
    assert_tree_close(tm, fed_params, lambda path, x: ADAMW_TOL)
    if name in DIRECT:
        assert_tree_close(tm, jstate.params, lambda path, x: ADAMW_TOL, without_key_biases)
