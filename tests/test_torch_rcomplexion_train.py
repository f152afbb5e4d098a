"""Rhythm-complexity training on the port (``rcomplexion_train.py``) against
the JAX trainer, with OsuR at small widths (a window of 8 tokens, hidden
16) from the JAX initialisation through the parameter bridge.

* three steps against the JAX chain (``chain(clip_by_global_norm, adamw)``,
  weight decay 0.01 on every leaf, as ``rcomplexion_train.py:main`` builds
  it): the loss of every step within 2e-4 (tests/test_model.py:77), the
  parameters at the AdamW tolerance of ``tests/test_torch_train.py`` (rtol
  1e-5, atol 1e-6) against the JAX chain fed the port's gradients and at
  atol 1e-4 (a tenth of a step at lr 1e-3: Adam turns the last bits of a
  gradient entry within rounding of zero into a few percent of a step)
  against the JAX step's own;
* the eval step's loss and accuracy equal to the JAX ``eval_step``'s;
* ``main`` for 3 steps with an eval writes ``final/params.msgpack``, which
  the JAX ``rcomplexion_inference.main`` and the port's read to the same
  complexities; without ``device=cpu`` and without a card it raises.
"""

import csv
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rcomplexion_inference as jax_rc_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.classifier import OsuR as JaxOsuR
from mapperatorinator_tpu.models.classifier import OsuRConfig as JaxOsuRConfig
from mapperatorinator_tpu.rcomplexion import RTokenizer as JaxRTokenizer
from mapperatorinator_tpu.train.optim import build_schedule as jax_build_schedule
from mapperatorinator_tpu_torch import rcomplexion_inference, rcomplexion_train
from mapperatorinator_tpu_torch.config import load_rcomplexion_config
from mapperatorinator_tpu_torch.models.classifier import OsuR, OsuRConfig
from mapperatorinator_tpu_torch.models.params import flatten, flax_layout, params_from_flax, torch_name, unflatten
from mapperatorinator_tpu_torch.train.optim import build_adamw_chain
from mapperatorinator_tpu_torch.train.step import named_flax_params
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_torch_data import write_ors
from tests.test_torch_train import ADAMW_TOL

torch.set_num_threads(1)

TOL = 2e-4
STEP_TOL = (1e-5, 1e-4)  # the module docstring says why
SMALL = ["data.src_seq_len=8", "model.hidden_size=16", "optim.base_lr=0.001", "optim.warmup_steps=1",
         "optim.total_steps=3", "optim.weight_decay=0.01", "optim.grad_clip=1.0"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(ORS root, overrides, JAX config, JAX model, its params)."""
    root = tmp_path_factory.mktemp("rc_train")
    ors = write_ors(root / "ors", tracks=2, seconds=8.0, maps=2, objects=24)
    overrides = [f"data.train_dataset_path={ors}", "data.train_dataset_start=0", "data.train_dataset_end=2",
                 f"data.test_dataset_path={ors}", "data.test_dataset_start=0", "data.test_dataset_end=2", *SMALL]
    jargs = compose(REPO_ROOT / "configs" / "rcomplexion", "train_v1", overrides=overrides,
                    schema_cls=schema.RcomplexionConfig)
    tokenizer = JaxRTokenizer(jargs)
    model = JaxOsuR(JaxOsuRConfig(vocab_size_in=tokenizer.vocab_size_in, vocab_size_out=tokenizer.vocab_size_out,
                                  src_seq_len=8, hidden_size=16))
    params = model.init(jax.random.PRNGKey(5), jnp.zeros((1, 8), jnp.int32))
    return ors, overrides, jargs, model, params


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(params))


def batches(cfg, n: int, rows: int = 16):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, cfg.vocab_size_in, (rows, 8)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab_size_out, rows).astype(np.int64)} for _ in range(n)]


def assert_close_tree(model, jparams, tol):
    state = dict(model.named_parameters())
    for path, leaf in flatten(numpy_tree(jparams)).items():
        got = flax_layout(state[torch_name(path)].detach(), path).numpy()
        np.testing.assert_allclose(got, leaf, rtol=tol[0], atol=tol[1], err_msg=path)


def test_steps_and_eval_match_the_jax_trainer(setup):
    _, overrides, jargs, jmodel, params = setup
    cfg = jmodel.config
    args = load_rcomplexion_config("train_v1", overrides)
    model = OsuR(OsuRConfig(vocab_size_in=cfg.vocab_size_in, vocab_size_out=cfg.vocab_size_out, src_seq_len=8,
                            hidden_size=16))
    model.load_state_dict(params_from_flax(numpy_tree(params)))
    tx = optax.chain(optax.clip_by_global_norm(jargs.optim.grad_clip),
                     optax.adamw(jax_build_schedule(jargs.optim), weight_decay=jargs.optim.weight_decay))

    @jax.jit
    def jax_step(params, opt_state, batch):  # rcomplexion_train.py:main's train_step
        def loss_fn(p):
            return jmodel.apply(p, batch["input_ids"], labels=batch["labels"])["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def jax_eval(params, batch):  # its eval_step
        out = jmodel.apply(params, batch["input_ids"], labels=batch["labels"])
        return out["loss"], (out["logits"].argmax(-1) == batch["labels"]).mean()

    port_tx = build_adamw_chain(args.optim, model)
    recorded = []
    inner_step = port_tx.step
    port_tx.step = lambda grads: (recorded.append([g.clone() for g in grads]), inner_step(grads))
    step = rcomplexion_train.make_train_step(model, port_tx)
    paths = [path for path, _ in named_flax_params(model)]
    jparams, opt_state = params, tx.init(params)
    fed, fed_state = params, tx.init(params)
    for b in batches(cfg, 3):
        jparams, opt_state, jloss = jax_step(jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        loss = step({k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
        grads = unflatten({p: flax_layout(g, p).numpy() for p, g in zip(paths, recorded[-1])})
        updates, fed_state = tx.update(grads, fed_state, fed)
        fed = optax.apply_updates(fed, updates)
    assert port_tx.count == 3
    assert_close_tree(model, fed, ADAMW_TOL)
    assert_close_tree(model, jparams, STEP_TOL)

    for b in batches(cfg, 2, rows=64):
        want = [float(x) for x in jax_eval(jparams, {k: jnp.asarray(v) for k, v in b.items()})]
        got = rcomplexion_train.eval_step(model, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(got[0], want[0], rtol=TOL, atol=TOL)
        assert got[1] == want[1]


def complexities(path):
    with open(path, newline="", encoding="utf-8") as f:
        return {row[0]: float(row[1]) for row in csv.reader(f) if row and row[0] != "beatmap_path"}


def test_main_exports_what_both_inference_scripts_read(setup, tmp_path, monkeypatch):
    _, overrides, _, _, _ = setup
    monkeypatch.chdir(tmp_path)
    argv = ["-cn", "train_v1", *overrides, "optim.batch_size=8", "logging.every_steps=1", "logging.log_with=none",
            "eval.every_steps=3", "eval.steps=2", f"checkpoint_path={tmp_path / 'ckpt'}"]
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card and no device=cpu: no CPU fallback
        rcomplexion_train.main(argv)
    model = rcomplexion_train.main([*argv, "device=cpu"])
    logged = [json.loads(line) for line in (tmp_path / "logs" / "rcomplexion" / "metrics.jsonl").read_text()
              .splitlines()]
    assert [r["step"] for r in logged if "train/loss" in r] == [1, 2, 3]
    assert [(r["step"], sorted(r)) for r in logged if "val/loss" in r] == [(3, ["step", "val/accuracy", "val/loss"])]

    final = tmp_path / "ckpt" / "final"
    infer = [f"model_path={final}", *overrides[:3]]
    jax_rc_inference.main(["-cn", "inference_v1", *infer, "data.src_seq_len=8", "model.hidden_size=16"])
    want = complexities(tmp_path / "rhythm_complexities.csv")
    (tmp_path / "rhythm_complexities.csv").unlink()
    rcomplexion_inference.main(["-cn", "inference_v1", *infer, "data.src_seq_len=8", "model.hidden_size=16",
                                "device=cpu"])
    got = complexities(tmp_path / "rhythm_complexities.csv")
    assert set(got) == set(want) and len(got) == 4
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)
    restored = flatten(numpy_tree(flax.serialization.msgpack_restore((final / "params.msgpack").read_bytes())))
    state = dict(model.named_parameters())
    for path, leaf in restored.items():
        np.testing.assert_array_equal(flax_layout(state[torch_name(f"params/{path}" if not path.startswith("params/")
                                                                  else path)].detach(), path).numpy(), leaf)
