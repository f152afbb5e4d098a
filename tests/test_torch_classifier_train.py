"""Mapper-classifier training on the port (``classifier_train.py``) against
the JAX trainer, at tiny widths (2 + 2 layers, d_model 64, 4 heads, 64
source frames, 32 target tokens), from the JAX initialisation through the
parameter bridge.

* four micro-steps at ``grad_acc`` 2 against the JAX chain
  (``MultiSteps(chain(clip_by_global_norm, adamw))``, weight decay 0.01 on
  every leaf, as ``classifier_train.py:main`` builds it) on seeded batches
  with padded token rows: the loss of every micro-step within 2e-4 times
  its size (tests/test_model.py:77); the parameters after both updates at
  the AdamW tolerance of ``tests/test_torch_train.py`` (rtol 1e-5, atol
  1e-6) against the JAX chain fed the port's gradients, and at atol 1e-4 (a
  tenth of a step at lr 1e-3) against the JAX step's own, but for the key
  part of the fused qkv / kv biases (their exact gradient is zero); the
  gradients of the first micro-step at the model bar (2e-4);
* the eval step's loss and top-1 / top-10 / top-100 accuracy (k capped at
  the class count) equal to the JAX ``eval_step``'s;
* ``pretrained_path``: ``main`` grafts the towers of the tiny generation
  checkpoint as the JAX ``transfer_from_pretrained`` does (its bundle after
  one micro-step of two, before the first update);
* ``main`` for 2 micro-steps writes a bundle that ``load_classifier_bundle``
  and the JAX ``calc_fid.load_classifier`` read to the same features, and
  its ``val/*`` metrics; without ``device=cpu`` and without a card it raises;
* ``init_flax_params`` draws the classifier's and OsuR's leaves as their
  flax initialisers do (constants equal, spreads within 5%).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import calc_fid as jax_calc_fid
from mapperatorinator_tpu.models.classifier import transfer_from_pretrained as jax_transfer
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu.train.optim import build_schedule as jax_build_schedule
from mapperatorinator_tpu_torch import classifier_train
from mapperatorinator_tpu_torch.classifier_test import eval_step
from mapperatorinator_tpu_torch.config import load_classifier_config
from mapperatorinator_tpu_torch.models.classifier import build_classifier, load_classifier_bundle
from mapperatorinator_tpu_torch.models.params import flatten, flax_layout, params_from_flax, torch_name, unflatten
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.train.optim import build_adamw_chain
from mapperatorinator_tpu_torch.train.step import named_flax_params
from tests.fixtures.tiny_checkpoint import make_tiny_checkpoint
from tests.test_torch_classifier import HOP, close, jax_classifier, tiny_overrides, to_numpy, write_tiny_ors
from tests.test_torch_train import ADAMW_TOL, MODEL_TOL, without_key_biases

torch.set_num_threads(1)

STEP_TOL = (1e-5, 1e-4)  # the module docstring says why
OPTIM = ["optim.base_lr=0.001", "optim.warmup_steps=2", "optim.total_steps=20", "optim.weight_decay=0.01",
         "optim.grad_clip=1.0", "optim.grad_acc=2"]


@pytest.fixture(scope="module")
def ors(tmp_path_factory):
    return write_tiny_ors(tmp_path_factory.mktemp("clf_train_ors"))


def batches(vocab_in: int, classes: int, n: int, rows: int = 3):
    """Seeded batches: loud white-noise audio, token rows padded at their
    ends (one row half pads), a mapper label each."""
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab_in, (rows, 32)).astype(np.int64)
        ids[1, 20:] = 0
        ids[2, 16:] = 0
        out.append({"frames": (8.0 * rng.standard_normal((rows, HOP * 63))).astype(np.float32),
                    "decoder_input_ids": ids, "decoder_attention_mask": ids != 0,
                    "labels": rng.integers(0, classes, rows).astype(np.int64)})
    return out


def port_classifier(overrides, params):
    args = load_classifier_config("train_v1", overrides)
    vocab = build_vocabulary(args)
    model = build_classifier(args, vocab)
    model.load_state_dict(params_from_flax(to_numpy(params)))
    return args, vocab, model


def assert_close_tree(model, jparams, tol):
    state = dict(model.named_parameters())
    for path, leaf in flatten(to_numpy(jparams)).items():
        got = flax_layout(state[torch_name(path)].detach(), path).numpy()
        np.testing.assert_allclose(without_key_biases(path, got), without_key_biases(path, np.asarray(leaf)),
                                   rtol=tol[0], atol=tol[1], err_msg=path)


def test_micro_steps_match_the_jax_chain(ors):
    overrides = tiny_overrides(ors, *OPTIM)
    jargs, jvocab, jmodel, params = jax_classifier(overrides, seed=2)
    args, vocab, model = port_classifier(overrides, params)
    classes = jvocab.num_mapper_classes
    tx = optax.MultiSteps(optax.chain(optax.clip_by_global_norm(jargs.optim.grad_clip),
                                      optax.adamw(jax_build_schedule(jargs.optim),
                                                  weight_decay=jargs.optim.weight_decay)),
                          every_k_schedule=jargs.optim.grad_acc)

    @jax.jit
    def jax_step(params, opt_state, batch):  # classifier_train.py:main's train_step
        def loss_fn(p):
            return jmodel.apply(p, batch["frames"], batch["decoder_input_ids"],
                                decoder_attention_mask=batch["decoder_attention_mask"], labels=batch["labels"])["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    port_tx = build_adamw_chain(args.optim, model, grad_acc=args.optim.grad_acc)
    recorded = []
    inner_step = port_tx.step
    port_tx.step = lambda grads: (recorded.append([g.clone() for g in grads]), inner_step(grads))
    step = classifier_train.make_train_step(model, port_tx)
    paths = [path for path, _ in named_flax_params(model)]
    jparams, opt_state = params, tx.init(params)
    fed, fed_state = params, tx.init(params)
    for i, b in enumerate(batches(vocab.vocab_size_in, classes, 4)):
        jparams, opt_state, jloss, jgrads = jax_step(jparams, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
        loss = step({k: torch.as_tensor(v) for k, v in b.items()})
        close(loss.item(), float(jloss))
        grads = unflatten({p: flax_layout(g, p).numpy() for p, g in zip(paths, recorded[-1])})
        if i == 0:
            for path, want in flatten(to_numpy(jgrads)).items():
                np.testing.assert_allclose(flatten(grads)[path], want, rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)
        updates, fed_state = tx.update(grads, fed_state, fed)
        fed = optax.apply_updates(fed, updates)
    assert port_tx.count == 2 and port_tx.mini_step == 0
    assert_close_tree(model, fed, ADAMW_TOL)
    assert_close_tree(model, jparams, STEP_TOL)


def test_eval_metrics_match_jax(ors):
    overrides = tiny_overrides(ors)
    _, jvocab, jmodel, params = jax_classifier(overrides, seed=4)
    _, vocab, model = port_classifier(overrides, params)
    classes = jvocab.num_mapper_classes
    assert classes < 10  # top-10 and top-100 are capped at the class count

    @jax.jit
    def jax_eval(params, batch):  # classifier_train.py:main's eval_step
        out = jmodel.apply(params, batch["frames"], batch["decoder_input_ids"],
                           decoder_attention_mask=batch["decoder_attention_mask"], labels=batch["labels"])
        logits, labels = out["logits"], batch["labels"]
        top1 = (logits.argmax(-1) == labels).mean()
        in_topk = lambda k: (jax.lax.top_k(logits, k)[1] == labels[:, None]).any(-1).mean()  # noqa: E731
        return out["loss"], top1, in_topk(min(10, logits.shape[-1])), in_topk(min(100, logits.shape[-1]))

    for b in batches(vocab.vocab_size_in, classes, 3, rows=6):
        want = [float(x) for x in jax_eval(params, {k: jnp.asarray(v) for k, v in b.items()})]
        with torch.no_grad():
            got = eval_step(model, {k: torch.as_tensor(v) for k, v in b.items()})
        close(got[0], want[0])
        assert got[1:] == want[1:]
        assert got[2] == got[3] == 1.0


def main_argv(ors, tmp_path, *extra):
    return ["-cn", "train_v1", *tiny_overrides(ors, *OPTIM), "optim.batch_size=2", "optim.total_steps=2",
            "optim.warmup_steps=1", "logging.every_steps=1", "logging.log_with=none", "eval.every_steps=2",
            "eval.steps=1",
            f"checkpoint_path={tmp_path / 'ckpt'}", *extra]


def test_main_grafts_the_pretrained_towers(ors, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = make_tiny_checkpoint(tmp_path / "pretrained")
    family = ["model.position_scheme=rope", "model.norm=rms", "model.spectrogram.n_mels=128", "data.src_seq_len=128"]
    # one micro-step of grad_acc 2: the parameters do not move
    model = classifier_train.main([*main_argv(ors, tmp_path, *family), "optim.total_steps=1",
                                   "optim.warmup_steps=0", f"pretrained_path={ckpt}", "device=cpu"])
    overrides = tiny_overrides(ors, *family)
    _, _, _, fresh = jax_classifier(overrides, seed=7)
    _, pre_params, _ = jax_load_checkpoint(ckpt)
    grafted = flatten(to_numpy(jax_transfer(fresh, pre_params)))
    own = flatten(to_numpy(fresh))
    state = dict(model.named_parameters())
    moved = 0
    for path, want in grafted.items():
        if np.array_equal(want, own[path]):
            continue  # the classifier's own tensors: not grafted
        moved += 1
        np.testing.assert_array_equal(flax_layout(state[torch_name(path)].detach(), path).numpy(), want,
                                      err_msg=path)
    assert moved >= 10


def test_main_trains_on_cpu_and_writes_a_bundle_both_packages_read(ors, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = main_argv(ors, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):  # no card and no device=cpu: no CPU fallback
        classifier_train.main(argv)
    model = classifier_train.main([*argv, "device=cpu"])
    logged = [json.loads(line) for line in (tmp_path / "logs" / "classifier" / "metrics.jsonl").read_text()
              .splitlines()]
    assert [r["step"] for r in logged if "train/loss" in r] == [1, 2]
    val = [r for r in logged if "val/loss" in r]
    assert len(val) == 1 and val[0]["step"] == 2
    assert {"val/accuracy", "val/top_10_accuracy", "val/top_100_accuracy"} <= set(val[0])
    assert all(np.isfinite(v) for r in logged for v in r.values())

    final = tmp_path / "ckpt" / "final"
    loaded, _, vocab = load_classifier_bundle(final)
    for name, tensor in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[name], tensor, rtol=0, atol=0)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, HOP * 63)).astype(np.float32)
    ids = rng.integers(1, vocab.vocab_size_in, (2, 32))
    mask = np.ones((2, 32), bool)
    with torch.no_grad():
        want = loaded(torch.tensor(frames), torch.tensor(ids), torch.tensor(mask))["feature_vector"].numpy()
    jax_model, jax_params = jax_calc_fid.load_classifier(SimpleNamespace(classifier_ckpt=str(final)))[:2]
    got = jax_model.apply(jax_params, jnp.asarray(frames), jnp.asarray(ids), decoder_attention_mask=jnp.asarray(mask))
    close(got["feature_vector"], want)


@pytest.mark.parametrize("which", ["classifier", "osur"])
def test_init_flax_params_draws_as_flax(ors, which):
    """``init_flax_params`` against the flax initialisers of the classifier
    (d_model 256) and of OsuR: the same leaves; constant leaves (biases,
    norm scales) equal; Dense kernels lecun-normal truncated at two standard
    deviations; ``nn.Embed`` tables N(0, 1 / features); each spread within 5%
    of flax's where a leaf has 4 096 entries or more, flax's own draws
    held to the same bar."""
    from mapperatorinator_tpu.models.classifier import OsuR as JaxOsuR
    from mapperatorinator_tpu.models.classifier import OsuRConfig as JaxOsuRConfig
    from mapperatorinator_tpu_torch.models.classifier import OsuR, OsuRConfig
    from mapperatorinator_tpu_torch.models.params import flax_paths, init_flax_params

    if which == "classifier":
        overrides = tiny_overrides(ors, "model.d_model=256", "model.encoder_ffn=512", "model.decoder_ffn=512")
        _, _, _, params = jax_classifier(overrides)
        args = load_classifier_config("train_v1", overrides)
        model = build_classifier(args, build_vocabulary(args))
    else:
        cfg = dict(vocab_size_in=3000, vocab_size_out=500, src_seq_len=32, hidden_size=128)
        params = JaxOsuR(JaxOsuRConfig(**cfg)).init(jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))
        model = OsuR(OsuRConfig(**cfg))
    want = flatten(to_numpy(params))
    init_flax_params(model, 0)
    paths = flax_paths(model)
    got = {paths[name]: flax_layout(p.detach(), paths[name]).numpy() for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for path, leaf in want.items():
        if np.all(leaf == leaf.flat[0]):
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
            continue
        if path.endswith("/embedding"):
            std = leaf.shape[1] ** -0.5
        else:
            assert path.endswith("/kernel") and leaf.ndim == 2, path
            std = leaf.shape[0] ** -0.5
            bound = 2 * std / 0.87962566103423978
            assert np.abs(got[path]).max() <= bound * (1 + 1e-6) and np.abs(leaf).max() <= bound * (1 + 1e-6), path
        if leaf.size >= 4096:
            assert abs(got[path].std() / std - 1) < 0.05 and abs(leaf.std() / std - 1) < 0.05, path
