"""Training every other backbone family on the port against the JAX train
step, on tiny fp32 models (d_model 32, 2 + 2 layers of 2 heads, ffn 64, 64
source frames, 48 target positions) of each family's training config:
stock whisper (``-cn v28``: whisper_abs, the learned decoder position table
and LayerNorm with biases), T5 v1.1 (``-cn t5_base``: the bucketed bias
table through plain self-attention, unscaled cross attention), nGPT
(``-cn nwhisper_base``: weights normalised on each forward, slerps, the
learned scales) and moonshine (``-cn moonshine_tiny``: the raw-wave stem
and its GroupNorm, partial rotation, the gated decoder MLP, a tied head).
Each model starts from the JAX ``model.init`` parameters, as the JAX
``train.py`` draws them, loaded into the port's model:

* the flax paths the port derives, and the weight-decay and Muon masks on
  them, leaf for leaf, and by name at the T5 bias table and nGPT's scales;
* the loss and every gradient against ``jax.value_and_grad`` at the model
  bar (2e-4, test_model.py:77), with sample weights, ignored labels,
  rhythm weights and label smoothing; on the CPU every attention call
  takes the plain version of kernels B and C;
* ``train.main`` of ``-cn v28``, ``v29``, ``t5_base``, ``nwhisper_base`` and
  ``moonshine_tiny`` at tiny widths on the CPU: two updates of grad_acc 2,
  finite losses, and the final checkpoint restored into a fresh state;
* a collated v28 / v29 training batch at the recipes' 1 024 source frames
  and 2 048 target positions fits both learned tables of whisper_abs.

``tests/test_torch_backbone_train_steps.py`` holds 3 train steps of each
family to the JAX step, ``tests/test_torch_step_flops.py`` each family's
FLOP and token counts.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models.mapperatorinator import build_config as jax_build_config
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.params import flatten, flax_layout, flax_paths, params_from_flax, torch_name
from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
from mapperatorinator_tpu_torch.train import main as train_main
from mapperatorinator_tpu_torch.train import optim
from mapperatorinator_tpu_torch.train.loop import CheckpointManager
from mapperatorinator_tpu_torch.train.data import build_dataset
from mapperatorinator_tpu_torch.train.data.batching import batch_iterator
from mapperatorinator_tpu_torch.train.step import TrainState, named_flax_params
from tests.test_torch_config import composed_train, composed_train_preset
from tests.test_torch_data import data_overrides, write_ors
from tests.test_torch_train import MODEL_TOL

torch.set_num_threads(1)

# each family's training config (the JAX composition: a recipe of configs/train, or the training default with
# model=<preset>), and what build_config makes of it
FAMILIES = {"v28": ("whisper_abs", "prenorm", "whisper"), "t5_base": ("t5_relpos", "prenorm", "whisper"),
            "nwhisper_base": ("whisper_abs", "ngpt", "whisper"), "moonshine_tiny": ("rope", "prenorm", "moonshine")}
TINY = dict(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=64, decoder_ffn_dim=64)
SRC, TGT = 64, 48
TINY_OVERRIDES = [*(f"model.overwrite.{k}={v}" for k, v in TINY.items()), f"data.src_seq_len={SRC}",
                  f"data.tgt_seq_len={TGT}", "mixed_precision=no", "data.label_smoothing=0.1"]


def jax_config(name: str, overrides):
    return composed_train(name, overrides) if name.startswith("v") else composed_train_preset(name, overrides)


@functools.lru_cache(maxsize=None)
def family(name: str, optim_args: tuple = ()):
    """(JAX model, its ``init`` parameters as train.py draws them, the port's
    training config, the port's state dict of those parameters) at tiny
    widths."""
    overrides = TINY_OVERRIDES + list(optim_args)
    jax_args = jax_config(name, overrides)
    jm = JaxMapperatorinator(jax_build_config(jax_args, jax_build_vocabulary(jax_args)))
    hop = jax_args.model.spectrogram.hop_length
    jparams = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), frames=jnp.zeros((1, hop * (SRC - 1))),
                                              decoder_input_ids=jnp.ones((1, 8), jnp.int32)))
    return jax_args, jm, jparams, load_train_config(name, overrides), params_from_flax(jparams)


def port_model(name: str, optim_args: tuple = ()):
    _, jm, jparams, args, state = family(name, optim_args)
    tm = Mapperatorinator(build_config(args, build_vocabulary(args)))
    tm.load_state_dict(state)
    b = tm.cfg.backbone
    assert (b.position_scheme, b.norm_scheme, b.stem_type) == FAMILIES[name]
    return jm, jparams, args, tm


def batch_arrays(cfg, seed: int = 0, rows: int = 2, length: int = 40):
    """White-noise audio; row 1 right-padded, as the data pipeline pads."""
    rng = np.random.default_rng(seed)
    frames = (0.3 * rng.standard_normal((rows, cfg.hop_length * (SRC - 1)))).astype(np.float32)
    ids = rng.integers(3, cfg.vocab_size_in, (rows, length)).astype(np.int64)
    mask = np.ones((rows, length), np.int64)
    ids[1, -6:], mask[1, -6:] = 0, 0
    labels = rng.integers(3, 600, (rows, length)).astype(np.int64)
    labels[mask == 0] = -100
    labels[0, :5] = -100
    return {"frames": frames, "decoder_input_ids": ids, "decoder_attention_mask": mask, "labels": labels,
            "sample_weights": np.array([0.5, 1.7], np.float32)}


# mask entries asserted by name: (decay, Muon branch) of the JAX masks
NAMED_MASKS = {
    "t5_base": {"params/transformer/encoder/rel_bias/embedding/embedding": (False, False),
                "params/transformer/decoder/rel_bias/embedding/embedding": (False, False),
                "params/transformer/encoder/layers_0/ffn/fc1_gate/kernel": (True, True)},
    "nwhisper_base": {"params/transformer/encoder/layers_0/attn_residual/branch_scale/scale": (False, False),
                      "params/transformer/decoder/layers_1/cross_residual/branch_scale/scale": (False, False),
                      "params/transformer/encoder/layers_0/self_attn/qk_scale/scale": (False, False),
                      "params/transformer/encoder/alpha_positions/scale": (False, False),
                      "params/transformer/logit_scale/scale": (False, False),
                      "params/transformer/encoder/embed_positions": (True, False),
                      "params/transformer/encoder/layers_0/self_attn/wq/kernel": (True, True),
                      "params/transformer/proj_out/kernel": (True, False)},
    "moonshine_tiny": {"params/transformer/encoder/conv1/kernel": (True, True),
                       "params/transformer/encoder/groupnorm/scale": (False, False),
                       "params/transformer/encoder/groupnorm/bias": (False, False)},
    "v28": {"params/transformer/decoder/embed_positions/embedding": (True, False),
            "params/transformer/encoder/layers_0/final_norm/LayerNorm_0/bias": (False, False)},
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_flax_paths_and_masks_match_jax(name):
    _, jparams, _, tm = port_model(name)
    leaves = flatten(jparams)
    paths = flax_paths(tm)
    assert sorted(paths.values()) == sorted(leaves)
    assert [p for p, _ in named_flax_params(tm)] == [paths[n] for n, _ in tm.named_parameters()]
    decay = flatten(jax_optim.decay_mask(jparams))
    branch = flatten(jax_optim.muon_branch_mask(jparams))
    for path, p in named_flax_params(tm):
        assert optim.decay_mask(path) == decay[path], path
        assert optim.muon_branch_mask(path, p) == branch[path], path
    named = dict(named_flax_params(tm))
    for path, want in NAMED_MASKS[name].items():
        assert (decay[path], branch[path]) == want, path
        assert (optim.decay_mask(path), optim.muon_branch_mask(path, named[path])) == want, path


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(name):
    jm, jparams, _, tm = port_model(name)
    assert tm.cfg.rhythm_weight == 3.0 and tm.cfg.label_smoothing == 0.1
    batch = batch_arrays(tm.cfg)

    def jax_loss(params):
        return jm.apply(params, **{k: jnp.asarray(v) for k, v in batch.items()}, deterministic=True)[1]

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(jparams)
    _, loss = tm(**{k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=MODEL_TOL, atol=MODEL_TOL)
    grads = {name: p.grad for name, p in tm.named_parameters()}
    for path, want in flatten(jax.device_get(want_grads)).items():
        got = flax_layout(grads[torch_name(path)], path).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=path)


@pytest.fixture(scope="module")
def ors_root(tmp_path_factory):
    return write_ors(tmp_path_factory.mktemp("ors"))


@pytest.mark.parametrize("name", ["v28", "v29", "t5_base", "nwhisper_base", "moonshine_tiny"])
def test_train_main_trains_each_family_on_the_cpu(ors_root, tmp_path, name):
    """``-cn <name> data.dataset_type=ors device=cpu`` at tiny widths: four
    micro-steps of grad_acc 2 (two updates), each loss finite, and the final
    checkpoint restored into a fresh state with equal parameters."""
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    argv = ["-cn", name, "device=cpu", "mixed_precision=no", f"checkpoint_path={ckpt}",
            *data_overrides(ors_root, src=128, tgt=192), *(f"model.overwrite.{k}={v}" for k, v in TINY.items()),
            "optim.batch_size=2", "optim.grad_acc=2", "optim.total_steps=4", "optim.warmup_steps=1",
            "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0", "logging.every_steps=1",
            "logging.log_with=none", "eval.every_steps=0", "checkpoint.every_steps=1000"]
    state = train_main.main(argv, log_dir=str(logs))
    assert state.step == 4 and state.optimizer.count == 2
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()
    args = load_train_config(name, argv[2:])
    fresh, _, _ = train_main.build_model_and_data(args, torch.device("cpu"))
    assert fresh.cfg == state.model.cfg
    restored = CheckpointManager(ckpt).restore(
        TrainState(0, fresh, optim.build_optimizer(args, named_flax_params(fresh))))
    assert restored.step == 4 and restored.optimizer.count == 2
    trained = dict(state.model.named_parameters())
    for n, p in restored.model.named_parameters():
        assert torch.equal(p, trained[n]), n


@pytest.mark.parametrize("name", ["v28", "v29"])
def test_a_collated_training_batch_fits_both_learned_tables(ors_root, name):
    """At the recipe's 1 024 source frames and 2 048 target positions (the
    widths tiny): a collated batch's encoder states fill the encoder's
    sinusoids' reach, ``max_source_positions`` = 512, its tokens the
    decoder's learned table, ``max_target_positions`` = 2 048, and the
    teacher-forced loss is finite."""
    args = load_train_config(name, [*data_overrides(ors_root, src=1024, tgt=2048), "mixed_precision=no",
                                    *(f"model.overwrite.{k}={v}" for k, v in TINY.items())])
    vocab = build_vocabulary(args)
    model = Mapperatorinator(build_config(args, vocab)).eval()
    b = model.cfg.backbone
    assert (b.position_scheme, b.max_source_positions, b.max_target_positions) == ("whisper_abs", 512, 2048)
    dataset = build_dataset(args.data, BeatmapParser(args, vocab), vocab)
    batch = next(batch_iterator(iter(dataset), 2))
    frames = torch.from_numpy(batch["frames"]).float()
    ids = torch.from_numpy(batch["decoder_input_ids"]).long()
    assert ids.shape[1] <= b.max_target_positions
    with torch.no_grad():
        states = model.encode(frames)
        assert states.shape[1] <= b.max_source_positions
        _, loss = model(encoder_states=states, decoder_input_ids=ids,
                        decoder_attention_mask=torch.from_numpy(batch["decoder_attention_mask"]),
                        labels=torch.from_numpy(batch["labels"]).long())
    print(f"{name}: {states.shape[1]} encoder positions, {ids.shape[1]} decoder positions")
    assert np.isfinite(loss.item())
    assert (states.shape[1], ids.shape[1]) == (b.max_source_positions, b.max_target_positions)
