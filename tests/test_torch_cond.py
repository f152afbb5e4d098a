"""The conditioning embedders and conditioned generation (v31, v30) on the
port against the JAX package.

A tiny v31 checkpoint is written by the JAX package (its ``build_config`` on
``configs/train/v31.yaml``, narrowed as ``tests/fixtures/tiny_checkpoint.py``
narrows v32), with the embedders' RBF bases moved off flax's initial values,
so that a port that ignored the stored ones would differ. On it:

* each embedder against its flax module, at rtol = atol = 1e-6, over
  mapper ids -1, 0, ``num_mappers`` and past it, difficulties 0 and 10 and
  song-position ranges at 0 and 1;
* ``encode`` with every condition (the style table too) against JAX at
  atol 1e-5;
* greedy ``generate`` on conditioned encoder states token for token against
  JAX, at B 1 and as a CFG 2 pair, in fp32 and with int8 weights and KV;
* v31 in bf16 against JAX in bf16 at ``test_torch_bf16_parity.py``'s bars;
* the checkpoint read and written both ways, int8 quantization leaving the
  embedders as they are, and ``init_params`` seeding the RBF bases as flax.

``tests/test_torch_cond_serving.py`` serves the same checkpoint through the
command line and the batching server.

The JAX ``load_checkpoint`` traces ``model.init`` for the parameter shapes
with no condition (``mapperatorinator_tpu/models/io.py:97-103``), which a
conditioned model cannot run, so the JAX package cannot load a v30 or v31
checkpoint, and its ``quantize_checkpoint`` cannot quantize one; the JAX
side runs both with :func:`jax_init_with_conditions`, which gives that trace
the conditions.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.decode import logits as jax_logits
from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models import mapperatorinator as jax_mapperatorinator
from mapperatorinator_tpu.models import io as jax_io
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu.models.io import save_checkpoint as jax_save_checkpoint
from mapperatorinator_tpu.models.mapperatorinator import build_config as jax_build_config
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode import logits as torch_logits
from mapperatorinator_tpu_torch.models import mapperatorinator
from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model, save_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import Mapperatorinator
from mapperatorinator_tpu_torch.models.params import flatten, init_params, params_from_flax, unflatten
from mapperatorinator_tpu_torch.models.transformer import Attention, QDense
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT, SRC_SEQ_LEN
from tests.test_torch_bf16_parity import ARGMAX_AGREEMENT, REL_TOL
from tests.test_torch_checkpoint import assert_trees_equal, flat_numpy
from tests.test_torch_decode import decode_prompt
from tests.test_torch_model import audio, prompt

torch.set_num_threads(1)

EMBED_TOL = 1e-6
ENCODE_TOL = 1e-5
MAX_LEN = 96
TGT_SEQ_LEN = 128


def make_tiny_cond_checkpoint(directory, name: str = "v31", d_model: int = 64, layers: int = 2, heads: int = 4,
                              ffn: int = 128, seed: int = 0):
    """A ``name``-architecture (v31 or v30) Mapperatorinator at tiny width,
    with its conditioning embedders, written by the JAX package as a native
    checkpoint; the RBF centres and widths are moved off their initial
    values by a seeded amount."""
    args = compose(REPO_ROOT / "configs" / "train", name, schema_cls=schema.TrainConfig)
    args.data.dataset_type = "none"
    args.data.src_seq_len, args.data.tgt_seq_len = SRC_SEQ_LEN, TGT_SEQ_LEN
    args.mixed_precision = "no"
    vocab = jax_build_vocabulary(args)
    cfg = jax_build_config(args, vocab)
    cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, d_model=d_model, encoder_layers=layers, decoder_layers=layers, encoder_heads=heads,
        decoder_heads=heads, encoder_ffn=ffn, decoder_ffn=ffn))
    params = jax.jit(JaxMapperatorinator(cfg).init)(
        jax.random.PRNGKey(seed), frames=jnp.zeros((1, 128 * (SRC_SEQ_LEN - 1)), jnp.float32),
        decoder_input_ids=jnp.ones((1, 8), jnp.int32), **init_conditions())
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(lambda path, x: _moved(path, x, rng), params)
    jax_save_checkpoint(directory, cfg, params, vocab=vocab)
    return directory


def init_conditions(batch: int = 1) -> dict:
    return dict(difficulty=jnp.full((batch,), 4.5), mapper_idx=jnp.zeros((batch,), jnp.int32),
                song_position=jnp.zeros((batch, 2)))


def _init_with_conditions(init):
    def traced(self, rngs, *args, **kwargs):
        return init(self, rngs, *args, **{**init_conditions(), **kwargs})

    return traced


@contextlib.contextmanager
def jax_init_with_conditions():
    """The JAX model's ``init`` given the conditions when its caller gives
    none (a model that does not embed them ignores them), so that the JAX
    ``load_checkpoint`` and ``quantize_checkpoint`` can trace a conditioned
    model's parameter shapes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxMapperatorinator, "init", _init_with_conditions(JaxMapperatorinator.init))
        yield


@pytest.fixture
def jax_loads_cond():
    with jax_init_with_conditions():
        yield


def _moved(path, x, rng):
    leaf = path[-1].key
    if leaf == "basis_centers":
        return x + rng.uniform(-0.05, 0.05, x.shape).astype(np.float32)
    if leaf == "basis_widths":
        return x * rng.uniform(0.8, 1.5, x.shape).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def tiny_v31(tmp_path_factory):
    directory = make_tiny_cond_checkpoint(tmp_path_factory.mktemp("v31"))
    with pytest.raises(TypeError):  # the JAX loader's shape trace, with no condition
        jax_io.load_checkpoint(directory)
    with jax_init_with_conditions():
        jmodel, jparams, vocab = jax_io.load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


def conditions(batch: int, num_mappers: int, num_classes: int = 0) -> dict:
    """Seeded conditions, one a row: the edge cases first."""
    rng = np.random.default_rng(batch)
    cond = {
        "difficulty": np.concatenate([[0.0, 10.0], rng.uniform(0, 12, batch)])[:batch].astype(np.float32),
        "mapper_idx": np.concatenate([[-1, 0, num_mappers, num_mappers + 7],
                                      rng.integers(0, num_mappers, batch)])[:batch].astype(np.int32),
        "song_position": np.concatenate([[[0.0, 1.0], [0.0, 0.0], [1.0, 1.0]],
                                         np.sort(rng.uniform(0, 1, (batch, 2)), axis=-1)])[:batch].astype(np.float32),
    }
    if num_classes:
        cond["beatmap_idx"] = rng.integers(0, num_classes + 1, batch).astype(np.int32)
    return cond


def torch_cond(cond: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v) for k, v in cond.items()}


def perturbed(params, seed: int):
    """Every leaf moved by seeded noise (widths kept positive)."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "basis_widths":
            return x * np.exp(0.3 * noise)
        return x + 0.3 * noise

    return jax.tree_util.tree_map_with_path(move, params)


EMBEDDERS = {
    "difficulty": (lambda n: jax_mapperatorinator.DifficultyEmbedder(24),
                   lambda n: mapperatorinator.DifficultyEmbedder(24), "difficulty"),
    "mapper": (lambda n: jax_mapperatorinator.MapperStyleEmbedder(n, 24),
               lambda n: mapperatorinator.MapperStyleEmbedder(n, 24), "mapper_idx"),
    "song_position": (lambda n: jax_mapperatorinator.SongPositionEmbedder(24),
                      lambda n: mapperatorinator.SongPositionEmbedder(24), "song_position"),
    "rbf": (lambda n: jax_mapperatorinator.RBFEmbedder(8), lambda n: mapperatorinator.RBFEmbedder(8), "difficulty"),
}


@pytest.mark.parametrize("name", sorted(EMBEDDERS))
def test_embedder_matches_its_flax_module(name):
    make_jax, make_torch, key = EMBEDDERS[name]
    num_mappers = 50
    x = conditions(7, num_mappers)[key]
    if name == "rbf":
        x = x / 10.0
    jm = make_jax(num_mappers)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x)), seed=2)
    tm = make_torch(num_mappers).eval()
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch_cond({key: x})[key]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=EMBED_TOL, atol=EMBED_TOL)
    if name == "mapper":  # -1, num_mappers and every id past it take the table's last row
        np.testing.assert_array_equal(got[0], got[2])
        np.testing.assert_array_equal(got[3], got[2])


def test_encode_with_every_condition_matches_jax(tiny_v31):
    _, jmodel, _, tmodel, vocab = tiny_v31
    c = jmodel.config
    num_classes = 6  # the style table too: d_model more channels before the stem
    jcfg = dataclasses.replace(c, do_style_embed=True, num_classes=num_classes,
                               cond_size=c.backbone.d_model + 3 * c.cond_dim,
                               backbone=dataclasses.replace(c.backbone, num_mel_bins=c.backbone.num_mel_bins
                                                            + c.backbone.d_model))
    jm = JaxMapperatorinator(jcfg)
    frames = audio(5)
    cond = conditions(5, c.num_mappers, num_classes)
    # the checkpoint's parameters, a style table and a wider stem added
    flat = flatten(jax.tree_util.tree_map(np.asarray, tiny_v31[2]))
    rng = np.random.default_rng(3)
    conv1 = next(k for k in flat if k.endswith("/encoder/conv1/kernel"))
    flat[conv1] = (0.05 * rng.standard_normal((3, jcfg.backbone.num_mel_bins, c.backbone.d_model))).astype(np.float32)
    flat["params/style_embedder/embedding"] = rng.standard_normal((num_classes + 1, c.backbone.d_model)).astype(
        np.float32)
    jparams = perturbed(unflatten(flat), seed=4)
    tm = Mapperatorinator(dataclasses.replace(
        tmodel.cfg, do_style_embed=True, num_classes=num_classes, cond_size=jcfg.cond_size,
        backbone=dataclasses.replace(tmodel.cfg.backbone, num_mel_bins=jcfg.backbone.num_mel_bins))).eval()
    tm.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, jparams)))
    want = np.asarray(jax.jit(lambda p, f, kw: jm.apply(p, f, method=JaxMapperatorinator.encode, **kw))(
        jparams, jnp.asarray(frames), {k: jnp.asarray(v) for k, v in cond.items()}))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames), **torch_cond(cond)).numpy()
        # without beatmap_idx, the "no style" row num_classes, as the JAX encode fills it in
        no_style = {k: v for k, v in cond.items() if k != "beatmap_idx"}
        default = tm.encode(torch.from_numpy(frames), **torch_cond(no_style))
        explicit = tm.encode(torch.from_numpy(frames), **torch_cond(
            {**no_style, "beatmap_idx": np.full(5, num_classes, np.int32)}))
    assert got.shape == want.shape == (5, SRC_SEQ_LEN // 2, c.backbone.d_model)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENCODE_TOL)
    assert torch.equal(default, explicit)
    with pytest.raises(ValueError, match="difficulty"):
        tm.encode(torch.from_numpy(frames), **torch_cond({k: v for k, v in cond.items() if k != "difficulty"}))


def engines(tiny_v31, quantized: bool = False):
    _, jmodel, jparams, tmodel, vocab = tiny_v31
    if quantized:
        with jax_init_with_conditions():
            jmodel, jparams = quantize_checkpoint(jmodel, jparams)
        jmodel = JaxMapperatorinator(dataclasses.replace(
            jmodel.config, backbone=dataclasses.replace(jmodel.config.backbone, quantized_kv=True)))
        qmodel = quantize_model(tmodel)
        tmodel = Mapperatorinator(dataclasses.replace(
            qmodel.cfg, backbone=dataclasses.replace(qmodel.cfg.backbone, quantized_kv=True)))
        tmodel.load_state_dict(qmodel.state_dict())
    return (JaxDecodeEngine(jmodel, jparams, MAX_LEN, vocab.pad_id),
            DecodeEngine(tmodel.eval(), MAX_LEN, vocab.pad_id, device="cpu"), vocab)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_conditioned_greedy_tokens_match_jax(tiny_v31, cfg_scale, quantized):
    jeng, teng, vocab = engines(tiny_v31, quantized)
    frames = audio(1, seed=5)
    cond = conditions(1, tiny_v31[1].config.num_mappers)
    cond["difficulty"][:] = 6.5
    ids = decode_prompt(vocab, 2 if cfg_scale > 1 else 1)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=200.0)
    jp = jax_logits.build_logits_pipeline(vocab, do_sample=False, cfg_scale=cfg_scale)
    tp = torch_logits.build_logits_pipeline(PortVocabulary.from_state_dict(vocab.state_dict()), do_sample=False,
                                            cfg_scale=cfg_scale)
    jenc = jeng.encode_with_cond(frames, cond)
    tenc = teng.encode_with_cond(frames, cond)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), rtol=0, atol=ENCODE_TOL)
    if cfg_scale > 1:  # [negative; positive] rows over one window
        jenc, tenc = jnp.concatenate([jenc, jenc]), torch.cat([tenc, tenc])
    want, want_end = jeng.generate(jenc, ids, jp, eos, seed=0, cfg_scale=cfg_scale)
    got, got_end = teng.generate(tenc, ids, tp, eos, seed=0, cfg_scale=cfg_scale)
    assert (got[:, ids.shape[1]:] != vocab.pad_id).sum() > 10
    np.testing.assert_array_equal(got, want)
    assert int(got_end) == int(want_end)
    # the condition reaches the tokens: another difficulty, other encoder states
    other = teng.encode_with_cond(frames, {**cond, "difficulty": np.full(1, 1.0, np.float32)})
    assert (other - teng.encode_with_cond(frames, cond)).abs().max() > 1e-3


def test_bf16_conditioned_logits_match_jax_bf16(tiny_v31):
    _, jmodel, jparams, tmodel, _ = tiny_v31
    jm = JaxMapperatorinator(dataclasses.replace(
        jmodel.config, backbone=dataclasses.replace(jmodel.config.backbone, dtype=jnp.bfloat16)))
    tm = Mapperatorinator(dataclasses.replace(
        tmodel.cfg, backbone=dataclasses.replace(tmodel.cfg.backbone, dtype=torch.bfloat16)))
    tm.load_state_dict(tmodel.state_dict())
    tm.eval()  # the embedders' dropout off, as the JAX model's deterministic apply
    frames = audio(2)
    cond = conditions(2, jmodel.config.num_mappers)
    ids, mask = prompt(2, 40, tm.cfg.vocab_size_in)
    want, _ = jax.jit(jm.apply)(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                                decoder_attention_mask=jnp.asarray(mask),
                                **{k: jnp.asarray(v) for k, v in cond.items()})
    want = np.asarray(want.astype(jnp.float32))
    for flash in (True, False):
        for m in tm.modules():
            if isinstance(m, Attention):
                m.use_flash = flash
        with torch.no_grad():
            got = tm(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                     decoder_attention_mask=torch.from_numpy(mask), **torch_cond(cond)).float().numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        agree = (got.argmax(-1) == want.argmax(-1)).mean()
        assert rel < REL_TOL, (flash, rel)
        assert agree > ARGMAX_AGREEMENT, (flash, agree)


def test_load_model_holds_the_embedders_fp32_in_bf16(tiny_v31):
    """``precision=bf16`` holds the backbone's weights in bf16 and leaves the
    embedders and the mel tables fp32 and unrounded, as the JAX model
    computes them; ``quantized_weights`` quantizes the backbone's dense
    layers only, as the JAX ``quantize_checkpoint`` does."""
    directory, jmodel, jparams, tmodel, _ = tiny_v31
    args = load_config("v31", [f"model_path={directory}", "device=cpu", "precision=bf16", "quantized_weights=true"])
    model = inference.load_model(args)[0].model
    stored = tmodel.state_dict()
    for name in mapperatorinator.FP32_MODULES[2:]:
        for key, tensor in getattr(model, name).state_dict().items():
            assert tensor.dtype == torch.float32 and torch.equal(tensor, stored[f"{name}.{key}"]), key
    fresh = Mapperatorinator(tmodel.cfg).spectrogram
    for key, tensor in fresh.state_dict(keep_vars=True).items():
        assert torch.equal(getattr(model.spectrogram, key), tensor), key
    assert model.transformer.encoder.conv1.weight.dtype == torch.bfloat16
    with jax_init_with_conditions():
        qmodel, qparams = quantize_checkpoint(jmodel, jparams)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, qparams))
    got = quantize_model(tmodel).state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(isinstance(m, QDense) for name in mapperatorinator.FP32_MODULES[2:]
                   for m in getattr(model, name).modules())


def test_checkpoint_reads_and_writes_both_ways(tiny_v31, tmp_path):
    directory, jmodel, jparams, tmodel, vocab = tiny_v31
    assert {n.split(".")[0] for n in tmodel.state_dict()} >= {"difficulty_embedder", "mapper_embedder",
                                                               "song_pos_embedder"}
    assert set(flatten(jax.tree_util.tree_map(np.asarray, jparams))) == {
        f"params/{p}" for p in flatten(jax.tree_util.tree_map(np.asarray, jparams["params"]))}
    port_vocab = load_checkpoint(directory)[1]
    save_checkpoint(tmp_path / "out", tmodel.cfg, tmodel.state_dict(), port_vocab)
    with jax_init_with_conditions():
        got_model, got, got_vocab = jax_io.load_checkpoint(tmp_path / "out")
    assert got_model.config == jmodel.config
    assert_trees_equal(flat_numpy(got), flat_numpy(jparams))
    assert got_vocab.state_dict() == vocab.state_dict()


def test_init_params_seeds_the_rbf_bases_as_flax(tiny_v31):
    model = Mapperatorinator(tiny_v31[3].cfg)
    init_params(model, 0)
    state = model.state_dict()
    for name in ("difficulty_embedder.rbf", "song_pos_embedder.rbf"):
        n = state[f"{name}.basis_centers"].numel()
        np.testing.assert_allclose(state[f"{name}.basis_centers"].numpy(), np.linspace(0, 1, n), atol=1e-7)
        assert torch.equal(state[f"{name}.basis_widths"], torch.full((n,), 0.1))
    for name in ("difficulty_embedder.norm1", "mapper_embedder.norm", "song_pos_embedder.norm2"):
        assert torch.equal(state[f"{name}.weight"], torch.ones_like(state[f"{name}.weight"]))
        assert not state[f"{name}.bias"].any()
    assert state["mapper_embedder.table.weight"].std() > 0.5
