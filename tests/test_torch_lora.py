"""The port's LoRA adapters (``models/lora.py``) against the JAX package's, on
the tiny v32-architecture checkpoint.

* target selection: the same kernels as the JAX ``_target_kernels`` for the
  default targets, the peft aliases and the VarWhisper names, and the
  optimizer masks on the factors' flax paths;
* ``merge_lora`` on the same factors, carried across: atol 1e-5 (rank-r fp32
  products on two BLAS libraries);
* ``save_lora`` / ``load_lora`` in both directions, the port's file byte for
  byte the one flax writes;
* ``resolve_compatible_lora_path`` in its four cases;
* ``load_model`` with ``lora_path``, greedy: token for token and ``.osu``
  byte for byte the JAX ``load_model``'s, fp32 and with int8 weights, whose
  merged-then-quantized kernels and scales must equal JAX's. The adapter of
  that test has dyadic factors (multiples of 1/64 below 1/8 in magnitude):
  every product and sum of the rank-8 merge is then exact in fp32, so both
  packages' merged weights are the same bits whatever order their BLAS sums
  in, and a round-to-int8 that lands on a tie cannot split them.
"""

import json

import jax
import numpy as np
import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models import lora as jax_lora
from mapperatorinator_tpu.train import optim as jax_optim
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.models import lora
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.params import flatten, lora_from_flax, torch_name
from mapperatorinator_tpu_torch.train import optim
from mapperatorinator_tpu_torch.train.step import named_flax_params
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint, make_wav
from tests.test_torch_model import tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)

MERGE_ATOL = 1e-5
TARGETS = {"default": None, "peft": ["q_proj", "k_proj", "v_proj", "out_proj"],
           "varwhisper": ["Wq", "Wkv", "Wqkv", "Wo"], "one": ["wo"]}


def jax_factors(jparams, rank: int, targets, seed: int, dyadic: bool = False) -> dict:
    """A JAX factor tree with B drawn too (B = 0 would merge to the base)."""
    tree = jax.device_get(jax_lora.init_lora_params(jax.random.PRNGKey(seed), jparams, rank=rank,
                                                    target_modules=targets))
    rng = np.random.default_rng(seed)

    def draw(x):
        if dyadic:
            return (rng.integers(-8, 9, x.shape) / 64).astype(np.float32)
        return (0.05 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree.map(draw, tree)


def port_adapter(tmodel, tree, rank: int, targets):
    adapter = lora.init_lora_params(tmodel, rank=rank, target_modules=targets)
    adapter.load_state_dict(lora_from_flax(tree))
    return adapter


@pytest.mark.parametrize("which", sorted(TARGETS))
def test_targets_are_the_jax_kernels(tiny, which):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    targets = lora.normalize_targets(TARGETS[which])
    assert targets == jax_lora.normalize_targets(TARGETS[which])
    want = {path: tuple(k.shape) for path, k in jax_lora._target_kernels(jparams, targets).items()}
    got = {path: (m.in_features, m.out_features) for path, m in lora.target_kernels(tmodel, targets).items()}
    assert got == want and len(got) > 0


def test_factor_paths_and_masks_are_jax(tiny):  # noqa: F811
    """The optimizer sees the factors under the JAX tree's paths, and the
    JAX masks on that tree: both factors decayed and on Muon's branch."""
    _, _, jparams, tmodel, _ = tiny
    tree = jax_factors(jparams, 8, None, seed=0)
    adapter = port_adapter(tmodel, tree, 8, None)
    named = named_flax_params(adapter)
    assert [path for path, _ in named] == sorted(flatten(tree))
    decay, branch = flatten(jax_optim.decay_mask(tree)), flatten(jax_optim.muon_branch_mask(tree))
    for path, p in named:
        assert optim.decay_mask(path) == decay[path] is True, path
        assert optim.muon_branch_mask(path, p) == branch[path] is True, path


@pytest.mark.parametrize("which", ["default", "peft"])
def test_merge_matches_jax(tiny, which):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    tree = jax_factors(jparams, 8, TARGETS[which], seed=1)
    want = flatten(jax.device_get(jax_lora.merge_lora(jparams, tree, alpha=16.0)))
    adapter = port_adapter(tmodel, tree, 8, TARGETS[which])
    merged = lora.merge_lora(dict(tmodel.named_parameters()), adapter, alpha=16.0)
    assert sorted(merged) == sorted(torch_name(path) for path in adapter)
    for path in flatten(tree):
        kernel = path.rsplit("/", 1)[0]
        np.testing.assert_allclose(merged[torch_name(kernel)].detach().T.numpy(), want[kernel], rtol=0,
                                   atol=MERGE_ATOL, err_msg=kernel)

    # in place: every other weight keeps its bits
    model = type(tmodel)(tmodel.cfg)
    model.load_state_dict(tmodel.state_dict())
    lora.merge_lora_into(model, adapter, alpha=16.0)
    base = tmodel.state_dict()
    for name, t in model.state_dict().items():
        if name in merged:
            torch.testing.assert_close(t, merged[name].detach(), rtol=0, atol=0)
        else:
            assert torch.equal(t, base[name]), name


@pytest.mark.parametrize("subfolders", [None, ["gamemode=0"]])
def test_adapter_files_load_in_both_packages(tiny, tmp_path, subfolders):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    targets = TARGETS["varwhisper"]
    tree = jax_factors(jparams, 8, targets, seed=2)
    jax_lora.save_lora(tmp_path / "jax", tree, rank=8, alpha=16.0, target_modules=targets,
                       ckpt_subfolders=subfolders)
    # the port reads the JAX file
    adapter, config = lora.load_lora(tmp_path / "jax", tmodel)
    for path, leaf in flatten(tree).items():
        kernel, factor = path.rsplit("/", 1)
        np.testing.assert_array_equal(getattr(adapter[kernel], factor).detach().numpy(), leaf)
    assert config == json.loads((tmp_path / "jax" / lora.LORA_CONFIG_FILENAME).read_text())

    # the JAX package reads the port's, which is the same bytes
    lora.save_lora(tmp_path / "port", adapter, rank=8, alpha=16.0, target_modules=targets,
                   ckpt_subfolders=subfolders)
    for name in (lora.LORA_WEIGHTS_FILENAME, lora.LORA_CONFIG_FILENAME):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    got, jconfig = jax_lora.load_lora(tmp_path / "port", jparams)
    assert jconfig == config
    for path, leaf in flatten(jax.device_get(got)).items():
        np.testing.assert_array_equal(np.asarray(leaf), flatten(tree)[path], err_msg=path)


def test_load_lora_refuses_other_factors(tiny, tmp_path):  # noqa: F811
    _, _, jparams, tmodel, _ = tiny
    jax_lora.save_lora(tmp_path, jax_factors(jparams, 8, ["wo"], seed=0), rank=8, alpha=16.0,
                       target_modules=["wo"])
    config = json.loads((tmp_path / lora.LORA_CONFIG_FILENAME).read_text())
    config["r"] = 4
    (tmp_path / lora.LORA_CONFIG_FILENAME).write_text(json.dumps(config))
    with pytest.raises(ValueError, match="does not hold the factors"):
        lora.load_lora(tmp_path, tmodel)


@pytest.mark.parametrize("case", ["compatible", "incompatible", "no config", "unreadable config"])
def test_resolve_compatible_lora_path_matches_jax(tmp_path, case, capsys):
    adapter = tmp_path / "adapter"
    adapter.mkdir()
    config = adapter / lora.LORA_CONFIG_FILENAME
    if case in ("compatible", "incompatible"):
        config.write_text(json.dumps({"r": 8, "ckpt_subfolders": ["gamemode=0"]}))
    elif case == "unreadable config":
        config.write_text("{not json")
    subfolder = "gamemode=3" if case == "incompatible" else "gamemode=0"
    got = lora.resolve_compatible_lora_path(str(adapter), subfolder)
    port_out = capsys.readouterr().out
    want = jax_lora.resolve_compatible_lora_path(str(adapter), subfolder)
    assert got == want and port_out == capsys.readouterr().out
    assert (got[0] is None) == (case == "incompatible")
    assert lora.resolve_compatible_lora_path(None) == (None, None)


@pytest.mark.parametrize("int8", [False, True])
def test_load_model_with_lora_generates_the_jax_osu(tiny, tmp_path, int8):  # noqa: F811
    base = make_tiny_checkpoint(tmp_path / "base" / "gamemode=0", seed=3).parent
    _, _, jparams, tmodel, _ = tiny
    targets = TARGETS["varwhisper"]
    jax_lora.save_lora(tmp_path / "adapter", jax_factors(jparams, 8, targets, seed=4, dyadic=True), rank=8,
                       alpha=16.0, target_modules=targets, ckpt_subfolders=["gamemode=0"])
    wav = make_wav(tmp_path / "song.wav", seconds=2.0)
    overrides = [f"model_path={base}", f"lora_path={tmp_path / 'adapter'}", f"audio_path={wav}",
                 "train.data.src_seq_len=256", "train.data.tgt_seq_len=256", "do_sample=false", "seed=7",
                 "gamemode=0", "title=Lora", "bpm=120", "offset=0", "device=cpu",
                 f"quantized_weights={str(int8).lower()}"]
    results = []
    for module in (jax_inference, inference):
        out = tmp_path / module.__name__
        out.mkdir()
        if module is jax_inference:
            args = compose(REPO_ROOT / "configs" / "inference", "v32", schema_cls=schema.InferenceConfig,
                           overrides=[*overrides, f"output_path={out}"])
        else:
            args = load_config("v32", [*overrides, f"output_path={out}"])
        engine, vocab = module.load_model(args)
        decoded = []
        inner = engine.generate

        def recording(*a, _inner=inner, _decoded=decoded, **kw):
            tokens, end = _inner(*a, **kw)
            _decoded.append((tokens.tolist(), int(end)))
            return tokens, end

        engine.generate = recording
        module.compile_args(args, vocab, verbose=False)
        generation_config, beatmap_config = module.get_config(args)
        text, path = module.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                     engine=engine, vocab=vocab, verbose=False)
        results.append((engine, decoded, text, path))
    (jengine, want_tokens, want, want_path), (engine, got_tokens, got, got_path) = results

    state = engine.model.state_dict()
    stored = flatten(jax.device_get(jengine.params))
    for path, leaf in stored.items():  # merged (then quantized): every leaf the same bits
        t = state[torch_name(path, qdense=path.rsplit("/", 1)[0] + "/kernel_q" in stored)]
        t = t.T if path.endswith("/kernel") and t.dim() == 2 else t
        t = t.permute(2, 1, 0) if t.dim() == 3 else t
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf), err_msg=path)
    assert any("kernel_q" in p for p in stored) == int8
    unmerged, _ = load_checkpoint(base / "gamemode=0")  # the adapter moved every target
    for name, t in unmerged.state_dict().items():
        if name.endswith(("wq.weight", "wkv.weight", "wqkv.weight", "wo.weight")) and not int8:
            assert not torch.equal(state[name], t), name
    assert len(got_tokens) == len(want_tokens) > 0
    assert got_tokens == want_tokens
    assert got == want and got_path.read_bytes() == want_path.read_bytes()
