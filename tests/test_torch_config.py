"""The port's compositions of the v32 configs, the v28 and v29 training
recipes, and the T5, NWhisper and moonshine training configs, against the
JAX loader.

The port composes ``configs/inference/v32.yaml`` and
``configs/train/{v32,v28,v29}.yaml`` itself (``mapperatorinator_tpu_torch/config/``,
without yaml). ``t5_base`` is ``configs/train/default.yaml`` with
``model=t5_base`` (the T5 v1.1-base backbone of the legacy osuT5
releases): the repo has no preset that names it, so the port keeps one of
its own (``mapperatorinator_tpu_torch/configs/train/t5_base.yaml``,
``defaults: [default, ../model@model: t5_base, _self_]``, as
``configs/train/v32.yaml`` names its model), and the JAX loader composes the
same text written into a copy of ``configs/``; ``nwhisper_base`` and
``moonshine_tiny`` likewise. Every field must be equal, with and without
overrides.
"""

import dataclasses
import shutil
import tempfile
from enum import Enum
from pathlib import Path
from types import SimpleNamespace

import torch

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.mapperatorinator import build_config as jax_build_config
import pytest

from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.config.loader import ConfigCompositionError
from mapperatorinator_tpu_torch.config import ConfigError, compose_config, load_config, load_train_config, select_device
from mapperatorinator_tpu_torch.config import schema as port_schema
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT


def composed_v32():
    return compose(REPO_ROOT / "configs" / "inference", "v32", schema_cls=schema.InferenceConfig)


# the training recipes of ``configs/train/`` that the port checks in as
# ``train_<name>.json``: v32, and stock whisper's v28 (whisper-base) and v29
# (whisper-small)
RECIPES = ("v32", "v28", "v29")


def composed_train(name: str = "v32", overrides=()):
    return compose(REPO_ROOT / "configs" / "train", name, overrides=list(overrides), schema_cls=schema.TrainConfig)


T5_BASE_PRESET = "defaults:\n  - default\n  - ../model@model: t5_base\n  - _self_\n"
# the backbones whose training configs are composed the same way: the JAX
# training default with ``model=<preset>``, as train_<preset>.json
MODEL_PRESETS = ("t5_base", "nwhisper_base", "moonshine_tiny")


def composed_train_preset(model: str, overrides=()):
    """``configs/train/default.yaml`` with ``model=<model>``, composed by the
    JAX loader from a copy of ``configs/`` holding the preset that says so
    (``T5_BASE_PRESET`` with the model's name)."""
    with tempfile.TemporaryDirectory() as tmp:
        configs = Path(tmp) / "configs"
        shutil.copytree(REPO_ROOT / "configs", configs)
        (configs / "train" / f"{model}.yaml").write_text(T5_BASE_PRESET.replace("t5_base", model))
        return compose(configs / "train", model, overrides=list(overrides), schema_cls=schema.TrainConfig)


def composed_train_t5_base(overrides=()):
    """``configs/train/default.yaml`` with ``model=t5_base``."""
    return composed_train_preset("t5_base", overrides)


def plain(node, keep_enums: bool = False):
    """Config tree -> JSON-shaped data (enums as values, or as (class name,
    value) pairs when kept)."""
    if dataclasses.is_dataclass(node):
        return {f.name: plain(getattr(node, f.name), keep_enums) for f in dataclasses.fields(node)}
    if isinstance(node, SimpleNamespace):
        return {k: plain(v, keep_enums) for k, v in vars(node).items()}
    if isinstance(node, dict):
        return {k: plain(v, keep_enums) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [plain(v, keep_enums) for v in node]
    if isinstance(node, Enum):  # each package has its own enum classes: compare by name and value
        return (type(node).__name__, node.value) if keep_enums else node.value
    return node


def test_checked_in_json_is_the_jax_composition():
    """The port's compose of v32, the schema dataclasses, field for field."""
    got = compose_config("inference", "v32", (), port_schema.InferenceConfig)
    assert plain(got, keep_enums=True) == plain(composed_v32(), keep_enums=True)


def test_loaded_namespace_equals_the_jax_config():
    """Every field, with ContextType values restored where the JAX config has them."""
    assert plain(load_config("v32"), keep_enums=True) == plain(composed_v32(), keep_enums=True)


@pytest.mark.parametrize("name", RECIPES)
def test_checked_in_train_json_is_the_jax_composition(name):
    got = compose_config("train", name, (), port_schema.TrainConfig)
    assert plain(got, keep_enums=True) == plain(composed_train(name), keep_enums=True)


@pytest.mark.parametrize("overrides", [
    (),
    ("data.dataset_type=ors", "optim.batch_size=4", "mixed_precision=no", "device=cpu",
     "model.overwrite.d_model=64", "data.dt_augment_range=[1.0, 1.5]", "optim.grad_clip=1.5"),
])
@pytest.mark.parametrize("name", RECIPES)
def test_loaded_train_namespace_equals_the_jax_config(name, overrides):
    """Every field, overrides applied the way the JAX loader applies them."""
    assert plain(load_train_config(name, overrides), keep_enums=True) == \
        plain(composed_train(name, overrides), keep_enums=True)


T5_OVERRIDES = ("mixed_precision=no", "model.overwrite.d_model=64", "model.spectrogram.implementation=pallas",
                "data.src_seq_len=256")


def test_checked_in_train_t5_base_json_is_the_jax_composition():
    got = compose_config("train", "t5_base", (), port_schema.TrainConfig)
    assert plain(got, keep_enums=True) == plain(composed_train_t5_base(), keep_enums=True)


@pytest.mark.parametrize("overrides", [(), T5_OVERRIDES])
def test_loaded_train_t5_base_namespace_equals_the_jax_config(overrides):
    assert plain(load_train_config("t5_base", overrides), keep_enums=True) == \
        plain(composed_train_t5_base(overrides), keep_enums=True)


@pytest.mark.parametrize("overrides", [(), T5_OVERRIDES])
def test_t5_build_config_matches_jax(overrides):
    """The T5 branch of ``build_config``, field by field: T5_DIMS["base"],
    head_dim_override 64, gated tanh-GELU, RMSNorm at 1e-6, unscaled and
    bias-free attention, bias-free feed-forward, no conv stem."""
    train = load_train_config("t5_base", overrides)
    got = dataclasses.asdict(build_config(train, build_vocabulary(train)))
    jax_train = composed_train_t5_base(overrides)
    want = dataclasses.asdict(jax_build_config(jax_train, jax_build_vocabulary(jax_train)))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert got == want
    b = got["backbone"]
    assert (b["position_scheme"], b["head_dim_override"], b["encoder_layers"], b["decoder_heads"], b["decoder_ffn"],
            b["conv_stem"], b["attention_scale"]) == ("t5_relpos", 64, 12, 12, 2048, False, False)


@pytest.mark.parametrize("model", ["nwhisper_base", "moonshine_tiny"])
def test_checked_in_train_json_of_each_backbone_is_the_jax_composition(model):
    got = compose_config("train", model, (), port_schema.TrainConfig)
    assert plain(got, keep_enums=True) == plain(composed_train_preset(model), keep_enums=True)


# (model preset, its backbone as build_config resolves it: name, norm scheme, stem, head dim, d_model, layers,
# ffn, decoder ffn gated, input_raw_wave)
BACKBONES = {"nwhisper_base": ("olibomby/nwhisper-base", "ngpt", "whisper", 64, 512, 6, 2048, False, False),
             "moonshine_tiny": ("UsefulSensors/moonshine-tiny", "prenorm", "moonshine", 36, 288, 6, 1152, True, True)}


@pytest.mark.parametrize("overrides", [(), ("mixed_precision=no", "data.src_seq_len=256")])
@pytest.mark.parametrize("model", ["nwhisper_base", "moonshine_tiny"])
def test_backbone_build_config_matches_jax(model, overrides):
    """The nGPT and moonshine branches of ``build_config``, field by field
    on the loaded namespace and the JAX composition, at full width."""
    train = load_train_config(model, overrides)
    jax_train = composed_train_preset(model, overrides)
    assert plain(train, keep_enums=True) == plain(jax_train, keep_enums=True)
    cfg = build_config(train, build_vocabulary(train))
    got = dataclasses.asdict(cfg)
    want = dataclasses.asdict(jax_build_config(jax_train, jax_build_vocabulary(jax_train)))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert got == want
    b = cfg.backbone
    assert (train.model.name, b.norm_scheme, b.stem_type, b.head_dim, b.d_model, b.encoder_layers, b.decoder_ffn,
            b.decoder_ffn_gated_concat, cfg.input_raw_wave) == BACKBONES[model]


def test_unknown_override_raises():
    """The schema's typo protection, in both loaders."""
    with pytest.raises(ConfigError, match="no_such_field"):
        load_train_config("v32", ["optim.no_such_field=1"])
    with pytest.raises(ConfigCompositionError, match="no_such_field"):
        composed_train("v32", ["optim.no_such_field=1"])


def test_plain_dict_fields_are_the_schemas_dict_fields():
    """The loaded namespace keeps exactly the JAX schema's dict-valued fields
    as dicts: every other config node is a namespace."""
    def dict_fields(node, path=""):
        if dataclasses.is_dataclass(node) or isinstance(node, SimpleNamespace):
            items = vars(node).items() if isinstance(node, SimpleNamespace) else \
                ((f.name, getattr(node, f.name)) for f in dataclasses.fields(node))
            return set().union(*(dict_fields(v, f"{path}.{k}" if path else k) for k, v in items))
        return {path} if isinstance(node, dict) else set()

    want = dict_fields(composed_v32())
    assert dict_fields(load_config("v32")) == want
    assert want == {f"train.{f}" for f in ("lora", "model.rope_scaling", "model.overwrite", "model.add_config")}


def test_vocabulary_matches_jax():
    want = jax_build_vocabulary(composed_v32().train).state_dict()
    assert build_vocabulary(load_config("v32").train).state_dict() == want
    assert build_vocabulary(load_train_config("v32")).state_dict() == want


def test_select_device_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("auto", "cuda", "gpu", "tpu"):
        with pytest.raises(RuntimeError, match="device=cpu"):
            select_device(SimpleNamespace(device=name))
    assert select_device(SimpleNamespace(device="cpu")) == torch.device("cpu")


def test_build_config_matches_jax():
    train = load_config("v32").train
    vocab = build_vocabulary(train)
    got = dataclasses.asdict(build_config(train, vocab))
    jax_train = composed_v32().train
    want = dataclasses.asdict(jax_build_config(jax_train, jax_build_vocabulary(jax_train)))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert got == want
    assert got["backbone"]["dtype"] == "bfloat16" and build_config(train, vocab).backbone.dtype == torch.bfloat16

