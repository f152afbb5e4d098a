"""The port's checked-in v32 configs against the JAX loader.

``mapperatorinator_tpu_torch/configs/v32.json`` is the JAX composition of
``configs/inference/v32.yaml`` and ``configs/train_v32.json`` that of
``configs/train/v32.yaml``, written out as JSON, so the port reads them
without yaml. These tests recompose them and fail on any drift. To regenerate
the files after a config change: ``JAX_PLATFORMS=cpu python -m tests.test_torch_config``.
"""

import dataclasses
import json
from enum import Enum
from types import SimpleNamespace

import torch

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.mapperatorinator import build_config as jax_build_config
import pytest

from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu_torch.config import (
    CONFIG_DIR,
    PLAIN_DICT_FIELDS,
    TRAIN_DICT_FIELDS,
    load_config,
    load_train_config,
    select_device,
)
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT


def composed_v32():
    return compose(REPO_ROOT / "configs" / "inference", "v32", schema_cls=schema.InferenceConfig)


def composed_train_v32(overrides=()):
    return compose(REPO_ROOT / "configs" / "train", "v32", overrides=list(overrides), schema_cls=schema.TrainConfig)


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
    with open(CONFIG_DIR / "v32.json", encoding="utf-8") as f:
        assert json.load(f) == plain(composed_v32())


def test_loaded_namespace_equals_the_jax_config():
    """Every field, with ContextType values restored where the JAX config has them."""
    assert plain(load_config("v32"), keep_enums=True) == plain(composed_v32(), keep_enums=True)


def test_checked_in_train_json_is_the_jax_composition():
    with open(CONFIG_DIR / "train_v32.json", encoding="utf-8") as f:
        assert json.load(f) == plain(composed_train_v32())


@pytest.mark.parametrize("overrides", [
    (),
    ("data.dataset_type=ors", "optim.batch_size=4", "mixed_precision=no", "device=cpu",
     "model.overwrite.d_model=64", "data.dt_augment_range=[1.0, 1.5]", "optim.grad_clip=1.5"),
])
def test_loaded_train_namespace_equals_the_jax_config(overrides):
    """Every field, overrides applied the way the JAX loader applies them."""
    assert plain(load_train_config("v32", overrides), keep_enums=True) == \
        plain(composed_train_v32(overrides), keep_enums=True)


def test_unknown_override_raises():
    with pytest.raises(KeyError):
        load_train_config("v32", ["optim.no_such_field=1"])


def test_plain_dict_fields_are_the_schemas_dict_fields():
    found = set()

    def walk(node, path):
        if dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), f"{path}.{f.name}" if path else f.name)
        elif isinstance(node, dict):
            found.add(path)

    walk(composed_v32(), "")
    assert found == set(PLAIN_DICT_FIELDS)
    assert {f"train.{f}" for f in TRAIN_DICT_FIELDS} == set(PLAIN_DICT_FIELDS)


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


if __name__ == "__main__":
    for name, tree in (("v32", composed_v32()), ("train_v32", composed_train_v32())):
        with open(CONFIG_DIR / f"{name}.json", "w", encoding="utf-8") as f:
            json.dump(plain(tree), f, indent=1, sort_keys=True)
            f.write("\n")
