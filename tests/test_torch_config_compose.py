"""The port's composition (``mapperatorinator_tpu_torch/config/``) against the
JAX loader's ``compose``, field for field, types and enums included:

* every composable file under ``configs/`` (all but the 16 model
  fragments), with no overrides and with a set that writes YAML 1.1 forms
  into typed fields, adds a ``+new`` key inside a dict-valued field, merges
  a flow mapping into one, and moves ``model.spectrogram``; an unknown key
  raises in both;
* the fault the JSON configs had: ``model.spectrogram.hop_length`` and
  ``sample_rate`` overrides reach ``data.hop_length`` and
  ``data.sample_rate``, which ``configs/train/default.yaml`` derives from
  them, under ``-cn v32`` in training and in inference;
* the port's three backbone presets, whose text is what the JAX tests
  write into a copy of ``configs/``;
* the Hydra workflow and the legacy layout on files written here: a user's
  recipe beside the repo's, and presets in the v1-v18 era layout (an
  ``osut5`` group, ``legacy/`` subdirectories, a bare ``- inference`` base
  with a top-level ``model``).
"""

import shutil

import pytest

from mapperatorinator_tpu.config import compose as jax_compose
from mapperatorinator_tpu.config import schema as jax_schema
from mapperatorinator_tpu.config.loader import ConfigCompositionError
from mapperatorinator_tpu_torch.config import (ConfigError, PORT_CONFIGS, compose, compose_config, load_config,
                                               load_train_config)
from mapperatorinator_tpu_torch.config import schema as port_schema
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_torch_config import T5_BASE_PRESET, plain

SCHEMAS = {"train": "TrainConfig", "inference": "InferenceConfig", "diffusion": "DiffusionTrainConfig",
           "classifier": "ClassifierConfig", "rcomplexion": "RcomplexionConfig"}


def composable():
    """(group, name, schema class name) of every file the JAX scripts compose."""
    out = []
    for path in sorted((REPO_ROOT / "configs").rglob("*.yaml")):
        group = path.parent.relative_to(REPO_ROOT / "configs").as_posix()
        if group == "model":
            continue
        if group == ".":
            out.append(("", path.stem, "FidConfig" if "fid" in path.stem else "MaiModConfig"))
        else:
            out.append((group, path.stem, SCHEMAS[group]))
    return out


COMPOSABLE = composable()
TRAIN_OVERRIDES = ("+model.overwrite.new_key=1e-3", "model.overwrite={d_model: 64, note: 010}", "+lora.r=0x8",
                   "optim.base_lr=1e-3", "seed=010", "mixed_precision=no", "data.gamemodes=[0, 3]",
                   "data.dt_augment_range=[1., 1.2]", "model.spectrogram.hop_length=256")
INFERENCE_OVERRIDES = ("+train.model.add_config.extra=0x10",
                       "train.model.rope_scaling={factor: 2., rope_type: dynamic}", "cfg_scale=1e-3", "seed=1_000",
                       "output_type=[TIMING, MAP]", "in_context=[none]", "descriptors=[clean, 'tech']", "year=2_020",
                       "train.model.spectrogram.sample_rate=22050")
NESTED = tuple("+inference." + o[1:] if o.startswith("+") else "inference." + o for o in INFERENCE_OVERRIDES)
OVERRIDES = {
    "TrainConfig": TRAIN_OVERRIDES,
    "InferenceConfig": INFERENCE_OVERRIDES,
    "MaiModConfig": ("beatmap_path=a.osu", "raw_output=yes", *NESTED),
    "FidConfig": ("skip_generation=on", "gamemodes=[0, 3]", "num_processes=00", *NESTED),
    "DiffusionTrainConfig": ("model.diffusion_steps=1_000", "optim.base_lr=2e-4", "data.seq_len=0x80",
                             "precision=fp32", "data.shuffle=off"),
    "ClassifierConfig": ("model.spectrogram.hop_length=256", "data.src_seq_len=010", "optim.base_lr=1e-3",
                         "model.input_features=yes", "data.dt_augment_range=[1., 1.2]"),
    "RcomplexionConfig": ("model.hidden_size=0x10", "data.time_resolution=.5", "optim.batch_size=1_024",
                          "data.sample_weights=w.csv"),
}


def both(config_dir, name, overrides, schema_name):
    """(the port's compose, the JAX compose) of ``<config_dir>/<name>.yaml``."""
    got = compose(config_dir, name, list(overrides), getattr(port_schema, schema_name))
    want = jax_compose(config_dir, name, overrides=list(overrides), schema_cls=getattr(jax_schema, schema_name))
    return got, want


def test_every_composable_config_is_covered():
    assert len(COMPOSABLE) == 24 and {s for _, _, s in COMPOSABLE} == set(OVERRIDES)


@pytest.mark.parametrize("with_overrides", [False, True], ids=["defaults", "overrides"])
@pytest.mark.parametrize("group,name,schema_name", COMPOSABLE, ids=[f"{g}/{n}".lstrip("/") for g, n, _ in COMPOSABLE])
def test_compose_equals_jax(group, name, schema_name, with_overrides):
    overrides = OVERRIDES[schema_name] if with_overrides else ()
    got, want = both(REPO_ROOT / "configs" / group, name, overrides, schema_name)
    assert plain(got, keep_enums=True) == plain(want, keep_enums=True)
    if with_overrides and schema_name == "TrainConfig":  # YAML 1.1 in a dict-valued field stays as it reads
        assert got.model.overwrite["new_key"] == "1e-3" and got.model.overwrite["note"] == 8
        assert got.model.overwrite["d_model"] == 64 and got.optim.base_lr == 0.001 and got.data.hop_length == 256


@pytest.mark.parametrize("group,name,schema_name", COMPOSABLE, ids=[f"{g}/{n}".lstrip("/") for g, n, _ in COMPOSABLE])
def test_an_unknown_key_raises_in_both(group, name, schema_name):
    with pytest.raises(ConfigError, match="no_such_key"):
        compose_config(group, name, ["no_such_key=1"], getattr(port_schema, schema_name))
    with pytest.raises(ConfigCompositionError, match="no_such_key"):
        jax_compose(REPO_ROOT / "configs" / group, name, overrides=["no_such_key=1"],
                    schema_cls=getattr(jax_schema, schema_name))


@pytest.mark.parametrize("field,value", [("hop_length", 256), ("sample_rate", 22050)])
@pytest.mark.parametrize("kind", ["train", "inference"])
def test_a_spectrogram_override_reaches_the_data_config(kind, field, value):
    """``configs/train/default.yaml`` derives ``data.<field>`` from
    ``model.spectrogram.<field>``: an override of the latter moves both."""
    prefix = "" if kind == "train" else "train."
    override = f"{prefix}model.spectrogram.{field}={value}"
    schema_name = SCHEMAS[kind]
    want = jax_compose(REPO_ROOT / "configs" / kind, "v32", overrides=[override],
                       schema_cls=getattr(jax_schema, schema_name))
    got = (load_train_config if kind == "train" else load_config)("v32", [override])
    got_train, want_train = (got, want) if kind == "train" else (got.train, want.train)
    assert getattr(got_train.data, field) == getattr(want_train.data, field) == value
    assert getattr(got_train.model.spectrogram, field) == getattr(want_train.model.spectrogram, field) == value


@pytest.mark.parametrize("model", ["t5_base", "nwhisper_base", "moonshine_tiny"])
def test_the_port_presets_are_the_preset_text(model):
    """The port keeps ``configs/train/default.yaml`` with ``model=<model>`` in
    the four lines the JAX tests compose from a copy of ``configs/``."""
    assert (PORT_CONFIGS / "train" / f"{model}.yaml").read_text() == T5_BASE_PRESET.replace("t5_base", model)
    assert not (REPO_ROOT / "configs" / "train" / f"{model}.yaml").exists()


@pytest.fixture
def configs(tmp_path):
    """A copy of the repo's ``configs/`` to write presets into."""
    shutil.copytree(REPO_ROOT / "configs", tmp_path / "configs")
    return tmp_path / "configs"


USER_RECIPE = """\
# a user's recipe beside the repo's: v32 on whisper-base, a small batch, its own maps
defaults:
  - v32
  - ../model@model: whisper_base
  - _self_

optim:
  batch_size: 8
  base_lr: 1e-3   # a string until the schema makes it a float
data:
  train_dataset_path: "/data/my maps"
  gamemodes: [0]
  context_types:
    - "in": ['${context_type:none}']
      "out": ['${context_type:map}', '${context_type:sv}']
model:
  overwrite:
    d_model: 384
"""


@pytest.mark.parametrize("overrides", [(), TRAIN_OVERRIDES], ids=["defaults", "overrides"])
def test_a_users_recipe_composes_as_in_jax(configs, overrides):
    (configs / "train" / "my_recipe.yaml").write_text(USER_RECIPE)
    got, want = both(configs / "train", "my_recipe", overrides, "TrainConfig")
    assert plain(got, keep_enums=True) == plain(want, keep_enums=True)
    assert got.optim.batch_size == 8 and got.model.name == "openai/whisper-base"


LEGACY = {  # files of the v1-v18 era layout, relative to configs/
    "inference/legacy/inference_v7.yaml": """\
defaults:
  - inference
  - osut5: train_v7
  - _self_

model:
  name: 'google/t5-v1_1-small'
  overwrite:
    dropout_rate: 0.0
temperature: 0.8
in_context: [NONE]
""",
    "inference/legacy/train_v7.yaml": """\
defaults:
  - train
  - _self_

data:
  src_seq_len: 512
  context_types:
    - {"in": ["none"], "out": "timing"}
    - {"in": ["timing"], "out": ["map"]}
""",
    "train/legacy/tiny41.yaml": """\
defaults:
  - default
  - ../model@model: t5_small
  - _self_

optim:
  base_lr: 1e-3
""",
    "inference/legacy/inference_v41.yaml": """\
defaults:
  - default
  - ../train@train: tiny41
  - _self_

version: 'tiny41'
""",
}


@pytest.mark.parametrize("directory,name,schema_name,derived", [
    # osut5, a bare base (the TrainConfig defaults: data.hop_length a plain 128), a top-level model
    ("inference/legacy", "inference_v7", "InferenceConfig", False),
    # default and tiny41 through legacy/ fallbacks; train/default.yaml derives data.hop_length
    ("inference", "legacy/inference_v41", "InferenceConfig", True),
    ("train/legacy", "tiny41", "TrainConfig", True),
], ids=["osut5", "legacy-fallbacks", "legacy-train"])
@pytest.mark.parametrize("overrides", [(), ("train.model.spectrogram.hop_length=64", "temperature=.5")],
                         ids=["defaults", "overrides"])
def test_legacy_layout_presets_compose_as_in_jax(configs, directory, name, schema_name, derived, overrides):
    for relative, text in LEGACY.items():
        (configs / relative).parent.mkdir(parents=True, exist_ok=True)
        (configs / relative).write_text(text)
    if schema_name == "TrainConfig":
        overrides = tuple(o.removeprefix("train.") for o in overrides if o.startswith("train."))
    got, want = both(configs / directory, name, overrides, schema_name)
    assert plain(got, keep_enums=True) == plain(want, keep_enums=True)
    train = got if schema_name == "TrainConfig" else got.train
    assert train.model.name == "google/t5-v1_1-small"
    assert train.data.hop_length == (64 if overrides and derived else 128)
