"""The port's configurations, composed from the repo's ``configs/**/*.yaml``
as the JAX scripts compose them, and the device choice.

Each loader composes ``configs/<group>/<name>.yaml`` with its defaults,
applies the dotted ``key=value`` overrides before the interpolations
resolve (so ``model.spectrogram.hop_length=256`` reaches
``data.hop_length``), and structures the tree through the schema class the
matching JAX script uses (:mod:`.loader`, :mod:`.schema`; the YAML is read
by :mod:`.yaml_reader`, without the ``yaml`` package). The result comes
back as nested attribute namespaces, with the ``ContextType`` fields
restored and the schema's dict-valued fields (``lora``,
``model.rope_scaling``, ``model.overwrite``, ``model.add_config``) as
dicts, so the host code copied from the JAX package reads it like the JAX
config dataclasses.

A training name that ``configs/train/`` lacks is looked up among the port's
own presets (``mapperatorinator_tpu_torch/configs/train/``: ``t5_base``,
``nwhisper_base`` and ``moonshine_tiny``, ``configs/train/default.yaml``
with ``model=<name>``), which compose as if they lay in ``configs/train/``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable

import torch

from . import schema
from .loader import ConfigError, compose, parse_value  # noqa: F401

CONFIGS = Path(__file__).resolve().parents[2] / "configs"  # the repo's configs/, which the JAX scripts compose
PORT_CONFIGS = Path(__file__).resolve().parents[1] / "configs"  # the port's own presets


def load_config(name: str = "v32", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/inference/<name>.yaml`` (``InferenceConfig``) -> nested namespaces."""
    return _load("inference", name, overrides, schema.InferenceConfig)


def load_train_config(name: str = "v32", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/train/<name>.yaml`` (``TrainConfig``), or the port's preset
    of that name -> nested namespaces."""
    return _load("train", name, overrides, schema.TrainConfig)


def load_mai_mod_config(name: str = "mai_mod", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/<name>.yaml``, a MaiMod config (``MaiModConfig``: the paths,
    ``raw_output`` and ``precision``, and an inference config under
    ``inference``; ``inference.*`` overrides reach the nested one) -> nested
    namespaces."""
    return _load("", name, overrides, schema.MaiModConfig)


def load_classifier_config(name: str = "train_v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/classifier/<name>.yaml``, a mapper-classifier config
    (``ClassifierConfig``) -> nested namespaces."""
    return _load("classifier", name, overrides, schema.ClassifierConfig)


def load_rcomplexion_config(name: str = "inference_v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/rcomplexion/<name>.yaml``, a rhythm-complexity config
    (``RcomplexionConfig``) -> nested namespaces."""
    return _load("rcomplexion", name, overrides, schema.RcomplexionConfig)


def load_fid_config(name: str = "calc_fid", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/<name>.yaml``, an evaluation-harness config (``FidConfig``:
    the dataset scan, the metrics to compute and an inference config under
    ``inference``) -> nested namespaces."""
    return _load("", name, overrides, schema.FidConfig)


def load_diffusion_config(name: str = "v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/diffusion/<name>.yaml``, the ``DiffusionTrainConfig`` a DiT
    was trained with -> nested namespaces."""
    return _load("diffusion", name, overrides, schema.DiffusionTrainConfig)


def compose_config(group: str, name: str, overrides: Iterable[str], schema_cls: type):
    """``configs/<group>/<name>.yaml`` (``group`` "" for ``configs/``), else
    the port's preset of that name, composed into ``schema_cls``."""
    return compose(CONFIGS / group, name, list(overrides), schema_cls, extra_dir=PORT_CONFIGS / group)


def _load(group: str, name: str, overrides: Iterable[str], schema_cls: type) -> SimpleNamespace:
    return as_namespace(compose_config(group, name, overrides, schema_cls))


def as_namespace(node):
    """A schema dataclass tree as nested namespaces; every other value (the
    dict-valued fields, lists, ``ContextType``) as it is."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return SimpleNamespace(**{f.name: as_namespace(getattr(node, f.name)) for f in dataclasses.fields(node)})
    return node


# the JAX ``DataConfig()`` defaults of the fields the beatmap parser reads:
# the base of the parser settings that CM3P's feature extractor and the
# classifier bundle loader build (tests/test_torch_cm3p.py holds them to
# the schema)
PARSER_DATA_DEFAULTS = {
    "types_first": True, "add_timing": False, "add_snapping": True, "add_timing_points": True,
    "add_hitsounds": True, "add_distances": True, "add_positions": True, "add_kiai": True, "add_sv": True,
    "add_mania_sv": False, "mania_bpm_normalized_scroll_speed": True, "position_precision": 32,
    "position_split_axes": False, "position_refinement": None, "position_range": [-256, 768, -256, 640],
    "slider_version": 1, "sustain_interval": None, "src_seq_len": 1024, "tgt_seq_len": 2048,
}


def parse_argv(argv, config_name: str, flags: dict) -> tuple[str, list[str], dict]:
    """The scripts' command line: ``-cn NAME`` (or ``--config-name``), the
    flags of ``flags`` (``{"time=": 0.0}`` takes ``time=S``, ``{"-o": path}``
    takes ``-o PATH``; each value's type converts the argument) and the
    config overrides. Returns (config name, overrides, flag values)."""
    values, overrides = dict(flags), []
    i = 0
    while i < len(argv):
        if argv[i] in ("-cn", "--config-name"):
            config_name = argv[i + 1]
            i += 2
        elif any(argv[i].startswith(f) for f in flags if f.endswith("=")):
            flag, raw = argv[i].split("=", 1)
            values[flag + "="] = type(flags[flag + "="])(raw)
            i += 1
        elif argv[i] in flags:
            values[argv[i]] = type(flags[argv[i]])(argv[i + 1])
            i += 2
        else:
            overrides.append(argv[i])
            i += 1
    return config_name, overrides, values


def select_device(args) -> torch.device:
    """``args.device``: "cpu" gives the CPU. "auto", "cuda", "gpu" and "tpu"
    (the JAX configs' default) give the first CUDA device, and raise where
    none is visible: nothing falls back to the CPU unless asked to."""
    if args.device in ("auto", "gpu", "cuda", "tpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={args.device!r}: no CUDA device is visible (ask for device=cpu to run "
                               "on the CPU)")
        return torch.device("cuda")
    return torch.device(args.device)
