"""Resolved configurations, readable without yaml, and the device choice.

``configs/<name>.json`` is the JAX loader's composition of
``configs/inference/<name>.yaml`` (the nested training config included;
v32, v32-mini, v31, v30, v29 and v28),
``configs/train_<name>.json`` that of ``configs/train/<name>.yaml`` (v32,
v32-mini, v28, v29, and the fine-tune configs ``v32_ft``, ``v32-mini_ft``, ``lora``
and ``lora_v32``; ``t5_base`` is ``configs/train/default.yaml`` with
``model=t5_base``, the T5 v1.1-base of the legacy checkpoints), and
``configs/mai_mod.json`` that of ``configs/mai_mod.yaml``,
``configs/classifier_train_v1.json`` that of
``configs/classifier/train_v1.yaml``, ``configs/rcomplexion_<name>.json``
that of ``configs/rcomplexion/<name>.yaml`` (``train_v1`` and
``inference_v1``) and ``configs/calc_fid.json`` that of
``configs/calc_fid.yaml`` (the v32 inference config under ``inference``),
each written out once and checked in (a DiT's diffusion config, ``configs/diffusion/v1.yaml``,
is the ``diffusion`` node of ``v32.json``: :func:`load_diffusion_config`);
``tests/test_torch_config.py`` and ``tests/test_torch_configs_more.py``
recompose them and fail if they drift apart. :func:`load_config`, :func:`load_train_config`,
:func:`load_mai_mod_config`, :func:`load_classifier_config`,
:func:`load_rcomplexion_config` and :func:`load_fid_config` turn them into attribute namespaces with the
``ContextType`` fields restored, so the host code copied from the JAX package
(vocabulary, parser, renderer, data pipeline) reads them like the JAX config
dataclasses. Both take dotted ``key=value`` overrides, as the JAX loader does.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable

import torch

from .osu.events import ContextType

CONFIG_DIR = Path(__file__).resolve().parent / "configs"

# dict-valued fields of the training config schema: these stay dicts, every
# other mapping is a config node and becomes a namespace
TRAIN_DICT_FIELDS = frozenset({"lora", "model.rope_scaling", "model.overwrite", "model.add_config"})
# the same fields under the inference config's nested ``train`` node
PLAIN_DICT_FIELDS = frozenset(f"train.{f}" for f in TRAIN_DICT_FIELDS)
_DICT_FIELD_NAMES = frozenset(f.rsplit(".", 1)[-1] for f in TRAIN_DICT_FIELDS)


def load_config(name: str = "v32", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/<name>.json`` with ``overrides`` applied -> nested namespaces."""
    with open(CONFIG_DIR / f"{name}.json", encoding="utf-8") as f:
        tree = json.load(f)
    return _inference_namespaces(apply_overrides(tree, overrides))


def load_train_config(name: str = "v32", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/train_<name>.json`` with ``overrides`` applied -> nested namespaces."""
    with open(CONFIG_DIR / f"train_{name}.json", encoding="utf-8") as f:
        tree = json.load(f)
    return _train_namespaces(apply_overrides(tree, overrides))


def load_mai_mod_config(name: str = "mai_mod", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/<name>.json``, a MaiMod config (the JAX ``MaiModConfig``: the
    paths, ``raw_output`` and ``precision``, and an inference config under
    ``inference``), with ``overrides`` applied (``inference.*`` for the
    nested one) -> nested namespaces."""
    return _load_with_inference(name, overrides)


def load_classifier_config(name: str = "train_v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/classifier_<name>.json``, a mapper-classifier config (the JAX
    ``ClassifierConfig``), with ``overrides`` applied -> nested namespaces."""
    with open(CONFIG_DIR / f"classifier_{name}.json", encoding="utf-8") as f:
        tree = json.load(f)
    args = _namespace(apply_overrides(tree, overrides), "", frozenset())
    _restore_context_types(args)
    return args


def load_rcomplexion_config(name: str = "inference_v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/rcomplexion_<name>.json``, a rhythm-complexity config (the
    JAX ``RcomplexionConfig``), with ``overrides`` applied -> nested
    namespaces."""
    with open(CONFIG_DIR / f"rcomplexion_{name}.json", encoding="utf-8") as f:
        tree = json.load(f)
    return _namespace(apply_overrides(tree, overrides), "", frozenset())


def load_fid_config(name: str = "calc_fid", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/<name>.json``, an evaluation-harness config (the JAX
    ``FidConfig``: the dataset scan, the metrics to compute and an inference
    config under ``inference``), with ``overrides`` applied (``inference.*``
    for the nested one) -> nested namespaces."""
    return _load_with_inference(name, overrides)


def _load_with_inference(name: str, overrides: Iterable[str]) -> SimpleNamespace:
    """``configs/<name>.json``, flat fields and an inference config under
    ``inference``."""
    with open(CONFIG_DIR / f"{name}.json", encoding="utf-8") as f:
        tree = apply_overrides(json.load(f), overrides)
    args = SimpleNamespace(**{k: v for k, v in tree.items() if k != "inference"})
    args.inference = _inference_namespaces(tree["inference"])
    return args


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


# configs/diffusion/<name>.yaml -> the resolved inference config whose
# ``diffusion`` node composes it
DIFFUSION_CONFIGS = {"v1": "v32"}


def load_diffusion_config(name: str = "v1", overrides: Iterable[str] = ()) -> SimpleNamespace:
    """``configs/diffusion/<name>.yaml`` as the JAX loader composes it (the
    ``DiffusionTrainConfig`` a DiT was trained with), with ``overrides``
    applied -> nested namespaces."""
    if name not in DIFFUSION_CONFIGS:
        raise ValueError(f"no resolved diffusion config {name!r}: the port has {sorted(DIFFUSION_CONFIGS)}")
    with open(CONFIG_DIR / f"{DIFFUSION_CONFIGS[name]}.json", encoding="utf-8") as f:
        tree = json.load(f)["diffusion"]
    return _namespace(apply_overrides(tree, overrides), "", frozenset())


def _inference_namespaces(tree: dict) -> SimpleNamespace:
    args = _namespace(tree, "", PLAIN_DICT_FIELDS)
    args.in_context = [ContextType(c) for c in args.in_context]
    args.output_type = [ContextType(c) for c in args.output_type]
    _restore_context_types(args.train)
    return args


def _train_namespaces(tree: dict) -> SimpleNamespace:
    args = _namespace(tree, "", TRAIN_DICT_FIELDS)
    _restore_context_types(args)
    return args


def _restore_context_types(train) -> None:
    train.data.context_types = [
        {"in": [ContextType(c) for c in ct["in"]], "out": [ContextType(c) for c in ct["out"]]}
        for ct in train.data.context_types
    ]


# YAML 1.1 scalars that are not JSON (PyYAML's safe_load reads ``no`` as False)
_YAML_WORDS = {
    **{w: True for w in ("True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON")},
    **{w: False for w in ("False", "FALSE", "no", "No", "NO", "off", "Off", "OFF")},
    **{w: None for w in ("Null", "NULL", "~")},
}


def parse_value(raw: str):
    """The value of a ``key=value`` override as the JAX loader's YAML reads
    it: JSON where it parses (numbers, ``true``/``false``/``null``, lists,
    quoted strings), YAML 1.1's other booleans and nulls, else the string."""
    if raw == "":
        return None
    try:
        return json.loads(raw)
    except ValueError:
        return _YAML_WORDS.get(raw, raw)


def apply_overrides(tree: dict, overrides: Iterable[str]) -> dict:
    """Dotted ``key=value`` overrides on a resolved tree, in place. A key
    must name a field the tree has, except inside a dict-valued field."""
    for override in overrides:
        key, sep, raw = override.partition("=")
        if not sep:
            raise ValueError(f"override {override!r} must be key=value")
        *parents, leaf = key.lstrip("+~").split(".")
        node = tree
        for part in parents:
            if not isinstance(node.get(part), dict):
                raise KeyError(f"override {override!r}: the config has no node {part!r}")
            node = node[part]
        if leaf not in node and (parents or [""])[-1] not in _DICT_FIELD_NAMES:
            raise KeyError(f"override {override!r}: the config has no field {key!r}")
        node[leaf] = parse_value(raw)
    return tree


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


def _namespace(node, path: str, plain_fields: frozenset):
    if isinstance(node, dict) and path not in plain_fields and not path.endswith("data.context_types"):
        return SimpleNamespace(**{
            k: _namespace(v, f"{path}.{k}" if path else k, plain_fields) for k, v in node.items()
        })
    return node
