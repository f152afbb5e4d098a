"""Resolved configurations, readable without yaml, and the device choice.

``configs/<name>.json`` is the JAX loader's composition of
``configs/inference/<name>.yaml`` (the nested training config included), and
``configs/train_<name>.json`` that of ``configs/train/<name>.yaml``, each
written out once and checked in; ``tests/test_torch_config.py`` recomposes
them and fails if they drift apart. :func:`load_config` and
:func:`load_train_config` turn them into attribute namespaces with the
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
