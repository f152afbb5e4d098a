"""Hydra-style composition of the repo's ``configs/**/*.yaml``, the port's
own, doing what the JAX loader (``mapperatorinator_tpu/config/loader.py``)
does, with the YAML read by :mod:`.yaml_reader`:

* ``defaults:`` lists: group entries (``- default``,
  ``- ../model@model: varwhisper_small_v3``, ``- inference: v32``), the
  structured bases of :data:`STRUCTURED` (``- /train/base@_here_``,
  ``- base_fid``), ``- _self_`` ordering, and ``- override hydra/...``
  entries (ignored);
* the legacy layout of the v1-v18 era presets: the ``osut5`` group, the
  ``legacy/`` fallbacks of :func:`find_default`, and the top-level ``model``
  of a legacy inference preset;
* dotted ``key=value`` overrides (``+``/``~`` prefixes, a mapping value
  merged into a mapping), applied before interpolation;
* interpolation: relative and absolute references
  (``${..model.spectrogram.hop_length}``) and the ``context_type:``,
  ``now:`` and ``hydra.`` resolvers;
* structuring into the dataclasses of :mod:`.schema` (unknown keys raise,
  values coerced to the field types, enums by value or by name), then the
  ``ContextType`` fields normalised.

A name found neither in ``config_dir`` nor beside it is looked up in
``extra_dir`` (the port's own presets), and composes as if it lay in
``config_dir``.
"""

from __future__ import annotations

import dataclasses
import datetime
import re
import typing
from enum import Enum
from pathlib import Path
from typing import Any, Optional, Type, Union

from ..osu.events import ContextType
from . import schema
from .yaml_reader import load_file, load_string

# Hydra "structured config" nodes, as the reference's ConfigStore registers them
STRUCTURED: dict[str, type] = {
    "train/base": schema.TrainConfig,
    "inference/base": schema.InferenceConfig,
    "diffusion/base": schema.DiffusionTrainConfig,
    "base_fid": schema.FidConfig,
    "base_mai_mod": schema.MaiModConfig,
    # the v1-v18 era legacy presets name the structured bases bare: ``- inference`` / ``- train``
    "inference": schema.InferenceConfig,
    "train": schema.TrainConfig,
}

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class ConfigError(ValueError):
    """A config that does not compose: a missing file or default, a bad
    defaults entry or override, or a key the schema does not have."""


# --- dict utilities ------------------------------------------------------------------------------------------------


def deep_merge(dst: dict, src: dict) -> dict:
    """Recursively merge ``src`` into ``dst`` (src wins). Returns dst."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def _dataclass_to_dict(obj: Any) -> Any:
    """Like dataclasses.asdict but keeps enums and non-dataclass leaves intact."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _dataclass_to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [_dataclass_to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _dataclass_to_dict(v) for k, v in obj.items()}
    return obj


def _set_path(root: dict, path: str, value: dict) -> None:
    node = root
    if path:
        for part in path.split("."):
            node = node.setdefault(part, {})
    deep_merge(node, value)


# --- composition ---------------------------------------------------------------------------------------------------


def parse_default_entry(entry) -> Optional[tuple[str, str, Optional[str]]]:
    """(group path, name, package) of a defaults entry, or None for one to
    skip. The group path is relative to the directory of the file that
    declares the entry (absolute where it starts with '/'); a package of
    None merges at the current node, else under that dotted path."""
    if isinstance(entry, str):
        key, name = entry, None
    elif isinstance(entry, dict) and len(entry) == 1:
        (key, name), = entry.items()
    else:
        raise ConfigError(f"unparseable defaults entry: {entry!r}")

    if key == "_self_":
        return ("_self_", "", None)
    if key.startswith("override "):
        return None

    package = None
    if "@" in key:
        key, package = key.split("@", 1)
        if package == "_here_":
            package = ""
    if name is None:
        # "- default" or "- base_fid" or "- /train/base@_here_"
        group, _, name = key.rpartition("/")
        return (group or ".", name, package)
    return (key, name, package or key.split("/")[-1])


def compose_file(path: Path, root_dir: Path, here: Optional[Path] = None) -> dict:
    """The tree of ``path`` with its defaults composed in, as if the file
    lay in ``here`` (its own directory by default)."""
    here = path.parent if here is None else here
    body = load_file(path) or {}
    if not isinstance(body, dict):
        raise ConfigError(f"{path}: top level must be a mapping")

    defaults = body.pop("defaults", None)
    if defaults is None:
        return body

    result: dict = {}
    saw_self = False
    for raw in defaults:
        parsed = parse_default_entry(raw)
        if parsed is None:
            continue
        group, name, package = parsed
        if group == "_self_":
            deep_merge(result, body)
            saw_self = True
            continue

        # the v1-v18 era legacy presets nest the training recipe under the historical group name 'osut5'; the
        # modern schema field is 'train' and the recipe file sits next to the preset
        if group == "osut5":
            group, package = ".", "train"

        structured_key = f"{group.lstrip('/')}/{name}".lstrip("/") if group not in (".", "") else name
        if structured_key in STRUCTURED or name in STRUCTURED:
            cls = STRUCTURED.get(structured_key) or STRUCTURED[name]
            sub = _dataclass_to_dict(cls())
        else:
            if group.startswith("/"):
                sub_dir = root_dir / group.lstrip("/")
            elif group == ".":
                sub_dir = here
            else:
                sub_dir = (here / group).resolve()
            sub_path = find_default(sub_dir, here, group, name)
            if sub_path is None:
                raise ConfigError(f"{path}: default '{raw}' not found at {sub_dir / (name + '.yaml')}")
            sub = compose_file(sub_path, root_dir)

        _set_path(result, package or "", sub)

    if not saw_self:
        deep_merge(result, body)
    return result


def find_default(sub_dir: Path, here: Path, group: str, name: str) -> Optional[Path]:
    """A defaults entry's file, with the legacy layout's fallbacks.

    Presets under a ``legacy/`` subdirectory name their group siblings as if
    they still lived one level up (``- default``, ``- ../train@train:
    tiny41`` where tiny41 is itself a legacy preset), so after the primary
    location come the parent directory and the target group's own
    ``legacy/`` subdirectory."""
    fname = f"{name}.yaml"
    candidates = [sub_dir / fname, sub_dir / "legacy" / fname]
    up = here.parent
    if group in (".", ""):
        candidates.append(up / fname)
    else:
        resolved = (up / group).resolve()
        candidates += [resolved / fname, resolved / "legacy" / fname]
    for c in candidates:
        if c.exists():
            return c
    return None


# --- interpolation -------------------------------------------------------------------------------------------------


def _lookup(root: dict, node_path: list[str], ref: str) -> Any:
    if ref.startswith("."):
        # OmegaConf semantics: one dot = the node containing the key, each extra dot = one level further up
        n_dots = len(ref) - len(ref.lstrip("."))
        rest = ref.lstrip(".")
        base = node_path[: max(0, len(node_path) - n_dots)]
    else:
        rest, base = ref, []
    node: Any = root
    for part in base:
        node = node[part]
    for part in rest.split(".") if rest else []:
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"interpolation target '{ref}' not found")
        node = node[part]
    return node


def _resolve_value(value: Any, root: dict, node_path: list[str]) -> Any:
    if isinstance(value, str):
        m = _INTERP_RE.fullmatch(value.strip())
        if m:
            return _resolve_expr(m.group(1), root, node_path)

        # partial interpolation inside a larger string
        def sub(mm):
            return str(_resolve_expr(mm.group(1), root, node_path))
        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_expr(expr: str, root: dict, node_path: list[str]) -> Any:
    if expr.startswith("context_type:"):
        return ContextType(expr.split(":", 1)[1].lower())
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr.split(":", 1)[1])
    if expr.startswith("hydra."):
        return ""
    val = _lookup(root, node_path, expr)
    return _resolve_value(val, root, node_path)


def resolve_interpolations(tree: dict) -> dict:
    def walk(node: Any, path: list[str]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        return _resolve_value(node, tree, path)

    return walk(tree, [])


# --- structuring into dataclasses ----------------------------------------------------------------------------------


def _coerce(value: Any, tp: Any) -> Any:
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0]) if len(args) == 1 else value
    if dataclasses.is_dataclass(tp):
        return structure(tp, value if isinstance(value, dict) else {})
    if origin in (list, tuple):
        args = typing.get_args(tp)
        elem = args[0] if args else Any
        seq = [_coerce(v, elem) for v in (value or [])]
        return tuple(seq) if origin is tuple else seq
    if isinstance(tp, type) and issubclass(tp, Enum):
        if isinstance(value, tp):
            return value
        if isinstance(value, str):
            try:
                return tp(value)
            except ValueError:
                return tp[value]
        return tp(value)
    if tp is float and isinstance(value, (int, str)):
        return float(value)
    if tp is int and isinstance(value, float) and value.is_integer():
        return int(value)
    if tp is int and isinstance(value, str):
        return int(value)
    if tp is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return value


def structure(cls: Type, data: dict):
    """Dataclass ``cls`` from a plain dict, the field defaults where a key
    is missing. An unknown key raises (typo protection), but 'hydra'."""
    data = dict(data or {})
    data.pop("hydra", None)
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    for key in data:
        if key not in fields:
            raise ConfigError(f"unknown config key '{key}' for {cls.__name__}")
    for name in fields:
        if name != "hydra" and name in data:
            kwargs[name] = _coerce(data[name], hints.get(name, Any))
    return cls(**kwargs)


def normalize_context_types(entries: list) -> list:
    """``context_types`` entries, dicts ``{"in": [...], "out": [...]}``, with
    ``ContextType`` lists as their values."""
    out = []
    for e in entries or []:
        if isinstance(e, dict):
            out.append({"in": [_as_context(x) for x in _as_list(e.get("in"))],
                        "out": [_as_context(x) for x in _as_list(e.get("out"))]})
        else:
            out.append(_as_context(e))
    return out


def _as_list(x) -> list:
    # legacy presets write a bare string where a list is expected ({"in": ["none"], "out": "timing"})
    if x is None:
        return []
    if isinstance(x, (str, ContextType)):
        return [x]
    return list(x)


def _as_context(x) -> ContextType:
    if isinstance(x, ContextType):
        return x
    return ContextType(str(x).lower())


# --- public API ----------------------------------------------------------------------------------------------------


def parse_value(raw: str):
    """An override's value, as ``yaml.safe_load(raw)`` reads it (None where
    it is empty)."""
    return load_string(raw, where=f"override value {raw!r}") if raw != "" else None


def apply_overrides(tree: dict, overrides: list[str]) -> dict:
    """Dotted ``key=value`` overrides on a composed tree, in place: a
    mapping value merges into a mapping, anything else replaces."""
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override '{ov}' must be key=value")
        key, _, raw = ov.partition("=")
        key = key.lstrip("+~")
        value = parse_value(raw)
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ConfigError(f"override '{ov}': '{part}' is not a config node")
        leaf = parts[-1]
        if isinstance(value, dict) and isinstance(node.get(leaf), dict):
            deep_merge(node[leaf], value)
        else:
            node[leaf] = value
    return tree


def compose(config_dir: Union[str, Path], config_name: str, overrides: Optional[list[str]], schema_cls: Type,
            extra_dir: Optional[Path] = None):
    """``<config_dir>/<config_name>.yaml`` (else ``<extra_dir>/<config_name>.yaml``,
    composed as if it lay in ``config_dir``) with its defaults tree, the
    dotted overrides applied, interpolations resolved, structured into
    ``schema_cls``."""
    config_dir = Path(config_dir)
    where = config_dir / f"{config_name}.yaml"
    path = where if where.exists() or extra_dir is None else Path(extra_dir) / f"{config_name}.yaml"
    if not path.exists():
        raise ConfigError(f"config not found: {where}")

    tree = compose_file(path, config_dir, here=where.parent)
    if overrides:
        apply_overrides(tree, overrides)
    tree = resolve_interpolations(tree)

    # legacy inference presets attach a model group at the top level; the modern schema nests it at train.model
    if schema_cls is schema.InferenceConfig and isinstance(tree.get("model"), dict):
        deep_merge(tree.setdefault("train", {}).setdefault("model", {}), tree.pop("model"))

    cfg = structure(schema_cls, tree)
    post_normalize(cfg)
    return cfg


def post_normalize(cfg) -> None:
    """Coerce the ContextType-bearing fields after structuring."""
    if isinstance(cfg, schema.TrainConfig):
        cfg.data.context_types = normalize_context_types(cfg.data.context_types)
    elif isinstance(cfg, schema.InferenceConfig):
        cfg.in_context = [_as_context(x) for x in (cfg.in_context or [])]
        cfg.output_type = [_as_context(x) for x in (cfg.output_type or [])]
        cfg.train.data.context_types = normalize_context_types(cfg.train.data.context_types)
    elif isinstance(cfg, (schema.FidConfig, schema.MaiModConfig)):
        post_normalize(cfg.inference)
