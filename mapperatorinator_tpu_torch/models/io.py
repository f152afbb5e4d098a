"""Checkpoints (``models/io.py``) and int8 weight quantization.

A native checkpoint is a directory holding ``model_config.json`` (the
MapperatorinatorConfig tree), ``params.msgpack`` (flax-serialized params) and
``tokenizer.json`` (the Vocabulary state). :func:`load_checkpoint` also reads
a published one (``config.json`` and the reference's torch weights,
:mod:`.convert`). :func:`save_params` and
:func:`load_params` write and read the ``params.msgpack`` of any module that
carries the flax names (the classifier, OsuR and CM3P bundles). A DiT bundle,
as the JAX ``diffusion_train.py`` exports one, holds ``dit_config.json`` (the DiTConfig
fields but the dtype) and ``params.msgpack`` (the EMA params). The msgpack
files are read and written by :mod:`.flax_msgpack`, in pure Python: the port
needs no ``msgpack`` package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Union

import torch

from ..osu.vocab import Vocabulary
from . import flax_msgpack
from .convert import load_hf_checkpoint
from .legacy import is_legacy_checkpoint
from .dit import DiT, DiTConfig
from .mapperatorinator import Mapperatorinator, MapperatorinatorConfig, build_model
from .params import dit_params_from_flax, dit_params_to_flax, flax_paths, params_from_flax, params_to_flax
from .transformer import TransformerConfig, quantize_weight

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_DTYPE_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def config_from_dict(d: dict) -> MapperatorinatorConfig:
    bd = dict(d["backbone"])
    bd["dtype"] = _DTYPES[bd.get("dtype", "float32")]
    bd["param_dtype"] = _DTYPES[bd.get("param_dtype", "float32")]
    rest = {k: v for k, v in d.items() if k != "backbone"}
    return MapperatorinatorConfig(backbone=TransformerConfig(**bd), **rest)


def config_to_dict(cfg: MapperatorinatorConfig) -> dict:
    """The ``model_config.json`` tree, as the JAX ``_config_to_dict`` writes it."""
    d = dataclasses.asdict(cfg)
    d["backbone"]["dtype"] = _DTYPE_NAMES[cfg.backbone.dtype]
    d["backbone"]["param_dtype"] = _DTYPE_NAMES[cfg.backbone.param_dtype]
    return d


def read_flax_msgpack(path: Union[str, Path]) -> dict:
    """``flax.serialization.to_bytes`` output -> nested dict of numpy arrays
    (ext type 1 is an ndarray, 3 a numpy scalar, each packed as
    ``(shape, dtype name, C-order bytes)``)."""

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path} holds a chunked array (over 1 GB): not supported")
            for value in node.values():
                check(value)

    try:
        tree = flax_msgpack.unpackb(Path(path).read_bytes())
    except ValueError as err:
        raise ValueError(f"{path}: {err}") from None
    check(tree)
    return tree


def save_params(path: Union[str, Path], model: torch.nn.Module) -> None:
    """``model``'s weights as the ``params.msgpack`` that ``flax.serialization``
    writes for its flax counterpart: fp32, the flax layout and names."""
    Path(path).write_bytes(flax_msgpack.packb(params_to_flax(model.state_dict(), flax_paths(model))))


def load_params(path: Union[str, Path], model: torch.nn.Module) -> torch.nn.Module:
    """``model`` with the weights of a ``params.msgpack`` (the flax tree of a
    classifier, OsuR or CM3P, or of any module that carries the flax names);
    raises if a tensor is missing, left over or of another shape."""
    model.load_state_dict(params_from_flax(read_flax_msgpack(path)))
    return model


def save_checkpoint(directory: Union[str, Path], config: MapperatorinatorConfig,
                    state_dict: dict[str, torch.Tensor], vocab: Optional[Vocabulary] = None) -> None:
    """The counterpart of the JAX ``save_checkpoint``: ``model_config.json``,
    ``params.msgpack`` in the flax layout, and ``tokenizer.json`` when a
    vocabulary is given. ``state_dict`` is a port model's (quantized or not);
    its floating tensors are stored in fp32, the parameter dtype of every
    checkpoint the port reads."""
    if config.backbone.param_dtype != torch.float32:
        raise ValueError(f"param_dtype {config.backbone.param_dtype}: checkpoints store fp32 parameters")
    with torch.device("meta"):  # the module tree names the leaves; no storage
        paths = flax_paths(Mapperatorinator(config))
    if set(paths) != set(state_dict):
        raise ValueError(f"state dict does not match the config: {sorted(set(paths) ^ set(state_dict))[:5]}")
    tree = params_to_flax(state_dict, paths)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "model_config.json", "w", encoding="utf-8") as f:
        json.dump(config_to_dict(config), f)
    (directory / "params.msgpack").write_bytes(flax_msgpack.packb(tree))
    if vocab is not None:
        vocab.save_pretrained(directory)


def quantize_model(model: Mapperatorinator) -> Mapperatorinator:
    """The JAX ``quantize_checkpoint``: ``model`` rebuilt with
    ``quantized_weights``, on its device. Structure-driven: each weight at a
    site the quantized model makes a ``QDense`` becomes an int8 kernel with a
    per-output-channel fp32 scale (:func:`.transformer.quantize_weight`, bit
    for bit the JAX ``quantize_params``); every other tensor passes through,
    and so do kernels that are int8 already."""
    cfg = dataclasses.replace(model.cfg, backbone=dataclasses.replace(model.cfg.backbone, quantized_weights=True))
    qmodel = build_model(cfg, next(model.parameters()).device)
    source = model.state_dict()
    state = {}
    for name in qmodel.state_dict():
        base, leaf = name.rsplit(".", 1)
        if leaf == "kernel_q" and name not in source:
            state[name], state[f"{base}.scale"] = quantize_weight(source[f"{base}.weight"].T)
        elif name not in state:
            state[name] = source[name]
    qmodel.load_state_dict(state)
    return qmodel.train(model.training)


def load_checkpoint(directory: Union[str, Path]) -> tuple[Mapperatorinator, Optional[Vocabulary]]:
    """Returns (model on the CPU with the checkpoint's weights, vocab or None),
    dispatching on the directory's files as the JAX ``load_checkpoint`` does:
    ``model_config.json`` is a native checkpoint, ``config.json`` a published
    (HF-format) one (:func:`.convert.load_hf_checkpoint`); the vocabulary is
    read from ``tokenizer.json`` where there is one. A legacy accelerate
    checkpoint holds no model config: it raises ``ValueError`` naming
    :func:`.legacy.load_legacy_checkpoint`, which takes the training config
    too."""
    directory = Path(directory)
    vocab = Vocabulary.from_pretrained(directory) if (directory / "tokenizer.json").exists() else None
    if (directory / "model_config.json").exists():
        with open(directory / "model_config.json", encoding="utf-8") as f:
            config = config_from_dict(json.load(f))
        model = Mapperatorinator(config)
        model.load_state_dict(params_from_flax(read_flax_msgpack(directory / "params.msgpack")))
        return model, vocab
    if (directory / "config.json").exists():
        return load_hf_checkpoint(directory), vocab
    if is_legacy_checkpoint(directory):
        raise ValueError(
            f"{directory} is a legacy accelerate checkpoint; load it with "
            "mapperatorinator_tpu_torch.models.legacy.load_legacy_checkpoint(dir, train_args) "
            "(it carries no model config, so the training config is required)"
        )
    raise FileNotFoundError(f"no recognizable checkpoint at {directory}")


def save_dit_bundle(directory: Union[str, Path], model: DiT) -> None:
    """A DiT bundle: ``dit_config.json`` and ``params.msgpack`` (fp32, flax
    layout), which the JAX ``load_diffusion_model`` reads too."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "dit_config.json", "w", encoding="utf-8") as f:
        json.dump(dataclasses.asdict(model.cfg), f)
    (directory / "params.msgpack").write_bytes(flax_msgpack.packb(dit_params_to_flax(model.state_dict())))


def load_dit_bundle(directory: Union[str, Path]) -> DiT:
    """The DiT of a bundle, on the CPU in fp32."""
    directory = Path(directory)
    with open(directory / "dit_config.json", encoding="utf-8") as f:
        model = DiT(DiTConfig(**json.load(f)))
    model.load_state_dict(dit_params_from_flax(read_flax_msgpack(directory / "params.msgpack")))
    return model
