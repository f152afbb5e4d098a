"""Native checkpoint loading (``models/io.py``).

A native checkpoint is a directory holding ``model_config.json`` (the
MapperatorinatorConfig tree), ``params.msgpack`` (flax-serialized params) and
``tokenizer.json`` (the Vocabulary state).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..osu.vocab import Vocabulary
from .mapperatorinator import Mapperatorinator, MapperatorinatorConfig
from .params import params_from_flax
from .transformer import TransformerConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def config_from_dict(d: dict) -> MapperatorinatorConfig:
    bd = dict(d["backbone"])
    bd["dtype"] = _DTYPES[bd.get("dtype", "float32")]
    bd["param_dtype"] = _DTYPES[bd.get("param_dtype", "float32")]
    rest = {k: v for k, v in d.items() if k != "backbone"}
    return MapperatorinatorConfig(backbone=TransformerConfig(**bd), **rest)


def read_flax_msgpack(path: Union[str, Path]) -> dict:
    """``flax.serialization.to_bytes`` output -> nested dict of numpy arrays,
    decoded with msgpack alone (ext type 1 is an ndarray, 3 a numpy scalar,
    each packed as ``(shape, dtype name, C-order bytes)``)."""
    import msgpack

    def ext_hook(code, data):
        if code in (1, 3):
            shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
            return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)
        raise ValueError(f"unsupported msgpack ext type {code} in {path}")

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path} holds a chunked array (over 1 GB): not supported")
            for value in node.values():
                check(value)

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    check(tree)
    return tree


def load_checkpoint(directory: Union[str, Path]) -> tuple[Mapperatorinator, Optional[Vocabulary]]:
    """Returns (model on the CPU with the checkpoint's weights, vocab or None)."""
    directory = Path(directory)
    if not (directory / "model_config.json").exists():
        raise FileNotFoundError(
            f"no native checkpoint at {directory} (HF and legacy formats: ROADMAP queue 1, item 16)"
        )
    vocab = Vocabulary.from_pretrained(directory) if (directory / "tokenizer.json").exists() else None
    with open(directory / "model_config.json", encoding="utf-8") as f:
        config = config_from_dict(json.load(f))
    model = Mapperatorinator(config)
    model.load_state_dict(params_from_flax(read_flax_msgpack(directory / "params.msgpack")))
    return model, vocab
