"""Legacy accelerate checkpoints (the JAX ``models/legacy.py``).

The reference's older releases (the osuT5 era, T5 v1.1 backbones among
them) were saved as accelerate state directories: the model's torch state
dict as ``pytorch_model.bin`` (or ``model*.safetensors`` shards) and the
tokenizer as a pickle, ``custom_checkpoint_0.pkl``, whose event classes
were pickled under module paths that moved between releases. The
:class:`RoutedUnpickler` maps every such path onto the port's own
``osu/events.py``, whose ``EventType`` / ``ContextType`` enums and
``EventRange`` dataclass pickle in the same shape, and
:func:`_normalize_tokenizer_state` turns what it reads into the plain
schema of ``Vocabulary.from_state_dict``. The directory holds no model
config, so :func:`load_legacy_checkpoint` takes the training config that
produced it, builds the model with ``build_config`` and maps the weights
with :func:`.convert.convert_mapperatorinator_state_dict`, for any family
the port builds.

The pickle is read with ``weights_only=False``, which can run code: load
only checkpoints from a source you trust, as with the reference.
"""

from __future__ import annotations

import dataclasses
import io
import pickle
import types
from pathlib import Path
from typing import Union

import torch

from ..osu.vocab import Vocabulary
from .convert import backbone_family, convert_mapperatorinator_state_dict
from .mapperatorinator import Mapperatorinator, build_config
from .safetensors import read_safetensors

# every module path the reference ever pickled event classes under
_MODULE_MAPPING = {
    "osuT5.tokenizer.event": "mapperatorinator_tpu_torch.osu.events",
    "osuT5.osuT5.event": "mapperatorinator_tpu_torch.osu.events",
    "osuT5.event": "mapperatorinator_tpu_torch.osu.events",
    "osuT5.osuT5.tokenizer": "mapperatorinator_tpu_torch.osu.events",
    "libs.tokenizer.event": "mapperatorinator_tpu_torch.osu.events",
    "libs.event": "mapperatorinator_tpu_torch.osu.events",
    "classifier.libs.tokenizer.event": "mapperatorinator_tpu_torch.osu.events",
}


class RoutedUnpickler(pickle.Unpickler):
    """Reference: ``utils/routed_pickle.py`` — renames modules at load time."""

    def find_class(self, mod_name: str, name: str):
        mod_name = _MODULE_MAPPING.get(mod_name, mod_name)
        return super().find_class(mod_name, name)


# torch.load(pickle_module=...) wants a module exposing Unpickler/load
routed_pickle_module = types.ModuleType("routed_pickle_module")
routed_pickle_module.Unpickler = RoutedUnpickler
routed_pickle_module.load = lambda f, **kw: RoutedUnpickler(f).load()
routed_pickle_module.loads = lambda b, **kw: RoutedUnpickler(io.BytesIO(b)).load()


def _normalize_tokenizer_state(state: dict) -> dict:
    """Pickled states may carry EventType/EventRange objects instead of the
    plain-dict schema; normalize to the schema from_state_dict expects."""

    def er_dict(er):
        if isinstance(er, dict):
            return er
        return {"type": er.type.value, "min_value": er.min_value, "max_value": er.max_value}

    def key(k):
        return k.value if hasattr(k, "value") else k

    out = dict(state)
    for field in ("event_ranges", "input_event_ranges"):
        if field in out:
            out[field] = [er_dict(er) for er in out[field]]
    for field in ("context_sos", "context_eos", "event_start", "event_end"):
        if field in out:
            out[field] = {key(k): v for k, v in out[field].items()}
    if "event_range" in out:
        out["event_range"] = {key(k): er_dict(v) for k, v in out["event_range"].items()}
    return out


def is_legacy_checkpoint(directory: Union[str, Path]) -> bool:
    directory = Path(directory)
    return (directory / "custom_checkpoint_0.pkl").is_file() and (
        (directory / "pytorch_model.bin").is_file()
        or any(directory.glob("model*.safetensors"))
    )


def load_legacy_checkpoint(directory: Union[str, Path], train_args=None) -> tuple[Mapperatorinator, Vocabulary]:
    """(model on the CPU with the checkpoint's weights, its vocabulary) from
    an accelerate checkpoint directory, the model built from ``train_args``
    (the training config that produced it; a ``ValueError`` without one) as
    ``build_config`` builds it, its backbone family from
    ``train_args.model.name``. The weights are ``pytorch_model.bin``, else
    the ``model*.safetensors`` shards in sorted order
    (:mod:`.safetensors`). The model computes in fp32 whatever the training
    config's ``mixed_precision``, as in the JAX loader: that flag describes
    how the checkpoint was trained, and an inference entry applies its own
    precision on top."""
    directory = Path(directory)
    tokenizer_state = torch.load(
        directory / "custom_checkpoint_0.pkl", pickle_module=routed_pickle_module, weights_only=False
    )
    vocab = Vocabulary.from_state_dict(_normalize_tokenizer_state(tokenizer_state))
    if (directory / "pytorch_model.bin").is_file():
        state = torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    else:
        state = {}
        for shard in sorted(directory.glob("model*.safetensors")):
            state.update(read_safetensors(shard))
    if train_args is None:
        raise ValueError(
            "legacy accelerate checkpoints carry no model config; pass the "
            "training config (train_args) that produced them"
        )
    config = build_config(train_args, vocab)
    config = dataclasses.replace(config, backbone=dataclasses.replace(config.backbone, dtype=torch.float32))
    model = Mapperatorinator(config)
    family = backbone_family(train_args.model.name)
    model.load_state_dict(convert_mapperatorinator_state_dict(state, config, family=family))
    return model, vocab
