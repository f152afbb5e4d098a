"""LoRA adapters (the JAX ``models/lora.py``) and checkpoint path resolution.

An adapter holds an (A, B) pair of factors for each target kernel, in the
flax layout: A (in, r) and B (r, out), keyed by the kernel's flax path.
:func:`merge_lora` folds them into the dense weights, W + (alpha / r) (A B)^T
in a torch ``Linear``'s (out, in) layout, differentiably in the factors: the
LoRA train step runs the frozen base with the merged weights
(``torch.func.functional_call``), and serving merges once at load.

Checkpoint format, the JAX one: ``lora.msgpack`` (the factors as flax
serializes them, written and read by :mod:`.flax_msgpack`) and
``lora_config.json`` (rank, alpha, targets, and the compatibility metadata
``format_version`` and ``ckpt_subfolders``).

The name tables, :func:`normalize_targets`, :func:`resolve_compatible_lora_path`
and the two checkpoint path resolvers are copies of the JAX package's;
``tests/test_torch_nojax.py`` holds them to their source.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Mapping, Optional, Union

import torch
from torch import nn

from . import flax_msgpack
from .params import flax_paths, lora_from_flax, lora_to_flax, torch_name

LORA_CONFIG_FILENAME = "lora_config.json"
LORA_WEIGHTS_FILENAME = "lora.msgpack"

# reference peft target names -> our packed-projection kernel names
# (whisper-family uses *_proj; VarWhisper uses Wq/Wkv/Wqkv/Wo)
_TARGET_ALIASES = {
    "q_proj": "wq",
    "k_proj": "wkv",
    "v_proj": "wkv",
    "out_proj": "wo",
    "o_proj": "wo",
    "qkv_proj": "wqkv",
    "Wq": "wq",
    "Wkv": "wkv",
    "Wqkv": "wqkv",
    "Wo": "wo",
}
DEFAULT_TARGETS = ("wq", "wkv", "wqkv", "wo")


def normalize_targets(target_modules) -> tuple[str, ...]:
    """Translate reference peft module names to our kernel names."""
    if not target_modules:
        return DEFAULT_TARGETS
    out = []
    for t in target_modules:
        name = _TARGET_ALIASES.get(t, t)
        if name not in out:
            out.append(name)
    return tuple(out)


class LoraFactors(nn.Module):
    """The factors of one target kernel, in the flax layout: ``a`` (in, r)
    and ``b`` (r, out). ``flax_path`` is the kernel's flax path;
    :func:`.params.flax_paths` names the factors ``<flax_path>/a`` and
    ``<flax_path>/b``, the paths the JAX optimizer's masks see."""

    def __init__(self, flax_path: str, d_in: int, d_out: int, rank: int):
        super().__init__()
        self.flax_path = flax_path
        self.a = nn.Parameter(torch.zeros(d_in, rank))
        self.b = nn.Parameter(torch.zeros(rank, d_out))


class LoraAdapter(nn.ModuleDict):
    """The adapter: a :class:`LoraFactors` for each target kernel, keyed by
    its flax path, in sorted order (the counterpart of the JAX factor tree,
    and what a ``TrainState`` holds under LoRA)."""


def target_kernels(model: nn.Module, targets) -> dict[str, nn.Linear]:
    """{flax kernel path: module} for every ``Linear`` whose module name is in
    ``targets``, the kernels the JAX ``_target_kernels`` selects by flax path."""
    paths = flax_paths(model)
    return dict(sorted(
        (paths[f"{name}.weight"], module) for name, module in model.named_modules()
        if isinstance(module, nn.Linear) and name.rsplit(".", 1)[-1] in targets))


def zero_adapter(model: nn.Module, rank: int, target_modules=None) -> LoraAdapter:
    """Zero fp32 factors of rank ``rank`` for every target kernel of
    ``model``, in path order, on the model's device."""
    adapter = LoraAdapter()
    for path, module in target_kernels(model, normalize_targets(target_modules)).items():
        adapter[path] = LoraFactors(path, module.in_features, module.out_features, rank)
    return adapter.to(next(model.parameters()).device)


def init_lora_params(model: nn.Module, rank: int = 64, target_modules=None, seed: int = 0) -> LoraAdapter:
    """A ~ N(0, 1) / sqrt(rank), B = 0 (the merged delta starts at zero), in
    fp32 on the model's device. The draws come from a CPU ``torch.Generator``
    seeded with ``seed``, target after target in path order, so they do not
    depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    adapter = zero_adapter(model, rank, target_modules)
    with torch.no_grad():
        for factors in adapter.values():
            factors.a.copy_(torch.randn(factors.a.shape, generator=gen) / math.sqrt(rank))
    return adapter


def merge_lora(weights: Mapping[str, torch.Tensor], adapter: LoraAdapter, alpha: float = 128.0
               ) -> dict[str, torch.Tensor]:
    """{torch weight name: W + (alpha / rank) (A B)^T} for each adapted
    kernel, ``weights`` holding the base weights by torch name (a state dict,
    or ``named_parameters``). The product is taken in the factors' dtype and
    cast to W's before the sum, as the JAX ``merge_lora`` does. Differentiable
    in the factors."""
    merged = {}
    for factors in adapter.values():
        name = torch_name(factors.flax_path)
        w = weights[name]
        merged[name] = w + (alpha / factors.a.shape[1]) * (factors.a @ factors.b).T.to(w.dtype)
    return merged


@torch.no_grad()
def merge_lora_into(model: nn.Module, adapter: LoraAdapter, alpha: float = 128.0) -> None:
    """Fold the adapter into ``model``'s weights, in place (serving)."""
    state = dict(model.named_parameters())
    for name, w in merge_lora(state, adapter, alpha).items():
        state[name].copy_(w)


def save_lora(directory: Union[str, Path], adapter: LoraAdapter, *, rank: int, alpha: float,
              target_modules=None, ckpt_subfolders: Optional[list[str]] = None) -> None:
    """Write lora.msgpack + lora_config.json as the JAX ``save_lora`` does
    (reference: model_utils.py:154-169)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / LORA_WEIGHTS_FILENAME).write_bytes(flax_msgpack.packb(lora_to_flax(adapter)))
    config = {
        "format_version": 1,
        "r": rank,
        "lora_alpha": alpha,
        "target_modules": list(normalize_targets(target_modules)),
        "ckpt_subfolders": sorted(ckpt_subfolders) if ckpt_subfolders else None,
    }
    with open(directory / LORA_CONFIG_FILENAME, "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, sort_keys=True)
        f.write("\n")


def load_lora(directory: Union[str, Path], model: nn.Module) -> tuple[LoraAdapter, dict]:
    """Returns (adapter on the model's device, config); ``model`` gives the
    targets' shapes. Raises where the file's factors are not the ones the
    config's targets and rank select, as the JAX ``from_bytes`` does."""
    directory = Path(directory)
    with open(directory / LORA_CONFIG_FILENAME, encoding="utf-8") as f:
        config = json.load(f)
    adapter = zero_adapter(model, config["r"], config.get("target_modules"))
    state = lora_from_flax(flax_msgpack.unpackb((directory / LORA_WEIGHTS_FILENAME).read_bytes()))
    want = {name: tuple(t.shape) for name, t in adapter.state_dict().items()}
    got = {name: tuple(t.shape) for name, t in state.items()}
    if got != want:
        raise ValueError(f"{directory / LORA_WEIGHTS_FILENAME} does not hold the factors of {LORA_CONFIG_FILENAME}: "
                         f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
    adapter.load_state_dict(state)
    return adapter, config


_GAMEMODE_SUBFOLDER_PATTERN = re.compile(r"gamemode=\d+")


def get_model_checkpoint_subfolder(ckpt_path) -> str:
    """'gamemode=N' component of a checkpoint path, if any
    (reference: model_utils.py:215-229)."""
    if not ckpt_path:
        return ""
    for part in str(ckpt_path).replace("\\", "/").split("/"):
        if _GAMEMODE_SUBFOLDER_PATTERN.fullmatch(part):
            return part
    return ""


def resolve_model_checkpoint_path(ckpt_path, gamemode: Optional[int] = None,
                                  auto_select_gamemode_model: bool = True):
    """Prefer a ``gamemode=N`` fine-tune subfolder when it exists
    (reference: model_utils.py:269-301)."""
    if not ckpt_path or gamemode is None or not auto_select_gamemode_model:
        return ckpt_path
    gamemode_path = Path(ckpt_path) / f"gamemode={gamemode}"
    if gamemode_path.is_dir():
        return gamemode_path
    return ckpt_path


def resolve_compatible_lora_path(lora_path, ckpt_subfolder: str = "", verbose: bool = True):
    """Skip adapters whose metadata restricts them to other base checkpoints
    (reference: model_utils.py:231-258)."""
    if not lora_path:
        return None, None
    config_path = Path(lora_path) / LORA_CONFIG_FILENAME
    if not config_path.is_file():
        return lora_path, None
    try:
        with open(config_path, encoding="utf-8") as f:
            config = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"Warning: Failed to read LoRA metadata from {config_path}: {exc}")
        return lora_path, None
    compatible = config.get("ckpt_subfolders")
    if compatible is not None and ckpt_subfolder not in compatible:
        if verbose:
            print(
                f"Skipping LoRA {lora_path}: it supports checkpoint subfolders "
                f"{compatible}, not {ckpt_subfolder!r}."
            )
        return None, config
    return lora_path, config
