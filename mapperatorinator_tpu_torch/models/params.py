"""Parameters: the flax tree of the JAX package as a PyTorch state dict, and a
seeded initialisation for running without a checkpoint.

The port's modules carry the flax names (``layers_3`` becomes ``layers.3``),
so the mapping is by rule:

* Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
* Conv ``kernel`` (k, in, out) -> ``nn.Conv1d.weight`` (out, in, k);
* Embed ``embedding`` and RMSNorm ``scale`` -> ``weight`` (the flax
  ``RMSNorm_0`` scope is dropped);
* ``bias`` stays ``bias``.

The fused ``wqkv`` / ``wkv`` projections stay fused: the port splits their
output the way the JAX ``Attention`` does (``reshape(b, t, 3h, d)``, then
thirds along the head axis), so the columns keep their meaning.

:func:`flax_paths` runs the same table backwards, from a module's parameter
names to the flax paths the JAX optimizer's masks match against, and
:func:`flax_layout` moves a tensor between the two layouts.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn


def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {"a/b/c": leaf}."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def torch_name(flax_path: str) -> str:
    """``params/transformer/encoder/layers_0/ffn/fc1/kernel`` ->
    ``transformer.encoder.layers.0.ffn.fc1.weight``."""
    parts = flax_path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    parts = [p for p in parts if p != "RMSNorm_0"]
    parts = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in parts]
    if parts[-1] in ("kernel", "embedding", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def flax_paths(model: nn.Module) -> dict[str, str]:
    """{torch parameter name: flax path} for a port module, the inverse of
    :func:`torch_name` (``params/`` prefix and ``RMSNorm_0`` scope included)."""
    paths = {}
    for name, _ in model.named_parameters():
        *scope, leaf = name.split(".")
        owner = model.get_submodule(".".join(scope))
        if leaf == "weight":
            if isinstance(owner, nn.Embedding):
                leaf = "embedding"
            elif isinstance(owner, (nn.Linear, nn.Conv1d)):
                leaf = "kernel"
            else:  # RMSNorm: flax nests nn.RMSNorm inside the Norm wrapper
                scope, leaf = [*scope, "RMSNorm_0"], "scale"
        paths[name] = "/".join(["params", *scope, leaf]).replace("/layers/", "/layers_")
    return paths


def flax_layout(x: torch.Tensor, flax_path: str) -> torch.Tensor:
    """A parameter (or its gradient) as a view in the other layout: a
    ``kernel`` moves between Linear (out, in) and Dense (in, out), or Conv1d
    (out, in, k) and Conv (k, in, out); every other leaf keeps its layout.
    It is its own inverse."""
    if not flax_path.endswith("/kernel"):
        return x
    return x.T if x.dim() == 2 else x.permute(2, 1, 0)


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Flax params (a nested dict of numpy arrays) -> state dict. Raises if
    two leaves land on one name."""
    state = {}
    for path, leaf in flatten(tree).items():
        arr = np.asarray(leaf)
        if path.endswith("/kernel"):
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        name = torch_name(path)
        if name in state:
            raise ValueError(f"two flax leaves map to {name}")
        state[name] = torch.tensor(arr)
    return state


def init_params(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device: lecun-normal
    matrices and conv kernels, unit-variance embeddings, zero biases, unit
    norm scales."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif isinstance(model.get_submodule(name.rsplit(".", 1)[0]), nn.Embedding):
                p.normal_(0.0, 1.0, generator=gen)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in**-0.5, generator=gen)
