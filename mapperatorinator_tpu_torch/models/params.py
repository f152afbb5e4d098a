"""Parameters: the flax tree of the JAX package as a PyTorch state dict, and a
seeded initialisation for running without a checkpoint.

The port's modules carry the flax names (``layers_3`` becomes ``layers.3``),
so the mapping is by rule:

* Dense ``kernel`` (in, out) -> ``nn.Linear.weight`` (out, in);
* Conv ``kernel`` (k, in, out) -> ``nn.Conv1d.weight`` (out, in, k);
* Embed ``embedding``, RMSNorm and LayerNorm ``scale`` -> ``weight`` (the
  ``RMSNorm_0`` / ``LayerNorm_0`` scope that the JAX ``Norm`` wrapper nests
  its norm in is dropped; the conditioning embedders' flax LayerNorms are
  named directly, with no such scope);
* a ``QDense`` keeps its leaves: ``kernel_q`` (in, out) int8 in the JAX
  layout, and ``scale``, which a ``kernel_q`` sibling marks as the int8
  kernel's and not an RMSNorm's;
* ``bias`` stays ``bias``;
* nGPT's ``HyperScale`` leaves (``qk_scale/scale``,
  ``*_residual/branch_scale/scale``, ``alpha_positions/scale``,
  ``logit_scale/scale``) and moonshine's ``groupnorm/scale`` are a
  ``weight`` too (the module names its flax leaf as ``flax_weight``), and
  the nGPT encoder's bare ``embed_positions`` keeps its name.

The fused ``wqkv`` / ``wkv`` projections stay fused: the port splits their
output the way the JAX ``Attention`` does (``reshape(b, t, 3h, d)``, then
thirds along the head axis), so the columns keep their meaning.

Seeded initialisation: :func:`init_params` gives the generation model
random weights for serving; :func:`init_flax_params` (the classifier, OsuR)
and :func:`init_dit_flax` (the DiT) draw each tensor from the distribution
the flax module's own initialiser draws it from, where a trainer starts.

:func:`flax_paths` runs the same table backwards, from a module's parameter
names to the flax paths the JAX optimizer's masks match against,
:func:`flax_layout` moves a tensor between the two layouts, and
:func:`params_to_flax` writes a module's state dict as the flax tree. The
classifier, OsuR and CM3P (:mod:`.classifier`, :mod:`.cm3p`) carry the flax
names too, so the same rules read and write their trees.

The DiT (:mod:`.dit`) has its own table, :func:`dit_params_from_flax` and
:func:`dit_params_to_flax`: ``blocks_3`` becomes ``blocks.3``, a Dense
``kernel`` a Linear ``weight``; its LayerNorms hold no parameters.
:func:`init_dit_params` seeds it for serving tests (every tensor random),
:func:`init_dit_flax` as flax does.

A LoRA adapter (:mod:`.lora`) holds its factors in the flax layout already,
keyed by the target kernel's flax path: :func:`lora_from_flax` and
:func:`lora_to_flax` carry them between the JAX factor tree
(``<kernel path>/a`` and ``/b``) and the adapter's state dict
(``<kernel path>.a`` and ``.b``) unchanged.
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


def unflatten(flat: dict) -> dict:
    """{"a/b/c": leaf} -> nested dict, the inverse of :func:`flatten`."""
    tree: dict = {}
    for path, leaf in flat.items():
        *scope, key = path.split("/")
        node = tree
        for part in scope:
            node = node.setdefault(part, {})
        node[key] = leaf
    return tree


# the scopes the JAX ``Norm`` wrapper nests its norm in
NORM_SCOPES = ("RMSNorm_0", "LayerNorm_0")


def torch_name(flax_path: str, qdense: bool = False) -> str:
    """``params/transformer/encoder/layers_0/ffn/fc1/kernel`` ->
    ``transformer.encoder.layers.0.ffn.fc1.weight``. ``qdense``: the leaf
    belongs to a ``QDense`` (its ``scale`` stays ``scale``)."""
    parts = flax_path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    parts = [p for p in parts if p not in NORM_SCOPES]
    parts = [re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in parts]
    if parts[-1] in ("kernel", "embedding") or (parts[-1] == "scale" and not qdense):
        parts[-1] = "weight"
    return ".".join(parts)


def flax_paths(model: nn.Module) -> dict[str, str]:
    """{torch state-dict name: flax path} for a port module, the inverse of
    :func:`torch_name` (``params/`` prefix and a backbone norm's
    ``RMSNorm_0`` or ``LayerNorm_0`` scope included, which the module names
    as its ``flax_scope``): every parameter, and the int8 kernels and scales
    a ``QDense`` holds as buffers. A LoRA factor's module carries its
    kernel's ``flax_path``: its ``a`` and ``b`` extend that path."""
    paths = {}
    for name in model.state_dict(keep_vars=True):
        *scope, leaf = name.split(".")
        owner = model.get_submodule(".".join(scope))
        if hasattr(owner, "flax_path"):
            paths[name] = f"{owner.flax_path}/{leaf}"
            continue
        if hasattr(owner, "flax_scope"):  # a backbone norm: flax nests it inside the Norm wrapper
            scope, leaf = [*scope, owner.flax_scope], "scale" if leaf == "weight" else leaf
        elif leaf == "weight":
            if isinstance(owner, nn.Embedding):
                leaf = "embedding"
            elif isinstance(owner, (nn.Linear, nn.Conv1d)):
                leaf = "kernel"
            elif isinstance(owner, nn.LayerNorm):  # the conditioning embedders' flax LayerNorm
                leaf = "scale"
            elif hasattr(owner, "flax_weight"):  # HyperScale, moonshine's GroupNorm
                leaf = owner.flax_weight
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
    leaves = flatten(tree)
    for path, leaf in leaves.items():
        arr = np.asarray(leaf)
        if path.endswith("/kernel"):
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (2, 1, 0))
        name = torch_name(path, qdense=path.rsplit("/", 1)[0] + "/kernel_q" in leaves)
        if name in state:
            raise ValueError(f"two flax leaves map to {name}")
        state[name] = torch.tensor(arr)
    return state


def params_to_flax(state: dict[str, torch.Tensor], paths: dict[str, str]) -> dict:
    """A port module's state dict -> the nested flax tree of fp32 (floating)
    numpy arrays in the flax layout, each tensor at the flax path ``paths``
    (:func:`flax_paths` of the module) names."""
    tree: dict = {}
    for name, tensor in state.items():
        path = paths[name]
        t = flax_layout(tensor.detach(), path).cpu()
        if t.is_floating_point():
            t = t.float()
        *scopes, leaf = path.split("/")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = np.ascontiguousarray(t.numpy()).reshape(t.shape)  # a 0-d leaf stays 0-d
    return tree


def lora_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A JAX LoRA factor tree (nested dict of numpy arrays) -> the state dict
    of a :class:`.lora.LoraAdapter`: ``<kernel path>/a`` becomes
    ``<kernel path>.a``, in the same layout."""
    state = {}
    for path, leaf in flatten(tree).items():
        kernel, factor = path.rsplit("/", 1)
        state[f"{kernel}.{factor}"] = torch.tensor(np.asarray(leaf))
    return state


def lora_to_flax(adapter: nn.Module) -> dict:
    """A LoRA adapter -> the JAX factor tree as fp32 numpy arrays, its keys in
    the order of the JAX ``init_lora_params`` (sorted kernel paths, ``a``
    before ``b``), so that it serializes to the bytes flax writes."""
    flat = {}
    for name, tensor in sorted(adapter.state_dict().items()):
        kernel, factor = name.rsplit(".", 1)
        flat[f"{kernel}/{factor}"] = np.ascontiguousarray(tensor.detach().float().cpu().numpy())
    return unflatten(flat)


def init_params(model: nn.Module, seed: int) -> None:
    """Seeded random weights, drawn on the model's device: lecun-normal
    matrices and conv kernels, unit-variance embeddings (the learned decoder
    position table too), zero biases (a LayerNorm's too), unit norm scales,
    and what flax initialises as a constant as flax does: an RBF embedder's
    basis (centres evenly over [0, 1], widths 0.1) and a parameter whose
    module says (``flax_init``: nGPT's scales and the encoder's sinusoid
    position rows)."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            *scope, leaf = name.split(".")
            owner = model.get_submodule(".".join(scope))
            if hasattr(owner, "flax_init"):
                p.copy_(owner.flax_init(leaf))
            elif name.endswith(".basis_centers"):
                p.copy_(torch.linspace(0, 1, p.numel()))
            elif name.endswith(".basis_widths"):
                p.fill_(0.1)
            elif name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            elif isinstance(owner, nn.Embedding):
                p.normal_(0.0, 1.0, generator=gen)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in**-0.5, generator=gen)


def dit_params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A DiT's flax params (``{"params": {...}}`` or the inner tree, numpy
    leaves) -> the state dict of :class:`.dit.DiT`:
    ``params/blocks_3/qkv/kernel`` (in, out) becomes ``blocks.3.qkv.weight``
    (out, in); ``context_embedder/proj``, ``t_embedder/fc1``,
    ``final_layer/adaln`` and the rest keep their names."""
    tree = tree.get("params", tree)
    state = {}
    for path, leaf in flatten(tree).items():
        arr = np.asarray(leaf)
        *scope, name = path.split("/")
        if name == "kernel":
            arr, name = arr.T, "weight"
        scope = [re.sub(r"^blocks_(\d+)$", r"blocks.\1", part) for part in scope]
        state[".".join([*scope, name])] = torch.tensor(np.ascontiguousarray(arr))
    return state


def dit_params_to_flax(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`dit_params_from_flax`: a DiT's state dict ->
    ``{"params": {...}}`` of fp32 numpy arrays in the flax layout."""
    flat = {}
    for name, tensor in state.items():
        *scope, leaf = name.split(".")
        path = "/".join(scope).replace("blocks/", "blocks_")
        arr = tensor.detach().float().cpu().numpy()
        if leaf == "weight":
            arr, leaf = arr.T, "kernel"
        flat[f"{path}/{leaf}"] = np.ascontiguousarray(arr)
    return {"params": unflatten(flat)}


def init_dit_params(model: nn.Module, seed: int, std: float) -> None:
    """Seeded weights for a :class:`.dit.DiT`, drawn on its device: every
    tensor from N(0, std), biases included. (flax zeroes every adaLN
    modulation and the final projection, so a model initialised as flax
    does returns eps = 0 and each block is the identity: it would exercise
    nothing.)"""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, std, generator=gen)


# flax's lecun_normal is a normal truncated at two standard deviations,
# rescaled by this factor (the truncated unit normal's std) to variance 1 / fan_in
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(p: torch.Tensor, gen: torch.Generator) -> None:
    """flax's ``lecun_normal()`` in place on a torch Linear or Conv1d weight
    (fan in: every axis but the output one)."""
    std = p[0].numel() ** -0.5 / _TRUNCATED_NORMAL_STD
    nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def init_flax_params(model: nn.Module, seed: int, zeroed=lambda name: False) -> None:
    """Seeded weights drawn as the flax modules' default initialisers draw
    them, on the model's device: lecun-normal (truncated) Dense and Conv
    kernels, zero biases, unit norm scales, ``nn.Embed``'s N(0, 1 /
    features) tables, a parameter whose module says (``flax_init``) as that
    module says, and zeros for every parameter named where ``zeroed(name)``
    holds. The classifier's and OsuR's modules are flax's defaults."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            *scope, leaf = name.split(".")
            owner = model.get_submodule(".".join(scope))
            if zeroed(name) or leaf == "bias":
                p.zero_()
            elif hasattr(owner, "flax_init"):
                p.copy_(owner.flax_init(leaf))
            elif isinstance(owner, nn.Embedding):
                p.normal_(0.0, p.shape[1] ** -0.5, generator=gen)
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                lecun_normal_(p, gen)


def init_dit_flax(model: nn.Module, seed: int) -> None:
    """Seeded weights for a :class:`.dit.DiT` as the JAX ``model.init`` draws
    them: lecun-normal Dense kernels and zero biases, and zeros for every
    block's ``adaln``, the final layer's ``adaln`` and its ``proj``
    (``models/dit.py:121,159,164`` of the JAX package): the model starts at
    eps = 0 with every block the identity, where a trainer starts."""
    def zeroed(name: str) -> bool:
        scope = name.split(".")[:-1]
        return scope[-1] == "adaln" or scope == ["final_layer", "proj"]

    init_flax_params(model, seed, zeroed)
