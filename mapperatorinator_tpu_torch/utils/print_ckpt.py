"""Checkpoint tree inspection on the port (the repo's ``utils/print_ckpt.py``):
every parameter path with shape/dtype plus size totals.

Accepts the formats the port reads or writes:

- a native checkpoint directory (``model_config.json`` + ``params.msgpack``),
  or any bundle directory with a ``params.msgpack`` (DiT, classifier, OsuR)
- a bare flax ``.msgpack`` file
- the port trainer's checkpoints: a ``CheckpointManager`` step directory
  (``<dir>/<step>/state.pt``: the step, the model's state dict and the
  optimizer's state), or the manager root, where the latest step is picked
- a torch state-dict file (``.bin``/``.pt``/``.ckpt``), loaded through the
  routed unpickler so reference-repo pickles resolve, and ``.safetensors``
  (read without the ``safetensors`` package)

An orbax directory, which the JAX trainer writes, raises: reading it needs
the JAX package's orbax.

    python -m mapperatorinator_tpu_torch.utils.print_ckpt checkpoints/400000 [--filter decoder] [--tree]

It runs on the host: every tensor is read to the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..models.io import read_flax_msgpack
from ..models.legacy import routed_pickle_module
from ..models.safetensors import read_safetensors


def _flatten(tree, prefix=""):
    """Yield (dotted_path, leaf) over nested dicts/lists, reference-style."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _flatten(value, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def load_tree(path: Path):
    """(tree, format_name) for any supported checkpoint layout."""
    path = Path(path)
    if path.is_dir():
        if (path / "params.msgpack").exists():
            return read_flax_msgpack(path / "params.msgpack"), "native"
        if (path / "state.pt").exists():
            return torch.load(path / "state.pt", map_location="cpu", weights_only=True), "torch.save"
        for candidate in (path / "state", path):
            if (candidate / "_METADATA").exists() or (candidate / "manifest.ocdbt").exists():
                raise ValueError(f"{candidate} is an orbax checkpoint (the JAX trainer's); the port reads the "
                                 "checkpoints its own trainer writes (<dir>/<step>/state.pt), and orbax only "
                                 "through the JAX package")
        # a CheckpointManager root: pick the newest step directory
        steps = sorted((d for d in path.iterdir() if d.is_dir() and d.name.isdigit()),
                       key=lambda d: int(d.name))
        if steps:
            return load_tree(steps[-1])
        raise ValueError(f"no checkpoint recognized under {path}")
    if path.suffix == ".msgpack":
        return read_flax_msgpack(path), "flax msgpack"
    if path.suffix == ".safetensors":
        return read_safetensors(path), "safetensors"
    # torch pickle; the routed unpickler maps reference module paths
    return (
        torch.load(path, map_location="cpu", pickle_module=routed_pickle_module, weights_only=False),
        "torch",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", help="checkpoint dir or file")
    parser.add_argument("--filter", default=None, help="only paths containing this substring")
    parser.add_argument("--tree", action="store_true",
                        help="print non-array leaves (optimizer counts, metadata) too")
    args = parser.parse_args(argv)

    tree, fmt = load_tree(Path(args.checkpoint))
    total_params = 0
    total_bytes = 0
    rows = 0
    for dotted, leaf in _flatten(tree):
        shape = getattr(leaf, "shape", None)
        if shape is None and not args.tree:
            continue
        if args.filter and args.filter not in dotted:
            continue
        if shape is not None:
            count = int(np.prod(shape)) if len(shape) else 1
            nbytes = getattr(leaf, "nbytes", 0) or 0
            total_params += count
            total_bytes += int(nbytes)
            dtype = getattr(leaf, "dtype", "?")
            print(f"{dotted}  {tuple(shape)}  {dtype}")
        else:
            print(f"{dotted}  = {leaf!r}")
        rows += 1
    print(f"\n[{fmt}] {rows} entries, {total_params:,} parameters, "
          f"{total_bytes / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
