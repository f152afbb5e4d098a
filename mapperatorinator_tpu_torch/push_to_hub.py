"""Publish checkpoints to the HuggingFace Hub, on the port (the repo's
``push_to_hub.py``).

Stages the root checkpoint plus any discovered gamemode subfolder checkpoints
into a bundle, nulls the embeddings of mappers who requested removal
(``datasets/removed_users.txt``), and uploads the folder. ``--stage-dir DIR``
writes the bundle there and uploads nothing: that needs neither the network
nor ``huggingface_hub``, which is imported only to upload.

    python -m mapperatorinator_tpu_torch.push_to_hub -cn v32 model_path=... [repo_id=...] [--stage-dir DIR]

Each checkpoint is read with :func:`.models.io.load_checkpoint` and written
with :func:`.models.io.save_checkpoint`: the staged ``params.msgpack`` is the
flax layout that the JAX loader reads too. It runs on the host: no model
computes, and no tensor goes to a device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from tempfile import TemporaryDirectory

from .config import load_config, parse_argv
from .models.io import load_checkpoint, save_checkpoint
from .models.params import flax_layout, flax_paths
from .osu.events import EventType

REPO_ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT_FILES = ("params.msgpack", "tokenizer.json")
# the flax paths whose rows are a mapper's: the mapper embedder's table, and
# the decoder's token table (the JAX script names it ``decoder_embed``; the
# generation model's table is ``decoder_embedder``, which that name misses)
MAPPER_ROWS = ("mapper_embedder",)
TOKEN_ROWS = ("decoder_embed/embedding", "decoder_embedder/embedding")


def load_removed_users(path: Path | None = None) -> list[int]:
    path = path or REPO_ROOT / "datasets" / "removed_users.txt"
    if not path.exists():
        return []
    with open(path, encoding="utf-8") as f:
        return [int(line.strip()) for line in f if line.strip()]


def remove_mappers_from_params(state: dict, paths: dict, vocab, removed_users: list[int]):
    """Null removed mappers' embedding rows (reference: push_to_hub.py:20-47)
    in a port model's state dict, ``paths`` naming each tensor's flax path
    (:func:`.models.params.flax_paths`).

    Zeroes, in the flax layout, (a) the mapper-embedder row and (b) the
    decoder token-embed row of each removed user, then drops them from the
    vocab's mapper index. Returns updated (state, vocab); a tensor that
    changes is replaced by a changed copy."""
    if not vocab.mapper_idx:
        print("Vocabulary has no mapper index, nothing to remove.")
        return state, vocab

    state = dict(state)

    def null_row(key_substrings: tuple, row: int, label: str):
        for name, path in paths.items():
            if any(s in path for s in key_substrings) and state[name].ndim == 2:
                tensor = state[name].clone()
                flax_layout(tensor, path)[row] = 0
                state[name] = tensor
                print(f"Nulled idx {row} ({label}) in {path}")

    for user in removed_users:
        if user not in vocab.mapper_idx:
            continue
        null_row(MAPPER_ROWS, vocab.mapper_idx[user], str(user))
        if EventType.MAPPER in vocab.event_range:
            null_row(TOKEN_ROWS, vocab.encode_mapper_id(user), str(user))
        del vocab.mapper_idx[user]
        print(f"Removed mapper {user} from vocabulary idx mapping.")

    return state, vocab


def contains_loadable_model_checkpoint(path: Path) -> bool:
    return all((path / f).is_file() for f in CHECKPOINT_FILES)


def discover_submodel_paths(model_path) -> list[Path]:
    """Find nested checkpoint dirs, e.g. ``gamemode=1/`` fine-tune subfolders
    (reference: push_to_hub.py:64-79)."""
    model_root = Path(model_path)
    if not model_root.is_dir():
        print(f"Model path {model_path} is not a local directory, skipping subfolder discovery.")
        return []
    found = [
        p for p in sorted(model_root.rglob("*"))
        if p.is_dir() and contains_loadable_model_checkpoint(p)
    ]
    print(f"Discovered {len(found)} submodel folder(s).")
    for p in found:
        print(f" - {p.relative_to(model_root).as_posix()}")
    return found


def stage_checkpoints(model_path, staged_root: Path, removed_users: list[int]) -> list[str]:
    """Load, scrub, and re-save root + subfolder checkpoints into staged_root.
    Returns relative subfolder names ('' = root)."""
    model_root = Path(model_path)
    targets = [("", model_root)] + [
        (p.relative_to(model_root).as_posix(), p) for p in discover_submodel_paths(model_root)
    ]
    for rel, source in targets:
        print(f"Loading model checkpoint from {source}")
        model, vocab = load_checkpoint(source)
        state, vocab = remove_mappers_from_params(model.state_dict(), flax_paths(model), vocab, removed_users)
        out = staged_root if rel == "" else staged_root / rel
        save_checkpoint(out, model.cfg, state, vocab)
        missing = [f for f in ("model_config.json",) + CHECKPOINT_FILES if not (out / f).is_file()]
        if missing:
            raise FileNotFoundError(f"Missing expected saved artifacts in {out}: {', '.join(missing)}")
        print(f"Saved artifacts to {out}")
    return [rel for rel, _ in targets]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, flags = parse_argv(argv, "v32", {"--stage-dir": ""})
    stage_dir = Path(flags["--stage-dir"]) if flags["--stage-dir"] else None

    repo_id = "Mapperatorinator-tpu-v32"
    overrides, plain = [o for o in overrides if not o.startswith("repo_id=")], overrides
    for o in plain:
        if o.startswith("repo_id="):
            repo_id = o.split("=", 1)[1]

    args = load_config(config_name, overrides)
    removed_users = load_removed_users()

    if stage_dir is not None:
        stage_dir.mkdir(parents=True, exist_ok=True)
        subfolders = stage_checkpoints(args.model_path, stage_dir, removed_users)
        print(f"Staged {len(subfolders)} checkpoint(s) to {stage_dir} (no upload requested)")
        return stage_dir

    try:
        from huggingface_hub import HfApi
    except ImportError:
        raise SystemExit("huggingface_hub is not available; use --stage-dir DIR to stage locally.")

    api = HfApi()
    api.create_repo(repo_id=repo_id, repo_type="model", private=True, exist_ok=True)
    with TemporaryDirectory(prefix="push_to_hub_") as temp_dir:
        staged_root = Path(temp_dir)
        stage_checkpoints(args.model_path, staged_root, removed_users)
        api.upload_folder(repo_id=repo_id, repo_type="model", folder_path=str(staged_root),
                          commit_message="Upload root and subfolder checkpoints")
    print("Done")


if __name__ == "__main__":
    main()
