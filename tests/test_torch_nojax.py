"""The port runs where jax, flax, optax, yaml, msgpack and the JAX package
cannot be imported, and its copies of the JAX package's host code stay the
JAX package's code.

A subprocess installs an import hook that refuses those packages (the JAX
package ``mapperatorinator_tpu`` included) and records every attempt,
imports every module of the port, checks that the default device raises
where no card is visible, then, on the CPU by name, builds a tiny
v32-architecture model with seeded random weights (no checkpoint: reading one
needs msgpack), runs ``load_model`` / ``generate`` to a written .osu file and
one step of ``train.main`` on a small ORS dataset.

The drift guard holds each copied file (``osu/``, ``native/``,
``csrc/difficulty.cpp``, ``train/data/``) to its source: equal but for
imports and the module docstring, and, where named below, the lines that
point the copy at the port's own build.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from mapperatorinator_tpu.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_wav
from tests.test_torch_data import TINY_MODEL, data_overrides, write_ors

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "mapperatorinator_tpu"}
    attempts = []

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                attempts.append(name)
                raise ModuleNotFoundError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import torch
    import mapperatorinator_tpu_torch as port

    modules = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    for name in modules:
        importlib.import_module(name)

    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config, select_device
    from mapperatorinator_tpu_torch.train import main as train_main

    args = load_config("v32")
    assert not torch.cuda.is_available()
    try:  # "auto": no card, so no device, rather than the CPU
        select_device(args)
    except RuntimeError:
        pass
    else:
        raise AssertionError("the default device fell back to the CPU")

    args.device = "cpu"
    args.model_path = ""
    args.seed = 3
    args.audio_path, args.output_path = sys.argv[2], sys.argv[3]
    args.train.data.src_seq_len = 256
    args.train.data.tgt_seq_len = 192
    args.train.model.overwrite = dict(
        tie_word_embeddings=False, d_model=64, encoder_layers=1, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128, decoder_ffn_dim=128)
    engine, vocab = inference.load_model(args)
    inference.compile_args(args, vocab, verbose=False)
    generation_config, beatmap_config = inference.get_config(args)
    text, path = inference.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                    engine=engine, vocab=vocab, verbose=False)

    state = train_main.main(sys.argv[5:], log_dir=sys.argv[4])
    assert state.step == 1
    # not even attempted: an import caught by a try would still be one
    assert not attempts, attempts
    print("MODULES", len(modules))
    print("WROTE", path)
""")


def test_port_needs_no_jax_yaml_or_msgpack(tmp_path):
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    ors = write_ors(tmp_path / "ors", tracks=2, seconds=4.0, maps=1)
    train_argv = ["-cn", "v32", "device=cpu", "mixed_precision=no", f"checkpoint_path={tmp_path / 'ckpt'}",
                  *data_overrides(ors, src=128, tgt=192), *TINY_MODEL, "optim.batch_size=2", "optim.grad_acc=1",
                  "optim.total_steps=1", "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0",
                  "logging.log_with=none", "eval.every_steps=0"]
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO_ROOT), str(wav), str(tmp_path), str(tmp_path / "logs"), *train_argv],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        # the GPU machine sets JAX_PLATFORMS, which makes the JAX package's
        # __init__ import jax
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cuda,cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if line.startswith(("MODULES", "WROTE")))
    assert int(lines["MODULES"]) >= 30
    beatmap = Beatmap.from_path(lines["WROTE"])
    assert beatmap.mode == 0 and beatmap.title == "Unknown Title"
    assert (tmp_path / "ckpt" / "1" / "state.pt").exists() and (tmp_path / "logs" / "metrics.jsonl").exists()


PORT = REPO_ROOT / "mapperatorinator_tpu_torch"
COPIES = {
    **{f"osu/{name}.py": f"mapperatorinator_tpu/osu/{name}.py" for name in (
        "__init__", "beatmap", "curves", "events", "parsing", "rendering", "streams", "timing", "vocab")},
    "native/__init__.py": "mapperatorinator_tpu/native/__init__.py",
    "native/difficulty.py": "mapperatorinator_tpu/native/difficulty.py",
    "csrc/difficulty.cpp": "native/difficulty.cpp",
    **{f"train/data/{name}.py": f"mapperatorinator_tpu/train/data/{name}.py"
       for name in ("sequence", "batching", "ors")},
}
# (source text, the copy's text): the copy builds its library with the port's ops/_build.py
REPLACED = {
    "native/difficulty.py": [
        ('NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"\n'
         'LIB_PATH = NATIVE_DIR / "build" / "libosudiff.so"\n',
         'LIB_PATH = _build.library_path("difficulty")\n'),
        ('        if not LIB_PATH.exists():\n'
         '            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True, capture_output=True)\n',
         '        _build.build("difficulty")\n'),
    ],
}


def code_lines(text: str) -> str:
    """A module without its docstring, import statements and the blank
    lines that leaves at its head."""
    tree = ast.parse(text)
    drop = set()
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        drop.update(range(body[0].lineno, body[0].end_lineno + 1))
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return "".join(line for i, line in enumerate(text.splitlines(keepends=True), 1) if i not in drop).lstrip("\n")


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_copies_do_not_drift_from_their_source(copy):
    source = (REPO_ROOT / COPIES[copy]).read_text(encoding="utf-8")
    ported = (PORT / copy).read_text(encoding="utf-8")
    if copy.endswith(".cpp"):
        assert ported == source
        return
    want = code_lines(source)
    for old, new in REPLACED.get(copy, []):
        assert old in want, f"{COPIES[copy]} no longer has the replaced lines {old!r}"
        want = want.replace(old, new)
    assert code_lines(ported) == want
