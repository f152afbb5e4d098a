"""The port runs where jax, flax, optax, yaml, msgpack, safetensors,
transformers, matplotlib, pandas, pyarrow, sklearn, huggingface_hub,
datasets (which the GPU machine lacks) and the JAX package cannot be
imported, and its copies of the JAX package's host code stay the JAX
package's code.

A subprocess installs an import hook that refuses those packages (the JAX
package ``mapperatorinator_tpu`` included) and records every attempt,
imports every module of the port, checks that the default device raises
where no card is visible, then, on the CPU by name, builds a tiny
v32-architecture model with seeded random weights, runs ``load_model`` /
``generate`` to a written .osu file, loads the tiny checkpoint (written by the
JAX package) with int8 weights and KV cache and decodes a few steps from it,
loads published (HF-format) v28, T5 v1.1, NWhisper and moonshine
checkpoints from their ``model.safetensors`` and decodes from each (the last
two with int8 weights and KV),
imports the multi-process modules (``parallel/``) and calls their
single-process helpers, runs one step of ``train.main`` on a small ORS
dataset, reads a parquet file (the committed MMRS metadata) with the port's
reader, and runs one step of a
LoRA fine-tune of that checkpoint, whose adapter it then loads, merged and
quantized, writes a tiny DiT bundle, loads it with
``load_diffusion_model`` and refines the positions of a few events with it,
runs ``embedding_svm`` (its least-squares probe) and ``find_unique_beatmaps``
on it, composes ``-cn v32`` with a spectrogram override and the port's
``t5_base`` preset from the repo's YAML, and writes a tiny classifier and CM3P bundle and runs every metric of
``calc_fid`` with them on the ORS set's maps.

The drift guard holds each copied file (``osu/``, ``native/``,
``csrc/difficulty.cpp``, ``train/data/``, ``diffusion/{vocab,data,export}.py``,
``audio/io.py``, ``eval/``, ``rcomplexion/``, ``utils/batched_apply.py``,
``utils/excepthook.py``, ``config/schema.py``,
``infer/super_timing.py``, and ``infer/processor.py``, whose CFG folds use
``torch.cat``) to its source: equal but for imports and the module
docstring, and, where named below, the lines that point the copy at the
port's own build or engine; and each copied definition of
``train/data/mmrs.py`` and ``train/data/web.py`` (their table operations
and shard reading aside), ``models/lora.py``, ``models/legacy.py`` (its module map pointed at the
port's ``osu/events.py``), ``infer/server.py``, ``mai_mod.py`` (the
top-level script's) and the host code of ``infer/diffusion_pipeline.py``
(methods of its pipeline class too), ``calc_fid.py``,
``classifier_classify.py`` and ``rcomplexion_inference.py`` (the top-level
scripts'), and of the single-card tools (``test.py``, ``dataloading.py``,
``push_to_hub.py``, ``web_ui.py``, ``mai_mod_ui.py`` and the ``utils/``
scripts) to the JAX one, imports inside it aside.
"""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from mapperatorinator_tpu.osu.beatmap import Beatmap
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint, make_wav
from tests.test_torch_calc_fid import write_generated
from tests.test_torch_convert import FAMILY_OVERRIDES, write_hf_checkpoint
from tests.test_torch_data import TINY_MODEL, data_overrides, write_ors

SCRIPT = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "msgpack", "safetensors", "transformers",
               "mapperatorinator_tpu", "matplotlib", "pandas", "pyarrow", "sklearn", "huggingface_hub", "datasets"}
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
    assert {"mapperatorinator_tpu_torch.mai_mod", "mapperatorinator_tpu_torch.infer.server",
            "mapperatorinator_tpu_torch.infer.super_timing", "mapperatorinator_tpu_torch.audio.io",
            "mapperatorinator_tpu_torch.diffusion_train", "mapperatorinator_tpu_torch.classifier_train",
            "mapperatorinator_tpu_torch.rcomplexion_train",
            "mapperatorinator_tpu_torch.diffusion.schedule_sampler"} <= set(modules)
    # the single-card tools
    assert {f"mapperatorinator_tpu_torch.{name}" for name in (
        "test", "dataloading", "push_to_hub", "plot_difficulties", "web_ui", "mai_mod_ui", "utils.print_ckpt",
        "utils.distance_distance", "utils.dit_test_toy", "utils.plot_embeddings", "utils.find_similar_beatmaps",
        "utils.plot_self_similarity", "utils.embedding_svm", "utils.find_unique_beatmaps",
        "utils.excepthook")} <= set(modules)
    # the config layer: the repo's configs/**/*.yaml composed without yaml
    assert {f"mapperatorinator_tpu_torch.config.{name}"
            for name in ("loader", "yaml_reader", "schema")} <= set(modules)
    # multi-process training
    assert {f"mapperatorinator_tpu_torch.parallel.{name}" for name in ("distributed", "mesh", "sharding")} <= set(modules)
    # the parquet reader and the datasets that read it
    assert {f"mapperatorinator_tpu_torch.train.data.{name}" for name in ("parquet", "mmrs", "web")} <= set(modules)
    from mapperatorinator_tpu_torch import parallel
    assert parallel.maybe_initialize(None) is False and parallel.make_global_mesh(None, "cpu") is None

    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config, select_device
    from mapperatorinator_tpu_torch.train import main as train_main

    from mapperatorinator_tpu_torch.config import load_train_config
    assert load_train_config("v32", ["model.spectrogram.hop_length=256"]).data.hop_length == 256
    assert load_train_config("t5_base").model.name == "google/t5-v1_1-base"
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

    # a checkpoint, read without msgpack, served with int8 weights and KV cache
    import numpy as np
    from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline
    from mapperatorinator_tpu_torch.models.transformer import QDense

    args = load_config("v32", [f"model_path={sys.argv[5]}", "device=cpu", "gamemode=0", "quantized_weights=true",
                               "quantized_kv=true", "train.data.src_seq_len=256", "train.data.tgt_seq_len=256"])
    qengine, qvocab = inference.load_model(args)
    assert qengine.model.cfg.backbone.quantized_kv
    assert sum(isinstance(m, QDense) for m in qengine.model.modules()) == 23
    enc = qengine.encode_with_cond(np.zeros((1, 255 * 128), np.float32))
    tokens, end = qengine.generate(enc, np.full((1, 1), qvocab.sos_id, np.int32),
                                   build_logits_pipeline(qvocab, do_sample=False), [qvocab.eos_id], max_length=9)
    assert tokens.shape == (1, 9) and end > 1

    # a published (HF-format) v28 checkpoint, its model.safetensors read without safetensors
    args = load_config("v28", [f"model_path={sys.argv[6]}", "device=cpu", "train.data.src_seq_len=256",
                               "train.data.tgt_seq_len=128"])
    hengine, hvocab = inference.load_model(args)
    assert hengine.model.cfg.backbone.position_scheme == "whisper_abs"
    enc = hengine.encode_with_cond(np.zeros((1, 255 * 128), np.float32))
    tokens, end = hengine.generate(enc, np.full((1, 1), hvocab.sos_id, np.int32),
                                   build_logits_pipeline(hvocab, do_sample=False), [hvocab.eos_id], max_length=9)
    assert tokens.shape == (1, 9) and end > 1

    # a published T5 v1.1 checkpoint (relative positions, no conv stem) under -cn v32
    args = load_config("v32", [f"model_path={sys.argv[7]}", "device=cpu", "train.data.src_seq_len=256",
                               "train.data.tgt_seq_len=128", "quantized_weights=true"])
    tengine, tvocab = inference.load_model(args)
    assert tengine.model.cfg.backbone.position_scheme == "t5_relpos"
    enc = tengine.encode_with_cond(np.zeros((1, 255 * 128), np.float32))
    assert enc.shape == (1, 256, 32)
    tokens, end = tengine.generate(enc, np.full((1, 1), tvocab.sos_id, np.int32),
                                   build_logits_pipeline(tvocab, do_sample=False), [tvocab.eos_id], max_length=9)
    assert tokens.shape == (1, 9) and end > 1

    # published NWhisper (nGPT) and moonshine (raw samples in) checkpoints under -cn v32, with int8 KV and weights
    for directory, scheme, positions in ((sys.argv[8], "ngpt", 128), (sys.argv[9], "prenorm", 83)):
        args = load_config("v32", [f"model_path={directory}", "device=cpu", "train.data.src_seq_len=256",
                                   "train.data.tgt_seq_len=128", "quantized_weights=true", "quantized_kv=true"])
        fengine, fvocab = inference.load_model(args)
        assert fengine.model.cfg.backbone.norm_scheme == scheme
        enc = fengine.encode_with_cond(np.zeros((1, 255 * 128), np.float32))
        assert enc.shape == (1, positions, 32)
        tokens, end = fengine.generate(enc, np.full((1, 1), fvocab.sos_id, np.int32),
                                       build_logits_pipeline(fvocab, do_sample=False), [fvocab.eos_id], max_length=9)
        assert tokens.shape == (1, 9) and end > 1

    split = sys.argv.index("--")
    state = train_main.main(sys.argv[11:split], log_dir=sys.argv[4])
    assert state.step == 1

    # an MMRS metadata.parquet that pandas wrote (SNAPPY, dictionary pages), read without pandas or pyarrow
    import os, shutil
    from mapperatorinator_tpu_torch.train.data.mmrs import filter_mmrs_metadata, load_mmrs_metadata
    os.makedirs(f"{sys.argv[3]}/mmrs")
    shutil.copy(f"{sys.argv[1]}/tests/fixtures/parquet/mmrs_metadata.parquet", f"{sys.argv[3]}/mmrs/metadata.parquet")
    table = load_mmrs_metadata(f"{sys.argv[3]}/mmrs")
    assert len(filter_mmrs_metadata(table, start=0, end=2)) == 8 and table.row(0)["StarRating"].shape == (7,)

    # a LoRA fine-tune of the checkpoint, its adapter merged at load and quantized
    lora_state = train_main.main(sys.argv[split + 1:], log_dir=sys.argv[4])
    assert lora_state.step == 1
    args = load_config("v32", [f"model_path={sys.argv[5]}", f"lora_path={sys.argv[3]}/lora_ckpt/lora", "device=cpu",
                               "gamemode=0", "quantized_weights=true", "train.data.src_seq_len=256",
                               "train.data.tgt_seq_len=256"])
    lengine, _ = inference.load_model(args)
    assert sum(isinstance(m, QDense) for m in lengine.model.modules()) == 23

    # DiT refinement: a bundle written and read without msgpack, sampled on the CPU
    from mapperatorinator_tpu_torch.infer import GenerationConfig
    from mapperatorinator_tpu_torch.infer.diffusion_pipeline import DiffusionPipeline
    from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
    from mapperatorinator_tpu_torch.models.io import save_dit_bundle
    from mapperatorinator_tpu_torch.models.params import init_dit_params
    from mapperatorinator_tpu_torch.osu.events import Event, EventType

    dit = DiT(DiTConfig(hidden_size=32, depth=1, num_heads=2, class_size=48))
    init_dit_params(dit, 0, std=0.02)
    save_dit_bundle(f"{sys.argv[3]}/dit", dit)
    dit = inference.load_diffusion_model(f"{sys.argv[3]}/dit", torch.device("cpu"))
    args = load_config("v32", ["device=cpu", "seed=0", "timesteps=[2,0,0,0,0,0,0,0,0,0]", "refine_iters=1"])
    events = [Event(EventType.TIME_SHIFT, 1000 + 500 * i) if k == 0 else
              Event(EventType.DISTANCE, 80) if k == 1 else Event(EventType.CIRCLE) for i in range(3) for k in range(3)]
    refined = DiffusionPipeline(args, dit, dit).generate(events, GenerationConfig(), timing=None)
    assert [e.type for e in refined].count(EventType.POS_X) == 3
    # the embedding tools on that bundle: the least-squares probe (no sklearn) and a creator's ranking (no pandas)
    from mapperatorinator_tpu_torch.utils import embedding_svm, find_unique_beatmaps
    with open(f"{sys.argv[3]}/labels.csv", "w") as f:
        f.write("idx,label\\n" + "".join(f"{i},{i % 2}\\n" for i in range(8)))
    with open(f"{sys.argv[3]}/maps.csv", "w") as f:
        f.write("Title,Creator\\n" + "".join(f"Song {i},{'A' if i % 3 else 'B'}\\n" for i in range(48)))
    probe = embedding_svm.run(embedding_svm.parse_args(["--ckpt", f"{sys.argv[3]}/dit", "--labels",
                                                        f"{sys.argv[3]}/labels.csv", "--metadata",
                                                        f"{sys.argv[3]}/maps.csv"]))
    assert probe["probs"].shape == (48,)
    # the probe picks its branch by trying sklearn, as the JAX script's does: that one attempt is the design
    assert attempts and {a.split(".")[0] for a in attempts} == {"sklearn"}, attempts
    attempts.clear()
    ranked = find_unique_beatmaps.run(find_unique_beatmaps.parse_args(["--ckpt", f"{sys.argv[3]}/dit", "--metadata",
                                                                      f"{sys.argv[3]}/maps.csv", "--creator", "B"]))
    assert len(ranked) == 10
    # the evaluation harness on the CPU: a classifier and a CM3P bundle the port writes and reads without
    # msgpack, every metric of calc_fid on the ORS set's maps and their "generated" copies
    from mapperatorinator_tpu_torch import calc_fid
    from mapperatorinator_tpu_torch.config import load_classifier_config
    from mapperatorinator_tpu_torch.models.classifier import build_classifier, save_classifier_bundle
    from mapperatorinator_tpu_torch.models.cm3p import Cm3p, Cm3pConfig, save_cm3p
    from mapperatorinator_tpu_torch.models.transformer import TransformerConfig
    from mapperatorinator_tpu_torch.osu import build_vocabulary

    torch.manual_seed(0)
    clf_args = load_classifier_config("train_v1", [
        "model.d_model=64", "model.encoder_layers=1", "model.decoder_layers=1", "model.encoder_heads=4",
        "model.decoder_heads=4", "model.encoder_ffn=128", "model.decoder_ffn=128", "model.classifier_proj_size=8",
        "data.src_seq_len=64", "data.tgt_seq_len=32", "model.spectrogram.n_mels=32"])
    clf_vocab = build_vocabulary(clf_args)
    save_classifier_bundle(f"{sys.argv[3]}/classifier", build_classifier(clf_args, clf_vocab), clf_args, clf_vocab)
    tower = TransformerConfig(d_model=64, encoder_layers=1, encoder_heads=4, encoder_ffn=128, conv_stem=False)
    save_cm3p(f"{sys.argv[3]}/cm3p", Cm3p(Cm3pConfig(beatmap_backbone=tower, audio_backbone=tower,
                                                      vocab_size=qvocab.vocab_size_in, projection_dim=8,
                                                      src_seq_len=64, tgt_seq_len=32)), qvocab)
    results = calc_fid.main([f"dataset_path={sys.argv[10]}", "dataset_start=0", "dataset_end=2", "gamemodes=[0]",
                             "skip_generation=true", f"classifier_ckpt={sys.argv[3]}/classifier",
                             f"cm3p_ckpt={sys.argv[3]}/cm3p", "fid_cm3p=true", "classifier_batch_size=4",
                             "cm3p_batch_size=4", "inference.device=cpu"])
    assert {"fid", "fid_cm3p", "active_rhythm_f1", "sr_mse"} <= set(results), results

    # not even attempted: an import caught by a try would still be one
    assert not attempts, attempts
    print("MODULES", len(modules))
    print("WROTE", path)
""")


def test_port_needs_no_jax_yaml_or_msgpack(tmp_path):
    wav = make_wav(tmp_path / "song.wav", seconds=3.0)
    ors = write_ors(tmp_path / "ors", tracks=2, seconds=4.0, maps=1)
    ckpt = make_tiny_checkpoint(tmp_path / "tiny", d_model=128, heads=4, ffn=256)
    hf, _, _ = write_hf_checkpoint(tmp_path / "hf", "v28")
    t5, _, _ = write_hf_checkpoint(tmp_path / "t5", "v32", overrides=FAMILY_OVERRIDES["t5"])
    ngpt, _, _ = write_hf_checkpoint(tmp_path / "ngpt", "v32", overrides=FAMILY_OVERRIDES["nwhisper"])
    moonshine, _, _ = write_hf_checkpoint(tmp_path / "moonshine", "v32", overrides=FAMILY_OVERRIDES["moonshine"])
    train_argv = ["-cn", "v32", "device=cpu", "mixed_precision=no", f"checkpoint_path={tmp_path / 'ckpt'}",
                  *data_overrides(ors, src=128, tgt=192), *TINY_MODEL, "optim.batch_size=2", "optim.grad_acc=1",
                  "optim.total_steps=1", "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0",
                  "logging.log_with=none", "eval.every_steps=0"]
    lora_argv = ["-cn", "lora", "device=cpu", f"pretrained_path={ckpt}", f"checkpoint_path={tmp_path / 'lora_ckpt'}",
                 *data_overrides(ors, src=128, tgt=192), "data.mappers_path=", "data.tags_metadata_path=",
                 "lora.r=4", "optim.batch_size=2", "optim.total_steps=1", "dataloader.num_workers=0",
                 "dataloader.balancer_buffer_size=0", "logging.log_with=none", "eval.every_steps=0"]
    write_generated(ors)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(REPO_ROOT), str(wav), str(tmp_path), str(tmp_path / "logs"), str(ckpt),
         str(hf), str(t5), str(ngpt), str(moonshine), str(ors), *train_argv, "--", *lora_argv],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        # the GPU machine sets JAX_PLATFORMS, which makes the JAX package's
        # __init__ import jax
        env={**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cuda,cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines() if line.startswith(("MODULES", "WROTE")))
    assert int(lines["MODULES"]) >= 42
    beatmap = Beatmap.from_path(lines["WROTE"])
    assert beatmap.mode == 0 and beatmap.title == "Unknown Title"
    assert (tmp_path / "ckpt" / "1" / "state.pt").exists() and (tmp_path / "logs" / "metrics.jsonl").exists()
    assert (tmp_path / "lora_ckpt" / "lora" / "lora.msgpack").exists()


PORT = REPO_ROOT / "mapperatorinator_tpu_torch"
COPIES = {
    **{f"osu/{name}.py": f"mapperatorinator_tpu/osu/{name}.py" for name in (
        "__init__", "beatmap", "curves", "events", "parsing", "rendering", "streams", "timing", "vocab")},
    "audio/io.py": "mapperatorinator_tpu/audio/io.py",
    "infer/processor.py": "mapperatorinator_tpu/infer/processor.py",
    "infer/super_timing.py": "mapperatorinator_tpu/infer/super_timing.py",
    **{f"diffusion/{name}.py": f"mapperatorinator_tpu/diffusion/{name}.py" for name in ("vocab", "data", "export")},
    "native/__init__.py": "mapperatorinator_tpu/native/__init__.py",
    "native/difficulty.py": "mapperatorinator_tpu/native/difficulty.py",
    "csrc/difficulty.cpp": "native/difficulty.cpp",
    **{f"train/data/{name}.py": f"mapperatorinator_tpu/train/data/{name}.py"
       for name in ("sequence", "batching", "ors", "classifier")},
    **{f"eval/{name}.py": f"mapperatorinator_tpu/eval/{name}.py" for name in ("__init__", "fid", "rhythm")},
    **{f"rcomplexion/{name}.py": f"mapperatorinator_tpu/rcomplexion/{name}.py"
       for name in ("__init__", "vocab", "parser", "data")},
    "utils/batched_apply.py": "mapperatorinator_tpu/utils/batched_apply.py",
    "utils/excepthook.py": "mapperatorinator_tpu/utils/excepthook.py",
    "config/schema.py": "mapperatorinator_tpu/config/schema.py",
}
# (source text, the copy's text): the copy builds its library with the port's
# ops/_build.py; the Processor folds its CFG batches with torch.cat; the FID
# takes the matrix root as every scipy version returns it
REPLACED = {
    "eval/fid.py": [
        ("    covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)\n",
         "    # scipy 1.16 dropped sqrtm's ``disp``; without it every version returns the root alone\n"
         "    covmean = linalg.sqrtm(sigma1.dot(sigma2))\n"),
    ],
    "infer/processor.py": [
        ("\n            encoder_states = jnp.concatenate([encoder_states, encoder_states], axis=0)\n",
         "            encoder_states = torch.cat([encoder_states, encoder_states], dim=0)\n"),
        ("            if self.cfg_scale > 1:\n\n"
         "                ids = np.concatenate([np.concatenate(padded[n:], axis=0), ids], axis=0)\n"
         "                encoder_states = jnp.concatenate([encoder_states, encoder_states], axis=0)\n",
         "            if self.cfg_scale > 1:\n"
         "                ids = np.concatenate([np.concatenate(padded[n:], axis=0), ids], axis=0)\n"
         "                encoder_states = torch.cat([encoder_states, encoder_states], dim=0)\n"),
    ],
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


# (the port's copy, its source, the top-level definitions the copy holds verbatim)
COPIED_DEFINITIONS = [
    ("train/data/mmrs.py", "mapperatorinator_tpu/train/data/mmrs.py",
     ("SPEED_RATIOS", "MmrsDataset.__init__", "MmrsDataset._get_filtered_metadata", "MmrsDataset._get_difficulty",
      "MmrsDataset.__iter__", "MmrsDataset._iter_set", "MmrsDataset._iter_beatmap")),
    ("train/data/web.py", "mapperatorinator_tpu/train/data/web.py",
     ("parse_web_datetime", "get_web_ranked_date", "get_web_submitted_date", "filter_web_beatmaps", "load_web_audio",
      "WebDataset.__init__", "WebDataset.__iter__", "WebDataset._get_difficulty", "WebDataset._iter_row",
      "WebDataset._iter_beatmap")),
    ("models/lora.py", "mapperatorinator_tpu/models/lora.py",
     ("LORA_CONFIG_FILENAME", "LORA_WEIGHTS_FILENAME", "_TARGET_ALIASES", "DEFAULT_TARGETS", "normalize_targets",
      "_GAMEMODE_SUBFOLDER_PATTERN", "get_model_checkpoint_subfolder", "resolve_model_checkpoint_path",
      "resolve_compatible_lora_path")),
    ("infer/server.py", "mapperatorinator_tpu/infer/server.py",
     ("RETRY_SIGNAL", "InferenceServer", "InferenceClient")),
    ("models/legacy.py", "mapperatorinator_tpu/models/legacy.py",
     ("_MODULE_MAPPING", "RoutedUnpickler", "_normalize_tokenizer_state", "is_legacy_checkpoint")),
    ("infer/diffusion_pipeline.py", "mapperatorinator_tpu/infer/diffusion_pipeline.py",
     ("repeat_type", "DiffusionSlider", "PLAYFIELD", "_bucket_len", "DiffusionPipeline.get_class_vector",
      "DiffusionPipeline.EVENT_INDEX", "DiffusionPipeline.NC_TYPES", "DiffusionPipeline.events_to_sequence",
      "DiffusionPipeline._timing_point_at", "DiffusionPipeline._to_positions",
      "DiffusionPipeline._slider_recompute_host", "DiffusionPipeline.events_with_pos")),
    ("calc_fid.py", "calc_fid.py",
     ("get_beatmap_paths", "get_beatmap_paths_by_gamemode", "test_training_set_overlap", "generate_beatmaps",
      "rhythm_report", "drain_time_seconds", "_bpm_segments", "bpm_mse_for_pair", "extra_stats",
      "compute_self_similarity", "_resize_matrix", "ssm_rmse_for_pair", "classifier_fid", "cm3p_fid",
      "_fan_out_generation", "_generated_dir", "_already_generated", "_generated_for", "main")),
    ("classifier_classify.py", "classifier_classify.py",
     ("STEPS_PER_MILLISECOND", "create_example", "get_mapper_names")),
    ("rcomplexion_inference.py", "rcomplexion_inference.py", ("od_to_ms_300", "calc_rhythm_complexity")),
    ("test.py", "test.py",
     ("N_TIME_BINS", "MAX_RHYTHM_COMPLEXITY", "N_RHYTHM_BINS", "PRECISION_BIN_RANGE", "LABEL_IGNORE_ID",
      "_label_times", "Analysis", "print_report")),
    ("dataloading.py", "dataloading.py", ("STEPS_PER_MILLISECOND", "add_hitsounds")),
    ("push_to_hub.py", "push_to_hub.py",
     ("CHECKPOINT_FILES", "load_removed_users", "contains_loadable_model_checkpoint", "discover_submodel_paths")),
    ("utils/print_ckpt.py", "utils/print_ckpt.py", ("_flatten",)),
    ("utils/plot_embeddings.py", "utils/plot_embeddings.py", ("reduce_2d",)),
    ("utils/find_similar_beatmaps.py", "utils/find_similar_beatmaps.py", ("nearest",)),
    ("utils/embedding_svm.py", "utils/embedding_svm.py", ("fit_probe",)),
    ("utils/find_unique_beatmaps.py", "utils/find_unique_beatmaps.py", ("rank_by_mean_distance",)),
    ("web_ui.py", "web_ui.py",
     ("JOBS_LOCK", "_OPTIONAL_INT", "_OPTIONAL_FLOAT", "_STRINGS", "_CHECKBOXES", "_first", "_queue_writer",
      "_datasets_dirs", "load_descriptors", "_reap_job", "_spawn", "_job_log_path", "Handler.protocol_version",
      "Handler.log_message", "Handler._json", "Handler._file", "Handler._stream")),
    ("mai_mod_ui.py", "mai_mod_ui.py", ("MaiModHandler",)),
    ("mai_mod.py", "mai_mod.py",
     ("MOD_EXPLANATIONS", "POSITION_TYPES", "ANCHOR_TYPES", "HS_TYPES", "TIMING_TYPES_", "HITOBJECT_TYPES",
      "Suggestion", "type_to_str", "_GroupIndex", "_worth_reporting", "_combo_positions", "_attach_editor_locations",
      "_mmssms", "_edit_address", "_SURPRISAL_TIERS", "_surprisal_text", "_categorize", "ai_mod",
      "select_config_for_gamemode", "run_analysis", "main")),
]
# (copy, name) -> [(source text, the copy's text)]: the MMRS dataset's table operations are the port table's
# (mmrs.MmrsTable); the port's harness reads its own resolved configs, spawns no JAX platform choice, loads CM3P on
# the device the config selects and holds (model, config, vocab) bundles; OsuR's softmax is torch's; the port's
# MaiMod reads its own resolved configs; the diffusion pipeline embeds the context's times with the port's timestep
# embedding; the legacy module map routes the reference's paths to the port's events
DEFINITION_REPLACED = {
    ("train/data/mmrs.py", "MmrsDataset.__iter__"): [
        ("        set_ids = metadata.index.get_level_values(0).unique().to_numpy()\n",
         "        set_ids = metadata.unique_set_ids()\n"),
        ("            yield from self._iter_set(metadata.loc[set_id])\n",
         "            yield from self._iter_set(metadata.loc(set_id))\n"),
    ],
    ("train/data/mmrs.py", "MmrsDataset._iter_set"): [
        ('set_metadata.iloc[0]["BeatmapSetFolder"]', 'set_metadata.row(0)["BeatmapSetFolder"]'),
        ('set_metadata.iloc[0]["AudioFile"]', 'set_metadata.row(0)["AudioFile"]'),
    ],
    ("train/data/mmrs.py", "MmrsDataset._iter_beatmap"): [
        ("                other_metadata = set_metadata.drop(i).sample().iloc[0]\n",
         "                other_metadata = set_metadata.drop(i).sample()\n"),
    ],
    ("calc_fid.py", "generate_beatmaps"): [
        ('        i_args = compose(REPO_ROOT / "configs" / "inference", "v32", '
         "schema_cls=schema.InferenceConfig)\n",
         '        i_args = load_config("v32")\n'),
    ],
    ("calc_fid.py", "cm3p_fid"): [
        ('    _, _, config, vocab = bundle\n',
         '    _, config, vocab = bundle\n'),
        ('    bundle = load_cm3p(args.cm3p_ckpt)\n',
         '    bundle = load_cm3p(args.cm3p_ckpt, select_device(args.inference))\n'),
    ],
    ("calc_fid.py", "_fan_out_generation"): [
        ("\n        platform = jax.default_backend()\n"
         '        ctx = multiprocessing.get_context("spawn")\n'
         "        procs = [\n"
         "            ctx.Process(target=_generation_worker, args=(chunk, args, gm, i, platform))\n",
         "\n"
         '        ctx = multiprocessing.get_context("spawn")\n'
         "        procs = [\n"
         "            ctx.Process(target=_generation_worker, args=(chunk, args, gm, i))\n"),
    ],
    ("calc_fid.py", "main"): [
        ('    args = compose(REPO_ROOT / "configs", "calc_fid", overrides=overrides, '
         "schema_cls=schema.FidConfig)\n",
         '    args = load_fid_config("calc_fid", overrides)\n'),
    ],
    ("calc_fid.py", "classifier_fid"): [
        ('    sr = classifier_bundle[2].model.spectrogram.sample_rate\n',
         '    sr = classifier_bundle[1].model.spectrogram.sample_rate\n'),
    ],
    ("rcomplexion_inference.py", "calc_rhythm_complexity"): [
        ("    # pad the batch dim to the next power of two so XLA reuses compiles\n"
         "    # across beatmaps with different window counts\n",
         "    # pad the batch dim to the next power of two, as the JAX function does\n"
         "    # (its compiles are reused across beatmaps), so the logits are the same\n"),
        ("    probs = np.asarray(\n"
         '        __import__("jax").nn.softmax(logits.astype("float32"), axis=-1)\n'
         "    )\n",
         "    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()\n"),
    ],
    ("models/legacy.py", "_MODULE_MAPPING"): [
        ('"mapperatorinator_tpu.osu.events",\n', '"mapperatorinator_tpu_torch.osu.events",\n'),
    ],
    ("infer/diffusion_pipeline.py", "DiffusionPipeline.events_to_sequence"): [
        ("                np.asarray(timestep_embedding(jnp.asarray(seq_o * 0.1), 128)),\n"
         "                np.asarray(timestep_embedding(jnp.asarray(seq_d), 128)),\n",
         "                timestep_embedding(torch.as_tensor(seq_o * 0.1), 128).numpy(),\n"
         "                timestep_embedding(torch.as_tensor(seq_d), 128).numpy(),\n"),
    ],
    ("mai_mod.py", "main"): [
        ('    args = compose(REPO_ROOT / "configs", config_name, overrides=overrides, schema_cls=schema.MaiModConfig)\n',
         "    args = load_mai_mod_config(config_name, overrides)\n"),
    ],
    ("mai_mod.py", "select_config_for_gamemode"): [
        ('    new_args = compose(\n        REPO_ROOT / "configs" / "inference", fallback,\n'
         '        overrides=inference_overrides, schema_cls=schema.InferenceConfig,\n    )\n',
         "    new_args = load_config(fallback, inference_overrides)\n"),
    ],
}


def definitions(text: str) -> dict[str, str]:
    """{name: source} of a module's top-level functions, classes and
    assignments, and of each class's own (as ``Class.name``, decorators
    included), without the import statements inside them."""
    lines = text.splitlines(keepends=True)
    out = {}

    def collect(body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [target.id for target in node.targets if isinstance(target, ast.Name)]
            else:
                continue
            first = min([node.lineno, *(d.lineno for d in getattr(node, "decorator_list", []))])
            drop = {i for n in ast.walk(node) if isinstance(n, (ast.Import, ast.ImportFrom))
                    for i in range(n.lineno, n.end_lineno + 1)}
            segment = "".join(lines[i - 1] for i in range(first, node.end_lineno + 1) if i not in drop)
            out.update(dict.fromkeys([prefix + name for name in names], segment))
            if isinstance(node, ast.ClassDef) and not prefix:
                collect(node.body, f"{node.name}.")

    collect(ast.parse(text).body, "")
    return out


@pytest.mark.parametrize("copy,source,name", [(c, s, n) for c, s, names in COPIED_DEFINITIONS for n in names])
def test_copied_definitions_do_not_drift_from_their_source(copy, source, name):
    want = definitions((REPO_ROOT / source).read_text(encoding="utf-8"))
    got = definitions((PORT / copy).read_text(encoding="utf-8"))
    assert name in want, f"{source} no longer defines {name}"
    expected = want[name]
    for old, new in DEFINITION_REPLACED.get((copy, name), []):
        assert old in expected, f"{source}:{name} no longer has the replaced lines {old!r}"
        expected = expected.replace(old, new)
    assert got.get(name) == expected
