"""The port's training data pipeline and training entry point.

* With the same ``random`` / ``numpy`` seeds, the port's ``OrsDataset`` and
  ``batch_iterator`` (token balancing included) yield the batches the JAX
  package's do, key for key and value for value, on the ORS track-folder
  layout of test_data.py, built here.
* ``python -m mapperatorinator_tpu_torch.train.main`` with ``device=cpu`` on
  a tiny v32-architecture config: two steps write ``metrics.jsonl``, a
  checkpoint and ``tokenizer.json``, and a second run resumes at step 2.
"""

import json
import random
import wave

import numpy as np
import pytest
import torch

from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.osu import BeatmapParser as JaxBeatmapParser
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.train.data import OrsDataset as JaxOrsDataset
from mapperatorinator_tpu.train.data.batching import batch_iterator as jax_batch_iterator
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
from mapperatorinator_tpu_torch.train import main as train_main
from mapperatorinator_tpu_torch.train.data import OrsDataset, build_dataset
from mapperatorinator_tpu_torch.train.data.batching import batch_iterator
from tests.fixtures.tiny_checkpoint import REPO_ROOT

torch.set_num_threads(1)

OSU_TEMPLATE = """osu file format v14

[General]
AudioFilename: audio.wav
Mode: 0

[Metadata]
Title:T{i}
Artist:A
Creator:C
Version:V{i}
BeatmapID:{bid}

[Difficulty]
HPDrainRate:5
CircleSize:4
OverallDifficulty:7
ApproachRate:9
SliderMultiplier:1.4
SliderTickRate:1

[TimingPoints]
500,500,4,2,0,70,1,0

[HitObjects]
{objects}
"""


def write_ors(root, tracks: int = 2, seconds: float = 8.0, maps: int = 2, objects: int = 16, seed: int = 0):
    """``Track{i:05d}/{audio.wav, metadata.json, beatmaps/map{j}.osu}``."""
    rng = np.random.default_rng(seed)
    sr = 16000
    for track_i in range(tracks):
        track = root / f"Track{track_i:05d}"
        (track / "beatmaps").mkdir(parents=True)
        t = np.arange(int(sr * seconds)) / sr
        x = 0.4 * np.sin(2 * np.pi * (220 + 40 * track_i) * t) + 0.05 * rng.standard_normal(len(t))
        with wave.open(str(track / "audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        metadata = {"Beatmaps": {}}
        for bm_i in range(maps):
            hit_objects = "\n".join(
                f"{int(rng.integers(50, 450))},{int(rng.integers(50, 330))},{500 + k * 400},"
                f"{5 if k % 4 == 0 else 1},0,0:0:0:0:" for k in range(objects))
            (track / "beatmaps" / f"map{bm_i}.osu").write_text(
                OSU_TEMPLATE.format(i=bm_i, bid=track_i * 10 + bm_i, objects=hit_objects))
            metadata["Beatmaps"][f"map{bm_i}"] = {"BeatmapId": track_i * 10 + bm_i, "Index": track_i * maps + bm_i,
                                                  "StandardStarRating": {"0": 3.5, "64": 4.5}, "RankedYear": 2018}
        (track / "metadata.json").write_text(json.dumps(metadata))
    return root


def data_overrides(root, src: int = 256, tgt: int = 384):
    # ors reads the descriptor table from the repo's local csv (test_data.py)
    return ["data.dataset_type=ors", "data.descriptors_path=datasets/beatmap_descriptors.csv",
            f"data.train_dataset_path={root}", "data.train_dataset_start=0", "data.train_dataset_end=2",
            f"data.test_dataset_path={root}", "data.test_dataset_start=0", "data.test_dataset_end=2",
            f"data.src_seq_len={src}", f"data.tgt_seq_len={tgt}"]


@pytest.fixture(scope="module")
def ors_root(tmp_path_factory):
    return write_ors(tmp_path_factory.mktemp("ors"))


def batches(package, args, test: bool, balancer: int):
    """Every batch of one epoch, from the same seeds."""
    dataset_cls, parser_cls, vocab_fn, iterate = package
    vocab = vocab_fn(args)
    dataset = dataset_cls(args.data, parser_cls(args, vocab), vocab, test=test)
    random.seed(0)
    np.random.seed(0)
    return list(iterate(iter(dataset), 2, balancer_buffer_size=balancer, drop_last=True))


JAX_DATA = (JaxOrsDataset, JaxBeatmapParser, jax_build_vocabulary, jax_batch_iterator)
PORT_DATA = (OrsDataset, BeatmapParser, build_vocabulary, batch_iterator)


@pytest.mark.parametrize("test,balancer", [(True, 0), (False, 4)])
def test_ors_batches_equal_the_jax_ones(ors_root, test, balancer):
    """The eval stream, and the training stream with its augmentations
    (speed, flips, offsets, dropouts) drawn from the same seeds and the
    token balancer on."""
    overrides = data_overrides(ors_root)
    jax_args = compose(REPO_ROOT / "configs" / "train", "v32", overrides=overrides, schema_cls=schema.TrainConfig)
    want = batches(JAX_DATA, jax_args, test, balancer)
    got = batches(PORT_DATA, load_train_config("v32", overrides), test, balancer)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_unported_datasets_raise(ors_root):
    args = load_train_config("v32", data_overrides(ors_root))
    vocab = build_vocabulary(args)
    for kind in ("web", "mmrs"):
        args.data.dataset_type = kind
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_dataset(args.data, BeatmapParser(args, vocab), vocab)


TINY_MODEL = ["model.overwrite.d_model=64", "model.overwrite.encoder_layers=1", "model.overwrite.decoder_layers=2",
              "model.overwrite.encoder_attention_heads=4", "model.overwrite.decoder_attention_heads=4",
              "model.overwrite.encoder_ffn_dim=128", "model.overwrite.decoder_ffn_dim=128"]


def train_argv(root, ckpt, total_steps: int):
    return ["-cn", "v32", "device=cpu", "mixed_precision=no", f"checkpoint_path={ckpt}",
            *data_overrides(root, src=128, tgt=192), *TINY_MODEL,
            "optim.batch_size=2", "optim.grad_acc=1", f"optim.total_steps={total_steps}", "optim.sustain_steps=1",
            "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0", "logging.every_steps=1",
            "logging.log_with=none", "eval.every_steps=2", "eval.steps=1", "checkpoint.every_steps=2"]


def test_train_main_runs_on_the_cpu_and_resumes(ors_root, tmp_path):
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    state = train_main.main(train_argv(ors_root, ckpt, 2), log_dir=str(logs))
    assert state.step == 2 and state.optimizer.count == 2
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    train_records = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train_records] == [1, 2]
    assert all(np.isfinite(r["train/loss"]) and r["train/grad_l2"] > 0 for r in train_records)
    assert any(key.startswith("test/") and key.endswith("/loss") for r in records for key in r)  # the eval ran
    assert (ckpt / "2" / "state.pt").exists() and (ckpt / "tokenizer.json").exists()
    assert json.loads((ckpt / "manifest.json").read_text())["metadata"]["format"] == "torch.save"

    resumed = train_main.main(train_argv(ors_root, ckpt, 3), log_dir=str(logs))
    assert resumed.step == 3 and resumed.optimizer.count == 3
    assert (ckpt / "3" / "state.pt").exists()
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "train/loss" in r] == [1, 2, 3]  # the second run began at step 2


@pytest.mark.parametrize("change", [["enable_lora=true"], ["pretrained_path=somewhere"],
                                    ["parallel.num_processes=2"], ["parallel.fsdp_axis=data"],
                                    ["profile.do_profile=true"], ["optim.name=adafactor"]])
def test_unported_training_options_raise(ors_root, tmp_path, change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_main.main(train_argv(ors_root, tmp_path / "ckpt", 1) + change, log_dir=str(tmp_path / "logs"))
