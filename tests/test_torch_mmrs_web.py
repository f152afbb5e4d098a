"""The port's ``mmrs`` and ``web`` datasets against the JAX package's.

Fixtures in the manner of ``tests/test_dataset_backends.py``, widened: three
sets, gamemodes 0 and 3 (a mania set with hold notes), a set with a single
map (which ``add_gd_context`` skips), and a row with nulls (no ranked date,
difficulty or user). The MMRS metadata is written by pandas in a shuffled
row order, once with its RangeIndex and once with a stored index; the web
data is two shards under ``compressed/``.

* ``filter_mmrs_metadata`` keeps the rows the JAX function keeps, in its
  order, with the same ``BeatmapIdx``, for each filter.
* Under the same ``random`` / ``np.random`` seeds, ``MmrsDataset`` (``-cn
  v28``'s data: its GD context draws a map with ``sample``) and
  ``WebDataset`` (``-cn v32``'s: shard and row shuffles, DT augmentation's
  star rating through the native calculator) yield the JAX classes'
  samples, every key equal, on the train and test splits, with and without
  ``add_gd_context``; and the collated, token-balanced batches are equal.
* ``calc_fid``'s ``mmrs`` scan gives the JAX script's paths.
* ``train.main -cn v32 device=cpu`` takes two steps from a web shard
  directory and ``-cn v28`` from an MMRS root, each with its recipe's own
  ``dataset_type``; a web source that is not a directory raises, naming the
  network.
"""

import json
import random
from datetime import datetime

import numpy as np
import pandas as pd
import pytest
import torch

import calc_fid as jax_calc_fid
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.osu import BeatmapParser as JaxBeatmapParser
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu.train.data import build_dataset as jax_build_dataset
from mapperatorinator_tpu.train.data.batching import batch_iterator as jax_batch_iterator
from mapperatorinator_tpu.train.data.mmrs import filter_mmrs_metadata as jax_filter
from mapperatorinator_tpu.train.data.mmrs import load_mmrs_metadata as jax_load
from mapperatorinator_tpu_torch import calc_fid
from mapperatorinator_tpu_torch.config import load_fid_config, load_train_config
from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
from mapperatorinator_tpu_torch.train import main as train_main
from mapperatorinator_tpu_torch.train.data import MmrsDataset, WebDataset, build_dataset
from mapperatorinator_tpu_torch.train.data.batching import batch_iterator
from mapperatorinator_tpu_torch.train.data.mmrs import filter_mmrs_metadata, load_mmrs_metadata
from tests.fixtures.parquet_fixtures import wav_bytes
from tests.fixtures.tiny_checkpoint import REPO_ROOT
from tests.test_torch_data import TINY_MODEL

torch.set_num_threads(1)

OSU = """osu file format v14

[General]
AudioFilename: audio.wav
Mode: {mode}

[Metadata]
Title:T{bid}
Artist:A
Creator:C
Version:V{bid}
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
SECONDS = 4.0
# (set id, its maps' (beatmap id, gamemode)): a standard set, a mania set and a set of one map; the last map of the
# first set is the row with nulls
SETS = [(300, [(31, 0), (32, 0), (33, 0), (34, 0)]), (100, [(11, 3), (12, 3)]), (200, [(21, 0)])]
NULL_ID = 34


def osu_text(bid: int, mode: int, rng) -> str:
    times = 500 + 250 * np.arange(int((SECONDS - 1) * 4))
    if mode == 3:  # four columns, every third note held for 200 ms
        objects = [f"{64 + 128 * int(rng.integers(0, 4))},192,{t},{128 if k % 3 == 0 else 1},0,"
                   + (f"{t + 200}:0:0:0:0:" if k % 3 == 0 else "0:0:0:0:") for k, t in enumerate(times)]
    else:
        objects = [f"{int(rng.integers(50, 450))},{int(rng.integers(50, 330))},{t},{5 if k % 4 == 0 else 1},0,"
                   "0:0:0:0:" for k, t in enumerate(times)]
    return OSU.format(mode=mode, bid=bid, objects="\n".join(objects))


def mmrs_rows(root):
    """Writes each set's folder under ``root / "data"``; the metadata rows."""
    rng = np.random.default_rng(0)
    rows = []
    for n, (set_id, maps) in enumerate(SETS):
        folder = root / "data" / f"{set_id} A - T{n}"
        folder.mkdir(parents=True)
        (folder / "audio.wav").write_bytes(wav_bytes(SECONDS, 220.0 + 40 * n))
        for k, (bid, mode) in enumerate(maps):
            (folder / f"map{bid}.osu").write_text(osu_text(bid, mode, rng))
            null = bid == NULL_ID
            rows.append({
                "BeatmapSetId": set_id, "Id": bid, "ModeInt": mode, "Ranked": 1 + k % 2,
                "RankedDate": None if null else datetime(2015 + 2 * n + k, 5, 1),
                "SubmittedDate": datetime(2014 + 2 * n, 3, 1),
                "DifficultyRating": None if null else 3.0 + n + 0.5 * k,
                "StarRating": [2.0 + n + k + 0.5 * j for j in range(7)],
                "BeatmapSetFolder": folder.name, "BeatmapFile": f"map{bid}.osu", "AudioFile": "audio.wav",
                "UserId": None if null else 42 + k,
            })
    return rows


def write_mmrs(root, index: str):
    rows = mmrs_rows(root)
    order = np.random.default_rng(1).permutation(len(rows))
    frame = pd.DataFrame([rows[i] for i in order])
    if index == "stored":
        frame.index = [int(10 * i + 5) for i in order]
    frame.to_parquet(root / "metadata.parquet")
    return root


@pytest.fixture(scope="module", params=["range", "stored"])
def mmrs_roots(tmp_path_factory, request):
    """An MMRS root with its RangeIndex, and one with a stored index."""
    return write_mmrs(tmp_path_factory.mktemp(f"mmrs_{request.param}"), request.param)


@pytest.fixture(scope="module")
def mmrs_root(tmp_path_factory):
    return write_mmrs(tmp_path_factory.mktemp("mmrs"), "stored")


@pytest.fixture(scope="module")
def web_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("web")
    (root / "compressed").mkdir()
    rng = np.random.default_rng(2)
    rows = []
    for n, (set_id, maps) in enumerate(SETS):
        beatmaps = [{"beatmap_id": 1000 + bid, "beatmapset_id": set_id, "mode": mode, "approved": 1 + k % 2,
                     "approved_date": None if bid == NULL_ID else f"{2015 + 2 * n + k}-05-01 10:00:00",
                     "submit_date": f"{2014 + 2 * n}-03-01", "difficultyrating": None if bid == NULL_ID else 3.0 + k,
                     "user_id": 42 + k, "content": osu_text(1000 + bid, mode, rng)}
                    for k, (bid, mode) in enumerate(maps)]
        rows.append({"json": json.dumps({"beatmaps": beatmaps}), "opus": {"bytes": wav_bytes(SECONDS, 220.0 + 40 * n)}})
    pd.DataFrame(rows[:2]).to_parquet(root / "compressed" / "train-00000.parquet")
    pd.DataFrame(rows[2:]).to_parquet(root / "compressed" / "train-00001.parquet")
    return root


def jax_args(name, overrides):
    return compose(REPO_ROOT / "configs" / "train", name, overrides=overrides, schema_cls=schema.TrainConfig)


def rows_of(table) -> list:
    """The JAX DataFrame's or the port's table's rows, as
    ``(BeatmapSetId, Id, BeatmapIdx, UserId)``."""
    if isinstance(table, pd.DataFrame):
        return [(int(s), int(i), int(r["BeatmapIdx"]), r["UserId"]) for (s, i), r in table.iterrows()]
    return [(int(s), int(i), int(r["BeatmapIdx"]), r["UserId"])
            for s, i, r in zip(table.set_ids, table.ids, (table.row(k) for k in range(len(table))))]


FILTERS = [{}, {"start": 0, "end": 2}, {"start": 1, "end": 3}, {"start": 2, "end": 3}, {"subset_ids": [300, 100]},
           {"subset_ids": [200]}, {"gamemodes": [0]}, {"gamemodes": [3]}, {"ranked_statuses": [2]},
           {"min_year": 2018}, {"max_year": 2017}, {"min_difficulty": 4.0}, {"max_difficulty": 4.0},
           {"start": 0, "end": 3, "gamemodes": [0, 3], "ranked_statuses": [1, 2], "min_year": 2015,
            "max_year": 2030, "min_difficulty": 2.0, "max_difficulty": 9.0}]


@pytest.mark.parametrize("filters", FILTERS, ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()) or "none")
def test_filters_keep_the_jax_rows(mmrs_roots, filters):
    want = rows_of(jax_filter(jax_load(mmrs_roots), **filters))
    got = rows_of(filter_mmrs_metadata(load_mmrs_metadata(mmrs_roots), **filters))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and (g[3] == w[3] or (np.isnan(g[3]) and np.isnan(w[3])))


def test_a_missing_subset_id_raises(mmrs_root):
    with pytest.raises(KeyError):
        jax_filter(jax_load(mmrs_root), subset_ids=[300, 999])
    with pytest.raises(KeyError, match="999"):
        filter_mmrs_metadata(load_mmrs_metadata(mmrs_root), subset_ids=[300, 999])


def data_args(kind: str, root, gd: bool) -> list[str]:
    sets = len(SETS) if kind == "mmrs" else 2  # sets, or shards
    return [f"data.train_dataset_path={root}", "data.train_dataset_start=0", f"data.train_dataset_end={sets}",
            f"data.test_dataset_path={root}", "data.test_dataset_start=0", f"data.test_dataset_end={sets}",
            "data.src_seq_len=128", "data.tgt_seq_len=192", f"data.add_gd_context={str(gd).lower()}"]


JAX = (jax_build_dataset, JaxBeatmapParser, jax_build_vocabulary, jax_batch_iterator)
PORT = (build_dataset, BeatmapParser, build_vocabulary, batch_iterator)


def stream(package, args, test: bool, balancer: int | None):
    """Two epochs' samples, or (``balancer`` set) one epoch's batches, from
    the same seeds."""
    build, parser_cls, vocab_fn, iterate = package
    vocab = vocab_fn(args)
    dataset = build(args.data, parser_cls(args, vocab), vocab, test=test)
    random.seed(0)
    np.random.seed(0)
    if balancer is None:
        return [sample for _ in range(2) for sample in dataset]
    return list(iterate(iter(dataset), 2, balancer_buffer_size=balancer, drop_last=True))


def assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for key in want:
            assert_same(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=where)


CONFIG = {"mmrs": "v28", "web": "v32"}


@pytest.mark.parametrize("kind", ["mmrs", "web"])
@pytest.mark.parametrize("test,gd", [(True, False), (False, False), (False, True)])
def test_samples_equal_the_jax_ones(mmrs_root, web_root, kind, test, gd):
    root = mmrs_root if kind == "mmrs" else web_root
    overrides = data_args(kind, root, gd)
    want = stream(JAX, jax_args(CONFIG[kind], overrides), test, None)
    got = stream(PORT, load_train_config(CONFIG[kind], overrides), test, None)
    assert len(got) == len(want) > 0
    assert_same(got, want)
    if gd:  # the single-map set is skipped
        assert len(want) < len(stream(JAX, jax_args(CONFIG[kind], data_args(kind, root, False)), test, None))


@pytest.mark.parametrize("kind", ["mmrs", "web"])
def test_batches_equal_the_jax_ones(mmrs_root, web_root, kind):
    root = mmrs_root if kind == "mmrs" else web_root
    overrides = data_args(kind, root, False)
    want = stream(JAX, jax_args(CONFIG[kind], overrides), False, 4)
    got = stream(PORT, load_train_config(CONFIG[kind], overrides), False, 4)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_build_dataset_dispatch(mmrs_root, web_root):
    args = load_train_config("v28", data_args("mmrs", mmrs_root, False))
    vocab = build_vocabulary(args)
    assert isinstance(build_dataset(args.data, BeatmapParser(args, vocab), vocab), MmrsDataset)
    args = load_train_config("v32", data_args("web", web_root, False))
    assert isinstance(build_dataset(args.data, BeatmapParser(args, vocab), vocab), WebDataset)
    args.data.train_dataset_path = "project-riz/osu-beatmaps"  # the recipe's hub repo id
    with pytest.raises(NotImplementedError, match="network"):
        build_dataset(args.data, BeatmapParser(args, vocab), vocab)


@pytest.mark.parametrize("filters", [[], ["min_year=2016", "max_difficulty=4.5"], ["gamemodes=[3]"]])
def test_calc_fid_mmrs_paths(mmrs_root, filters):
    overrides = [f"dataset_path={mmrs_root}", "dataset_type=mmrs", "dataset_start=0", f"dataset_end={len(SETS)}",
                 "gamemodes=[0,3]", *filters]
    want = jax_calc_fid.get_beatmap_paths_by_gamemode(
        compose(REPO_ROOT / "configs", "calc_fid", overrides=overrides, schema_cls=schema.FidConfig))
    got = calc_fid.get_beatmap_paths_by_gamemode(load_fid_config("calc_fid", overrides))
    assert got == want and sum(len(v) for v in want.values()) > 0


@pytest.mark.parametrize("name,kind", [("v32", "web"), ("v28", "mmrs")])
def test_train_main_from_the_recipes_dataset(mmrs_root, web_root, tmp_path, name, kind):
    """Two steps at tiny width, with the recipe's own ``dataset_type``."""
    root = mmrs_root if kind == "mmrs" else web_root
    ckpt, logs = tmp_path / "ckpt", tmp_path / "logs"
    argv = ["-cn", name, "device=cpu", "mixed_precision=no", f"checkpoint_path={ckpt}",
            *data_args(kind, root, False), *TINY_MODEL, "optim.batch_size=2", "optim.grad_acc=1",
            "optim.total_steps=2", "optim.warmup_steps=1", "dataloader.num_workers=0",
            "dataloader.balancer_buffer_size=0", "logging.every_steps=1", "logging.log_with=none",
            "eval.every_steps=0", "checkpoint.every_steps=1000"]
    assert load_train_config(name, argv[2:]).data.dataset_type == kind
    state = train_main.main(argv, log_dir=str(logs))
    assert state.step == 2
    losses = [r["train/loss"] for r in map(json.loads, (logs / "metrics.jsonl").read_text().splitlines())
              if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_chip_smoke_datasets(tmp_path):
    """The datasets ``chip_smoke.py`` trains from on the card: the web shard
    its plain writer writes (v32's own ``web``, under ``compressed/``) and
    the MMRS root of the committed metadata (``lora_v32``'s and v28's
    ``mmrs``), whose rows name the folders and files it writes. Each yields
    full-width samples here."""
    import chip_smoke

    web, mmrs = chip_smoke.write_web(tmp_path / "web"), chip_smoke.write_mmrs(tmp_path / "mmrs")
    table = load_mmrs_metadata(mmrs)
    assert len(table) == chip_smoke.ORS_TRACKS * chip_smoke.ORS_MAPS
    for k in range(len(table)):
        row = table.row(k)
        assert (mmrs / "data" / row["BeatmapSetFolder"] / row["BeatmapFile"]).is_file()
        assert (mmrs / "data" / row["BeatmapSetFolder"] / row["AudioFile"]).is_file()
    for name, overrides in (("v32", chip_smoke.web_overrides(web)), ("lora_v32", chip_smoke.mmrs_overrides(mmrs)),
                            ("v28", chip_smoke.mmrs_overrides(mmrs))):
        args = load_train_config(name, overrides)
        vocab = build_vocabulary(args)
        dataset = build_dataset(args.data, BeatmapParser(args, vocab), vocab)
        sample = next(iter(dataset))
        assert sample["decoder_input_ids"].shape == (args.data.tgt_seq_len,)
        assert sample["frames"].shape == ((args.data.src_seq_len - 1) * 128,)
