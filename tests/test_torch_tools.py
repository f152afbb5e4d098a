"""The port's host tools against the repo's JAX scripts, on the CPU:
``dataloading`` (``stats`` lengths and ``audition`` WAV bytes from the same
seeds), ``push_to_hub`` (the cases of test_push_to_hub.py, then a
checkpoint with a ``gamemode=1`` subfolder staged and read back by both
packages, leaf for leaf, the removed mappers' rows 0), ``utils/print_ckpt``
(its lines on a native checkpoint and a bare msgpack; the port trainer's
checkpoints; an orbax directory refused), ``plot_difficulties`` (the star
ratings) and ``utils/distance_distance`` (MSE and MAE). Each tool that
draws says so and carries on where matplotlib is missing.
"""

import importlib.util
import sys
import types

import numpy as np
import pytest
import torch

import push_to_hub as jax_push_to_hub
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu_torch import dataloading, plot_difficulties, push_to_hub
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models.io import load_checkpoint, save_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import Mapperatorinator, build_config
from mapperatorinator_tpu_torch.models.params import flatten, flax_layout, init_params, torch_name
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.osu.events import EventRange, EventType
from mapperatorinator_tpu_torch.osu.vocab import Vocabulary
from mapperatorinator_tpu_torch.utils import distance_distance, print_ckpt
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint
from tests.test_torch_data import TINY_MODEL, data_overrides, write_ors

torch.set_num_threads(1)


def jax_script(relative: str):
    """A script of the repo loaded by path, under a name of its own."""
    spec = importlib.util.spec_from_file_location("jax_" + relative.replace("/", "_")[:-3], REPO_ROOT / relative)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ors(tmp_path_factory):
    return write_ors(tmp_path_factory.mktemp("tools") / "ors", seconds=4.0, objects=8)


# -- dataloading -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["stats", "audition"])
def test_dataloading_matches_jax(ors, tmp_path, monkeypatch, capsys, mode):
    argv = ["-cn", "v32", *data_overrides(ors, src=128, tgt=192), "--mode", mode, "--limit", "64"]
    jax_tool = jax_script("dataloading.py")
    results = {}
    for name, tool in (("jax", jax_tool), ("port", dataloading)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        np.random.seed(0)
        __import__("random").seed(0)
        results[name] = (tool.main(argv), capsys.readouterr().out)
    (want, want_out), (got, got_out) = results["jax"], results["port"]
    if mode == "stats":
        assert got == want and len(got) > 4
        assert got_out == want_out
    else:
        written = sorted(p.name for p in (tmp_path / "port" / "audition").iterdir())
        assert written == sorted(p.name for p in (tmp_path / "jax" / "audition").iterdir()) and len(written) == 5
        for name in written:
            assert (tmp_path / "port" / "audition" / name).read_bytes() == \
                (tmp_path / "jax" / "audition" / name).read_bytes()


# -- push_to_hub -------------------------------------------------------------


def test_remove_mappers_nulls_rows():
    vocab = Vocabulary(event_ranges=[EventRange(EventType.TIME_SHIFT, 0, 9)],
                       input_event_ranges=[EventRange(EventType.MAPPER, 0, 4)], num_mapper_classes=4,
                       mapper_idx={111: 0, 222: 1, 333: 2})
    token_222 = vocab.encode_mapper_id(222)
    # the test_push_to_hub.py tree, as a state dict: the Dense kernel (5, 8) is a Linear weight (8, 5)
    paths = {"mapper_embedder.dense.weight": "params/mapper_embedder/dense/kernel",
             "decoder_embed.weight": "params/decoder_embed/embedding"}
    state = {"mapper_embedder.dense.weight": torch.ones(8, 5), "decoder_embed.weight": torch.ones(vocab.vocab_size_in, 8)}
    out, vocab = push_to_hub.remove_mappers_from_params(state, paths, vocab, [222, 999])
    emb = flax_layout(out["mapper_embedder.dense.weight"], paths["mapper_embedder.dense.weight"])
    assert (emb[1] == 0).all() and (emb[0] == 1).all() and (emb[2] == 1).all()
    tok = out["decoder_embed.weight"].numpy()
    assert (tok[token_222] == 0).all()
    assert (np.delete(tok, token_222, axis=0) == 1).all()
    assert 222 not in vocab.mapper_idx and 111 in vocab.mapper_idx
    assert (state["decoder_embed.weight"] == 1).all()  # the input is left as it was


def test_discover_submodel_paths(tmp_path):
    sub = tmp_path / "gamemode=3"
    sub.mkdir()
    (sub / "params.msgpack").write_bytes(b"x")
    (sub / "tokenizer.json").write_text("{}")
    (tmp_path / "not_a_ckpt").mkdir()
    assert push_to_hub.discover_submodel_paths(tmp_path) == jax_push_to_hub.discover_submodel_paths(tmp_path) == [sub]


def test_load_removed_users_missing_file(tmp_path):
    assert push_to_hub.load_removed_users(tmp_path / "nope.txt") == []
    f = tmp_path / "removed.txt"
    f.write_text("111\n\n222\n")
    assert push_to_hub.load_removed_users(f) == [111, 222]
    assert push_to_hub.load_removed_users() == jax_push_to_hub.load_removed_users()


def mapper_checkpoint(directory):
    """A tiny v32-architecture checkpoint whose vocabulary holds the repo's
    mapper table, so its token table has a row for each mapper."""
    args = load_train_config("v32", ["mixed_precision=no", *TINY_MODEL])
    vocab = build_vocabulary(args)
    model = Mapperatorinator(build_config(args, vocab))
    init_params(model, 5)
    save_checkpoint(directory, model.cfg, model.state_dict(), vocab)
    return model, vocab


def test_staged_checkpoints_read_back_in_both_packages(tmp_path, monkeypatch):
    """The port nulls each removed mapper's token row in the decoder's
    table, ``decoder_embedder/embedding``, which the JAX script's
    ``decoder_embed/embedding`` misses: its staging leaves those rows as
    they were, and is equal to the port's everywhere else."""
    model, vocab = mapper_checkpoint(tmp_path / "ckpt")
    sub_model, _ = mapper_checkpoint(tmp_path / "ckpt" / "gamemode=1")
    removed = sorted(vocab.mapper_idx)[3:5]
    rows = [vocab.encode_mapper_id(user) for user in removed]
    monkeypatch.setattr(push_to_hub, "load_removed_users", lambda: removed)
    staged = push_to_hub.main(["-cn", "v32", f"model_path={tmp_path / 'ckpt'}", "--stage-dir",
                               str(tmp_path / "staged")])
    for rel, source in (("", model), ("gamemode=1", sub_model)):
        out = staged / rel if rel else staged
        port_model, port_vocab = load_checkpoint(out)
        _, jparams, jvocab = jax_load_checkpoint(out)
        assert not set(removed) & set(port_vocab.mapper_idx) and not set(removed) & set(jvocab.mapper_idx)
        assert len(port_vocab.mapper_idx) == len(vocab.mapper_idx) - 2
        state, source_state = port_model.state_dict(), source.state_dict()
        leaves = flatten(jparams)
        assert {torch_name(p) for p in leaves} == set(state)
        for path, leaf in leaves.items():
            name = torch_name(path)
            np.testing.assert_array_equal(flax_layout(state[name], path).numpy(), np.asarray(leaf), err_msg=path)
            want = flax_layout(source_state[name], path).clone()
            if path.endswith("decoder_embedder/embedding"):
                assert want[rows].abs().sum() > 0
                want[rows] = 0
            assert torch.equal(flax_layout(state[name], path), want), path
    jax_push_to_hub.stage_checkpoints(tmp_path / "ckpt", tmp_path / "jax_staged", removed)
    _, jparams, jvocab = jax_load_checkpoint(tmp_path / "jax_staged")
    assert jvocab.mapper_idx == load_checkpoint(staged)[1].mapper_idx
    source_state = model.state_dict()
    for path, leaf in flatten(jparams).items():
        want = flax_layout(source_state[torch_name(path)], path).numpy()
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=path)


# -- print_ckpt --------------------------------------------------------------


def test_print_ckpt_lines_equal_the_jax_ones(tmp_path, capsys):
    jax_tool = jax_script("utils/print_ckpt.py")
    ckpt = make_tiny_checkpoint(tmp_path / "ckpt")
    for target, extra in ((ckpt, []), (ckpt / "params.msgpack", ["--filter", "decoder"]), (ckpt, ["--tree"])):
        assert jax_tool.main([str(target), *extra]) == 0
        want = capsys.readouterr().out
        assert print_ckpt.main([str(target), *extra]) == 0
        got = capsys.readouterr().out
        assert got == want and "parameters" in got


def test_print_ckpt_reads_the_trainers_checkpoints(tmp_path, capsys):
    from mapperatorinator_tpu_torch.train.loop import CheckpointManager
    from mapperatorinator_tpu_torch.train.step import TrainState

    layer = torch.nn.Linear(3, 2)
    manager = CheckpointManager(tmp_path / "run")
    state = TrainState(step=0, model=layer, optimizer=torch.optim.SGD(layer.parameters(), lr=0.1))
    for step in (4, 7):
        state.step = step
        manager.save(step, state)
    tree, fmt = print_ckpt.load_tree(tmp_path / "run")
    assert fmt == "torch.save" and tree["step"] == 7
    assert print_ckpt.main([str(tmp_path / "run"), "--filter", "model"]) == 0
    out = capsys.readouterr().out
    assert "model.weight  (2, 3)  torch.float32" in out and "8 parameters" in out

    torch.save(layer.state_dict(), tmp_path / "layer.bin")
    from safetensors.torch import save_file

    save_file(layer.state_dict(), tmp_path / "layer.safetensors")
    for name, fmt in (("layer.bin", "torch"), ("layer.safetensors", "safetensors")):
        tree, got_fmt = print_ckpt.load_tree(tmp_path / name)
        assert got_fmt == fmt and torch.equal(torch.as_tensor(tree["weight"]), layer.weight.detach())

    (tmp_path / "orbax" / "5" / "state").mkdir(parents=True)
    (tmp_path / "orbax" / "5" / "state" / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        print_ckpt.load_tree(tmp_path / "orbax")


# -- plot_difficulties and distance_distance ----------------------------------


def test_plot_difficulties_matches_jax(ors, tmp_path, capsys, monkeypatch):
    jax_tool = jax_script("plot_difficulties.py")
    want = jax_tool.main([str(ors), "0", "2"])
    want_out = capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a machine without it
    got = plot_difficulties.main([str(ors), "0", "2", "-o", str(tmp_path / "stars.png")])
    got_out = capsys.readouterr().out
    assert got == want and len(got) == 4 and all(s > 0 for s in got)
    assert got_out == want_out + f"matplotlib is not installed: {tmp_path / 'stars.png'} not drawn\n"


def test_distance_distance_matches_jax(ors, tmp_path, monkeypatch):
    jax_tool = jax_script("utils/distance_distance.py")
    generated = tmp_path / "generated"
    generated.mkdir()
    for i in range(2):
        (generated / f"gen{i}.osu").write_text((ors / f"Track0000{i}" / "beatmaps" / "map1.osu").read_text())
    argv = types.SimpleNamespace(ref_beatmap=str(ors / "Track00000" / "beatmaps" / "map0.osu"),
                                 beatmap=str(generated), out_dir=str(tmp_path / "plots"))
    want = jax_tool.run(argv)
    got = distance_distance.run(argv)
    assert [r["name"] for r in got] == [r["name"] for r in want] and len(got) == 2
    for g, w in zip(got, want):
        assert g["mse"] == w["mse"] and g["mae"] == w["mae"] and g["mse"] > 0
        np.testing.assert_array_equal(g["delta"], w["delta"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = distance_distance.run(argv)
    assert [r["mse"] for r in bare] == [r["mse"] for r in want] and "plot" not in bare[0]
