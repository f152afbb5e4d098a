"""Legacy accelerate checkpoints on the port against the JAX package.

A tiny T5 v1.1 model of the port's ``t5_base`` training preset (d_model 32, 2 + 2
layers; the default model config's style embedder and projected input, a
tied head) is written as the reference's training runs wrote one:
``custom_checkpoint_0.pkl``, a ``torch.save`` of the tokenizer state whose
enums and ``EventRange`` are instances of classes of a stand-in module
registered under a reference path (``osuT5.osuT5.event``), beside the
reference state dict as ``pytorch_model.bin`` or as two
``model-0000N-of-00002.safetensors`` shards. Both packages'
``load_legacy_checkpoint`` read it with the same training config: the
vocabularies are equal, and so are the parameters, less the decoder token
table where the JAX tree keeps one that the port's decoder does not hold.
Also: the routed unpickler alone, ``_normalize_tokenizer_state``, the
missing training config, and ``load_checkpoint``'s message on a legacy
directory.
"""

import dataclasses
import enum
import pickle
import sys
import types

import pytest
import torch
from safetensors.numpy import save_file

from mapperatorinator_tpu.models.legacy import load_legacy_checkpoint as jax_load_legacy_checkpoint
from mapperatorinator_tpu_torch.config import load_train_config
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.legacy import (_normalize_tokenizer_state, is_legacy_checkpoint,
                                                      load_legacy_checkpoint, routed_pickle_module)
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.osu import ContextType, EventRange, EventType, Vocabulary, build_vocabulary
from tests.test_torch_config import composed_train_t5_base
from tests.test_torch_convert import TINY, hf_config, hf_state_dict

torch.set_num_threads(1)

REFERENCE_MODULE = "osuT5.osuT5.event"
OVERRIDES = tuple(f"model.overwrite.{k}={v}" for k, v in TINY.items()) + ("data.src_seq_len=256",
                                                                          "data.tgt_seq_len=128")


@pytest.fixture
def reference_events():
    """A stand-in for the reference's ``osuT5.osuT5.event``: every event and
    context type of the port, and ``EventRange``, as classes of that module,
    so that they pickle under its path."""
    mod = types.ModuleType(REFERENCE_MODULE)
    mod.EventType = enum.Enum("EventType", [(m.name, m.value) for m in EventType], module=REFERENCE_MODULE)
    mod.ContextType = enum.Enum("ContextType", [(m.name, m.value) for m in ContextType], module=REFERENCE_MODULE)
    mod.EventRange = dataclasses.make_dataclass("EventRange", [("type", object), ("min_value", int),
                                                               ("max_value", int)], module=REFERENCE_MODULE)
    names = ("osuT5", "osuT5.osuT5", REFERENCE_MODULE)
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules.update({"osuT5": types.ModuleType("osuT5"), "osuT5.osuT5": types.ModuleType("osuT5.osuT5"),
                        REFERENCE_MODULE: mod})
    yield mod
    for n in names:
        if saved[n] is not None:
            sys.modules[n] = saved[n]
        else:
            sys.modules.pop(n, None)


def pickled_state(vocab: Vocabulary, mod) -> dict:
    """The tokenizer state as the reference pickled it: enum keys and
    ``EventRange`` objects of the reference module."""
    sd = vocab.state_dict()
    er = lambda d: mod.EventRange(mod.EventType(d["type"]), d["min_value"], d["max_value"])  # noqa: E731
    out = dict(sd)
    for field in ("event_ranges", "input_event_ranges"):
        out[field] = [er(d) for d in sd[field]]
    for field, cls in (("context_sos", mod.ContextType), ("context_eos", mod.ContextType),
                       ("event_start", mod.EventType), ("event_end", mod.EventType)):
        out[field] = {cls(k): v for k, v in sd[field].items()}
    out["event_range"] = {mod.EventType(k): er(v) for k, v in sd["event_range"].items()}
    return out


def write_legacy_checkpoint(directory, mod, fmt: str):
    """A legacy directory of the tiny ``t5_base`` model: the
    pickled tokenizer and the reference state dict (``bin`` or two
    ``safetensors`` shards). Returns (the training config, the vocabulary,
    the state dict)."""
    train = load_train_config("t5_base", OVERRIDES)
    vocab = build_vocabulary(train)
    cfg = build_config(train, vocab)
    sd = hf_state_dict("t5", hf_config(cfg), seed=4)
    directory.mkdir(parents=True)
    torch.save(pickled_state(vocab, mod), directory / "custom_checkpoint_0.pkl")
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, directory / "pytorch_model.bin")
    else:
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2]), 1):
            save_file({k: sd[k] for k in part}, str(directory / f"model-0000{i}-of-00002.safetensors"))
    return train, vocab, sd


def test_routed_unpickler_maps_reference_classes_to_the_ports(reference_events):
    mod = reference_events
    payload = {"et": mod.EventType.CIRCLE, "er": mod.EventRange(mod.EventType.TIME_SHIFT, 0, 100),
               "ct": mod.ContextType.MAP}
    raw = pickle.dumps(payload)
    assert pickle.loads(raw)["et"] is mod.EventType.CIRCLE  # plain unpickling finds the reference classes
    out = routed_pickle_module.loads(raw)
    assert out["et"] is EventType.CIRCLE and out["ct"] is ContextType.MAP
    assert isinstance(out["er"], EventRange) and out["er"].type is EventType.TIME_SHIFT
    assert (out["er"].min_value, out["er"].max_value) == (0, 100)


def test_normalize_tokenizer_state():
    state = {
        "offset": 3, "context_sos": {ContextType.MAP: 10}, "context_eos": {ContextType.MAP: 11},
        "event_ranges": [EventRange(EventType.TIME_SHIFT, 0, 100)], "input_event_ranges": [],
        "num_classes": 5, "num_diff_classes": 0, "max_difficulty": 10, "event_start": {EventType.TIME_SHIFT: 3},
        "event_end": {EventType.TIME_SHIFT: 104}, "event_range": {EventType.TIME_SHIFT:
                                                                  EventRange(EventType.TIME_SHIFT, 0, 100)},
        "vocab_size_out": 104, "vocab_size_in": 104, "beatmap_idx": {1: 0}, "beatmap_mapper": {},
        "mapper_idx": {}, "num_mapper_classes": 0, "beatmap_descriptors": {}, "descriptor_idx": {},
        "num_cs_classes": 0,
    }
    normal = _normalize_tokenizer_state(state)
    assert normal["event_ranges"] == [{"type": "t", "min_value": 0, "max_value": 100}]
    assert normal["context_sos"] == {"map": 10} and normal["event_start"] == {"t": 3}
    assert normal["event_range"] == {"t": {"type": "t", "min_value": 0, "max_value": 100}}
    assert _normalize_tokenizer_state(normal) == normal
    vocab = Vocabulary.from_state_dict(normal)
    assert vocab.vocab_size_out == 104 and vocab.context_sos[ContextType.MAP] == 10
    assert vocab.event_start[EventType.TIME_SHIFT] == 3


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_both_packages_load_the_same_model_and_vocabulary(tmp_path, reference_events, fmt):
    directory = tmp_path / "legacy"
    train, vocab, sd = write_legacy_checkpoint(directory, reference_events, fmt)
    assert is_legacy_checkpoint(directory)
    jmodel, jparams, jvocab = jax_load_legacy_checkpoint(directory, composed_train_t5_base(OVERRIDES))
    model, got_vocab = load_legacy_checkpoint(directory, train)
    assert got_vocab.state_dict() == jvocab.state_dict() == vocab.state_dict()
    cfg = model.cfg
    assert cfg.backbone.dtype == torch.float32 and train.mixed_precision == "bf16"  # the loader computes in fp32
    assert (cfg.backbone.position_scheme, cfg.backbone.tie_word_embeddings, cfg.do_style_embed) == (
        "t5_relpos", True, True)
    assert jmodel.config.backbone.position_scheme == "t5_relpos"
    want = params_from_flax(jparams)
    got = model.state_dict()
    assert set(got) <= set(want) and set(want) - set(got) <= {"transformer.decoder.embed_tokens.weight"}
    for name in got:
        assert got[name].dtype == torch.float32 and torch.equal(got[name], want[name]), name
    # the tied head reads the shared table; the style embedding widens the projected input by d_model
    assert torch.equal(got["transformer.decoder.embed_tokens.weight"],
                       torch.from_numpy(sd["transformer.shared.weight"]))
    assert got["encoder_embedder.weight"].shape == (TINY["d_model"], cfg.n_mels + TINY["d_model"])


def test_a_legacy_load_needs_the_training_config(tmp_path, reference_events):
    directory = tmp_path / "legacy"
    write_legacy_checkpoint(directory, reference_events, "bin")
    with pytest.raises(ValueError, match="train_args"):
        load_legacy_checkpoint(directory)


def test_load_checkpoint_names_the_legacy_loader(tmp_path, reference_events):
    directory = tmp_path / "legacy"
    write_legacy_checkpoint(directory, reference_events, "safetensors")
    with pytest.raises(ValueError, match=r"mapperatorinator_tpu_torch\.models\.legacy\.load_legacy_checkpoint"
                                         r"\(dir, train_args\)"):
        load_checkpoint(directory)
