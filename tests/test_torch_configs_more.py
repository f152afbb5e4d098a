"""The port's compositions of the other configs against the JAX loader, and
v32-mini on the port.

The port composes ``configs/inference/{v32-mini,v31,v30,v29,v28}.yaml``,
``configs/train/<name>.yaml`` for v32-mini and the fine-tune configs
(``lora``, ``lora_v32``, ``v32_ft``, ``v32-mini_ft``), ``configs/mai_mod.yaml``
(``MaiModConfig``, the v32 inference config under ``inference``),
``configs/classifier/train_v1.yaml`` (``ClassifierConfig``),
``configs/rcomplexion/{train_v1,inference_v1}.yaml`` (``RcomplexionConfig``)
and ``configs/calc_fid.yaml`` (``FidConfig``, v32 under ``inference``)
itself; each must equal the JAX composition field for field, with and
without overrides.

v32-mini's backbone is VarWhisper-base: 6 + 6 layers, all attention global.
On a tiny checkpoint of that depth and layout, at narrow widths, both
packages' ``generate`` run greedy with ``-cn v32-mini``: the tokens of every
decode call and the .osu bytes must be equal.
"""

import dataclasses

import pytest
import torch

import inference as jax_inference
from mapperatorinator_tpu.config import compose, schema
from mapperatorinator_tpu.models.mapperatorinator import build_config as jax_build_config
from mapperatorinator_tpu.osu import build_vocabulary as jax_build_vocabulary
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import (compose_config, load_classifier_config, load_config, load_fid_config,
                                               load_mai_mod_config, load_rcomplexion_config, load_train_config)
from mapperatorinator_tpu_torch.config import schema as port_schema
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.osu import build_vocabulary
from tests.fixtures.tiny_checkpoint import REPO_ROOT, make_tiny_checkpoint, make_wav
from tests.test_torch_config import plain

torch.set_num_threads(1)

TRAIN_CONFIGS = ("v32-mini", "lora", "lora_v32", "v32_ft", "v32-mini_ft")
INFERENCE_CONFIGS = ("v32-mini", "v31", "v30", "v29", "v28")
CONFIGS = {  # case -> (config directory under configs/, config name, schema)
    **{name: ("inference", name, schema.InferenceConfig) for name in INFERENCE_CONFIGS},
    **{f"train_{name}": ("train", name, schema.TrainConfig) for name in TRAIN_CONFIGS},
    "mai_mod": ("", "mai_mod", schema.MaiModConfig),
    "classifier_train_v1": ("classifier", "train_v1", schema.ClassifierConfig),
    **{f"rcomplexion_{name}": ("rcomplexion", name, schema.RcomplexionConfig) for name in ("train_v1", "inference_v1")},
    "calc_fid": ("", "calc_fid", schema.FidConfig),
}
LOADERS = {**{name: lambda o, name=name: load_config(name, o) for name in INFERENCE_CONFIGS},
           **{f"train_{name}": lambda o, name=name: load_train_config(name, o) for name in TRAIN_CONFIGS},
           "mai_mod": lambda o: load_mai_mod_config("mai_mod", o),
           "classifier_train_v1": lambda o: load_classifier_config("train_v1", o),
           **{f"rcomplexion_{name}": lambda o, name=name: load_rcomplexion_config(name, o)
              for name in ("train_v1", "inference_v1")},
           "calc_fid": lambda o: load_fid_config("calc_fid", o)}
OVERRIDES = {
    "v32-mini": ("cfg_scale=2", "train.data.src_seq_len=256", "device=cpu", 'descriptors=["clean"]'),
    "v31": ("mapper_id=1234", "difficulty=6.5", "year=2020", "train.model.spectrogram.implementation=pallas",
            "quantized_weights=true", 'output_type=["map", "sv"]'),
    "v30": ("do_sample=false", "train.data.tgt_seq_len=256", "in_context=[]", "precision=bf16"),
    "v29": ("super_timing=false", "temperature=0.7", "train.model.overwrite.d_model=64", "generate_positions=false"),
    "v28": ("timer_iterations=2", "year=2019", 'descriptors=["clean"]', "quantized_kv=true"),
    "train_v32-mini": ("optim.batch_size=4", "mixed_precision=no", "model.overwrite.d_model=64"),
    "train_lora": ("pretrained_path=base", "lora.r=8", "lora.lora_alpha=16", "optim.name=muon"),
    "train_lora_v32": ("pretrained_path=base", "pretrained_gamemode=1", "data.dataset_type=ors",
                       "optim.grad_acc=2", "profile.do_profile=true", "profile.wait=1",
                       'lora_metadata.ckpt_subfolders=["gamemode=1"]'),
    "train_v32_ft": ("pretrained_path=base", "optim.total_steps=10", "mixed_precision=no"),
    "train_v32-mini_ft": ("pretrained_path=base", "pretrained_gamemode=0", "optim.grad_acc=1"),
    "mai_mod": ("beatmap_path=map.osu", "raw_output=true", "inference.cfg_scale=2",
                "inference.train.data.tgt_seq_len=192", "inference.super_timing=true"),
    "classifier_train_v1": ("model_path=clf", "data.src_seq_len=64", "model.input_features=true",
                            "model.spectrogram.n_mels=32", "data.mappers_path=", "device=cpu"),
    "rcomplexion_train_v1": ("data.src_seq_len=8", "model.hidden_size=16", "optim.batch_size=4"),
    "rcomplexion_inference_v1": ("model_path=osur", "data.train_dataset_end=2", "device=cpu"),
    "calc_fid": ("skip_generation=true", "num_processes=0", "gamemodes=[0]", "classifier_batch_size=4",
                 "inference.model_path=ckpt", "inference.device=cpu", "inference.train.data.src_seq_len=128"),
}


def composed(name, overrides=()):
    directory, config_name, schema_cls = CONFIGS[name]
    return compose(REPO_ROOT / "configs" / directory, config_name, overrides=list(overrides), schema_cls=schema_cls)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_checked_in_json_is_the_jax_composition(name):
    """The port's compose, the schema dataclasses, field for field."""
    directory, config_name, schema_cls = CONFIGS[name]
    got = compose_config(directory, config_name, (), getattr(port_schema, schema_cls.__name__))
    assert plain(got, keep_enums=True) == plain(composed(name), keep_enums=True)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("with_overrides", [False, True])
def test_loaded_namespace_equals_the_jax_config(name, with_overrides):
    """Every field, with ContextType values restored where the JAX config has
    them, overrides applied the way the JAX loader applies them."""
    overrides = OVERRIDES[name] if with_overrides else ()
    assert plain(LOADERS[name](overrides), keep_enums=True) == plain(composed(name, overrides), keep_enums=True)


def test_v32_mini_builds_the_jax_model_config():
    train = load_config("v32-mini").train
    got = dataclasses.asdict(build_config(train, build_vocabulary(train)))
    jax_train = composed("v32-mini").train
    want = dataclasses.asdict(jax_build_config(jax_train, jax_build_vocabulary(jax_train)))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert got == want
    b = got["backbone"]
    assert (b["d_model"], b["encoder_layers"], b["decoder_layers"], b["encoder_heads"], b["encoder_ffn"],
            b["global_attn_every_n_layers"]) == (512, 6, 6, 8, 2048, 1)


@pytest.mark.parametrize("name", ["v31", "v30"])
def test_v31_v30_build_the_jax_model_config(name):
    """RoPEWhisper-small with the difficulty, mapper and song-position
    embedders on an 80-mel torchaudio front end, and the JAX vocabulary."""
    train = load_config(name).train
    vocab = build_vocabulary(train)
    got = dataclasses.asdict(build_config(train, vocab))
    jax_train = composed(name).train
    jax_vocab = jax_build_vocabulary(jax_train)
    assert vocab.state_dict() == jax_vocab.state_dict()
    want = dataclasses.asdict(jax_build_config(jax_train, jax_vocab))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert {k: v for k, v in got.items() if k != "backbone"} == {k: v for k, v in want.items() if k != "backbone"}
    assert {k: want["backbone"][k] for k in got["backbone"]} == got["backbone"]
    b = got["backbone"]
    assert (b["d_model"], b["encoder_layers"], b["decoder_layers"], b["encoder_heads"], b["encoder_ffn"],
            b["num_mel_bins"], b["max_source_positions"]) == (768, 12, 12, 12, 3072, 80 + 384, 2048)
    assert (got["do_difficulty_embed"], got["do_mapper_embed"], got["do_song_position_embed"],
            got["do_style_embed"], got["cond_size"], got["n_mels"], got["pad_mode"]) == (
        True, True, True, False, 384, 80, "reflect")


@pytest.mark.parametrize("name", ["v29", "v28"])
def test_v29_v28_build_the_jax_model_config(name):
    """Stock whisper (small, base): absolute positions and LayerNorm, the
    mels projected to d_model, no embedder, and the JAX vocabulary."""
    train = load_config(name).train
    vocab = build_vocabulary(train)
    got = dataclasses.asdict(build_config(train, vocab))
    jax_train = composed(name).train
    jax_vocab = jax_build_vocabulary(jax_train)
    assert vocab.state_dict() == jax_vocab.state_dict()
    want = dataclasses.asdict(jax_build_config(jax_train, jax_vocab))
    for tree in (got, want):
        for key in ("dtype", "param_dtype"):
            tree["backbone"][key] = str(tree["backbone"][key]).split(".")[-1].replace("'>", "")
    assert got == want
    b = got["backbone"]
    widths = {"v29": (768, 12, 12, 3072), "v28": (512, 6, 8, 2048)}[name]
    assert (b["d_model"], b["encoder_layers"], b["encoder_heads"], b["encoder_ffn"]) == widths
    assert (b["position_scheme"], b["norm"], b["num_mel_bins"], b["max_source_positions"], b["max_target_positions"],
            b["tie_word_embeddings"]) == ("whisper_abs", "layer", widths[0], 512, 2048, False)
    assert (got["project_encoder_input"], got["do_difficulty_embed"], got["n_mels"]) == (True, False, 388)


def test_v32_mini_greedy_tokens_and_osu_equal_jax(tmp_path):
    ckpt = make_tiny_checkpoint(tmp_path / "mini", d_model=64, layers=6, heads=4, ffn=128, seed=2)
    wav = make_wav(tmp_path / "song.wav", seconds=1.0)
    overrides = [f"model_path={ckpt}", f"audio_path={wav}", "train.data.src_seq_len=256",
                 "train.data.tgt_seq_len=128", "do_sample=false", "seed=7", "gamemode=0", "difficulty=4.5",
                 "title=Mini", "artist=pytest", "bpm=120", "offset=0", "device=cpu"]
    results = []
    for module in (jax_inference, inference):
        out = tmp_path / module.__name__
        out.mkdir()
        if module is jax_inference:
            args = compose(REPO_ROOT / "configs" / "inference", "v32-mini", schema_cls=schema.InferenceConfig,
                           overrides=[*overrides, f"output_path={out}"])
        else:
            args = load_config("v32-mini", [*overrides, f"output_path={out}"])
        engine, vocab = module.load_model(args)
        b = engine.model.config.backbone if module is jax_inference else engine.model.cfg.backbone
        assert (b.encoder_layers, b.decoder_layers, b.global_attn_every_n_layers) == (6, 6, 1)
        decoded = []
        inner = engine.generate

        def recording(*a, _inner=inner, _decoded=decoded, **kw):
            tokens, end = _inner(*a, **kw)
            _decoded.append((tokens.tolist(), int(end)))
            return tokens, end

        engine.generate = recording
        module.compile_args(args, vocab, verbose=False)
        generation_config, beatmap_config = module.get_config(args)
        text, path = module.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                     engine=engine, vocab=vocab, verbose=False)
        results.append((decoded, text, path))
    (want_tokens, want, want_path), (got_tokens, got, got_path) = results
    assert len(got_tokens) == len(want_tokens) > 0
    assert got_tokens == want_tokens
    assert got == want and got_path.read_bytes() == want_path.read_bytes()
    assert "Version:Mapperatorinator V32-mini" in got

    # the command line, -cn v32-mini
    (tmp_path / "cli").mkdir()
    text, _ = inference.main(["-cn", "v32-mini", *overrides, f"output_path={tmp_path / 'cli'}"])
    assert text == got

