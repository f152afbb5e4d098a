"""Published (HF-format) checkpoints on the port against the JAX loader.

For each backbone family the port builds (stock whisper under ``-cn v28``,
RoPEWhisper with the v31 conditioning embedders, VarWhisper under v32, and
T5 v1.1 under v32 with ``train.model.name=google/t5-v1_1-base`` and a
projected encoder input) a tiny reference state dict is made from a numpy
seed under the keys the JAX ``models/convert.py`` reads
(``transformer.model.encoder.conv1.weight``, split ``q_proj`` / ``k_proj`` /
``v_proj`` with no ``k_proj.bias``, ``transformer.proj_out.weight``; T5's
``transformer.encoder.block.N.layer.M`` with ``relative_attention_bias`` on
block 0, gated ``DenseReluDense.wi_0`` / ``wi_1`` / ``wo``,
``transformer.shared.weight`` and ``lm_head.weight``; then
``decoder_embedder.weight``, ``encoder_embedder.{weight,bias}``, ...),
beside a ``config.json`` written from the config's own model config. The directory is written with
``safetensors.numpy.save_file`` (the library's writer, which the port's
reader is held to), as ``pytorch_model.bin``, and as two
``pytorch_model-0000N-of-00002.bin`` shards. Each package's
``load_checkpoint`` reads it: the port's state dict must equal
``params_from_flax`` of the JAX params exactly, less the HF decoder token
table, which the port's decoder does not hold. Also: the backbone config
field by field, the unported families raising, bf16 and fp16 files read as
torch's own cast, and malformed files raising.
"""

import dataclasses
import json
import struct

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from safetensors.torch import save_file as save_torch_file

from mapperatorinator_tpu.models.convert import _backbone_config_from_hf as jax_backbone_config_from_hf
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.models.convert import _backbone_config_from_hf, backbone_family, load_hf_checkpoint
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.models.safetensors import read_safetensors, read_torch_weights
from mapperatorinator_tpu_torch.osu import build_vocabulary

torch.set_num_threads(1)

# family -> the port config whose model it is, and the overrides that make it so
FAMILY_CONFIGS = {"whisper": "v28", "ropewhisper": "v31", "varwhisper": "v32", "t5": "v32"}
FAMILY_OVERRIDES = {"t5": ("train.model.name=google/t5-v1_1-base", "train.model.project_encoder_input=true")}
TINY = dict(d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
            encoder_ffn_dim=64, decoder_ffn_dim=64)
SRC_LEN, TGT_LEN = 256, 128


def tiny_args(name: str, overrides=()):
    """``-cn name`` at tiny widths, 128 source and 128 target positions."""
    return load_config(name, [*(f"train.model.overwrite.{k}={v}" for k, v in TINY.items()),
                              f"train.data.src_seq_len={SRC_LEN}", f"train.data.tgt_seq_len={TGT_LEN}", *overrides])


def hf_config(cfg) -> dict:
    """The ``config.json`` of a published checkpoint of the model ``cfg`` (a
    port MapperatorinatorConfig), less ``backbone_model_name``. The stem
    takes ``d_model`` channels where the wrapper projects its input
    (``build_config`` sizes it from the name's size table, which the tiny
    widths override)."""
    b = cfg.backbone
    b = dataclasses.replace(b, num_mel_bins=b.d_model if cfg.project_encoder_input else b.num_mel_bins)
    if b.position_scheme == "t5_relpos":  # HF T5Config's names
        backbone = dict(d_model=b.d_model, num_layers=b.encoder_layers, num_decoder_layers=b.decoder_layers,
                        num_heads=b.decoder_heads, d_ff=b.encoder_ffn, d_kv=b.head_dim,
                        feed_forward_proj="gated-gelu" if b.ffn_gated else "relu",
                        relative_attention_num_buckets=b.relative_attention_num_buckets,
                        relative_attention_max_distance=b.relative_attention_max_distance,
                        layer_norm_epsilon=b.norm_eps, tie_word_embeddings=b.tie_word_embeddings)
    else:
        backbone = dict(
            d_model=b.d_model, encoder_layers=b.encoder_layers, decoder_layers=b.decoder_layers,
            encoder_attention_heads=b.encoder_heads, decoder_attention_heads=b.decoder_heads,
            encoder_ffn_dim=b.encoder_ffn, decoder_ffn_dim=b.decoder_ffn, activation_function="gelu",
            max_source_positions=b.max_source_positions, max_target_positions=b.max_target_positions,
            num_mel_bins=b.num_mel_bins, scale_embedding=False, tie_word_embeddings=b.tie_word_embeddings,
            global_attn_every_n_layers=b.global_attn_every_n_layers, local_attention=b.local_attention,
            global_rope_theta=b.rope_global_theta, local_rope_theta=b.rope_local_theta,
            attention_bias=b.attention_bias, rope_type=b.rope_type,
            rope_encoder_scaling_factor=b.rope_encoder_scaling_factor,
            rope_decoder_scaling_factor=b.rope_decoder_scaling_factor)
    wrapper = {k: getattr(cfg, k) for k in (
        "vocab_size_in", "num_classes", "num_mappers", "input_features", "project_encoder_input",
        "embed_decoder_input", "do_style_embed", "do_difficulty_embed", "do_mapper_embed", "do_song_position_embed",
        "cond_dim", "cond_size", "spectrogram_log_scale", "sample_rate", "n_fft", "n_mels", "hop_length", "f_min",
        "f_max", "pad_mode", "rhythm_token_start", "rhythm_token_end", "max_target_positions")}
    return {"backbone_config": backbone, "vocab_size": cfg.vocab_size_out, **wrapper}


def hf_state_dict(family: str, hf_cfg: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A reference Mapperatorinator state dict of ``family`` (fp32, numpy,
    seeded): the keys the JAX converter reads, at the shapes it expects."""
    rng = np.random.default_rng(seed)
    b = hf_cfg["backbone_config"]
    d, vocab = b["d_model"], hf_cfg["vocab_size"]
    sd = {}

    def mat(key, out, inp, bias=True):
        sd[f"{key}.weight"] = rng.standard_normal((out, inp)) * inp**-0.5
        if bias:
            sd[f"{key}.bias"] = 0.1 * rng.standard_normal(out)

    def norm(key):
        sd[f"{key}.weight"] = 1 + 0.1 * rng.standard_normal(d)
        if family == "whisper":
            sd[f"{key}.bias"] = 0.1 * rng.standard_normal(d)

    def attn(key, cross):
        if family == "varwhisper":
            mat(f"{key}.Wq" if cross else f"{key}.Wqkv", d if cross else 3 * d, d)
            if cross:
                mat(f"{key}.Wkv", 2 * d, d)
            mat(f"{key}.Wo", d, d)
        else:
            for p in "qkv":
                mat(f"{key}.{p}_proj", d, d, bias=p != "k")  # k_proj has no bias
            mat(f"{key}.out_proj", d, d)

    def t5_attn(key):  # q scaled by d_kv^-0.5, as HF initialises it (the attention is unscaled)
        for p in "qkv":
            mat(f"{key}.{p}", b["num_heads"] * b["d_kv"], d, bias=False)
        sd[f"{key}.q.weight"] *= b["d_kv"] ** -0.5
        mat(f"{key}.o", d, b["num_heads"] * b["d_kv"], bias=False)

    if family == "t5":  # T5ForConditionalGeneration under transformer.: the shared table, an untied lm_head
        for side, n in (("encoder", b["num_layers"]), ("decoder", b["num_decoder_layers"])):
            t = f"transformer.{side}"
            sd[f"{t}.final_layer_norm.weight"] = 1 + 0.1 * rng.standard_normal(d)
            sd[f"{t}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = rng.standard_normal(
                (b["relative_attention_num_buckets"], b["num_heads"]))
            for i in range(n):
                p = f"{t}.block.{i}.layer"
                t5_attn(f"{p}.0.SelfAttention")
                if side == "decoder":
                    t5_attn(f"{p}.1.EncDecAttention")
                for sub in range(3 if side == "decoder" else 2):
                    sd[f"{p}.{sub}.layer_norm.weight"] = 1 + 0.1 * rng.standard_normal(d)
                ff = f"{p}.{2 if side == 'decoder' else 1}.DenseReluDense"
                mat(f"{ff}.wi_0", b["d_ff"], d, bias=False)
                mat(f"{ff}.wi_1", b["d_ff"], d, bias=False)
                mat(f"{ff}.wo", d, b["d_ff"], bias=False)
        sd["transformer.shared.weight"] = rng.standard_normal((vocab, d))
        if not b["tie_word_embeddings"]:
            mat("transformer.lm_head", vocab, d, bias=False)
    else:
        whisper_backbone(sd, family, b, vocab, rng, mat, norm, attn)
    sd["decoder_embedder.weight"] = rng.standard_normal((hf_cfg["vocab_size_in"], d))
    if hf_cfg["do_style_embed"]:
        sd["style_embedder.embedding_table.weight"] = rng.standard_normal((hf_cfg["num_classes"] + 1, d))
    if hf_cfg["project_encoder_input"]:  # the mels, then the embedded conditions (a style: d_model wide)
        mat("encoder_embedder", d, hf_cfg["n_mels"] + hf_cfg["cond_size"] + d * hf_cfg["do_style_embed"])
    cond = hf_cfg["cond_dim"]
    for name, flag, proj, basis, width in (("difficulty_embedder", "difficulty", "difficulty_proj", 8, 1),
                                           ("song_pos_embedder", "song_position", "position_proj", 10, 2)):
        if hf_cfg[f"do_{flag}_embed"]:
            sd[f"{name}.basis_centers"] = np.linspace(0, 1, basis) + 0.01 * rng.standard_normal(basis)
            sd[f"{name}.basis_widths"] = 0.1 + 0.05 * np.abs(rng.standard_normal(basis))
            hidden = width * cond
            mat(f"{name}.{proj}.0", hidden, width * basis)
            sd[f"{name}.{proj}.1.weight"], sd[f"{name}.{proj}.1.bias"] = 1 + 0.1 * rng.standard_normal((2, hidden))
            mat(f"{name}.{proj}.4", cond, hidden)
            sd[f"{name}.{proj}.5.weight"], sd[f"{name}.{proj}.5.bias"] = 1 + 0.1 * rng.standard_normal((2, cond))
    if hf_cfg["do_mapper_embed"]:
        sd["mapper_embedder.embedding.weight"] = rng.standard_normal((hf_cfg["num_mappers"] + 1, cond))
        sd["mapper_embedder.layer_norm.weight"] = 1 + 0.1 * rng.standard_normal(cond)
        sd["mapper_embedder.layer_norm.bias"] = 0.1 * rng.standard_normal(cond)
    return {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}


def whisper_backbone(sd: dict, family: str, b: dict, vocab: int, rng, mat, norm, attn) -> None:
    """A whisper family's backbone under ``transformer.model.`` and its
    untied ``proj_out``."""
    d = b["d_model"]
    t = "transformer.model"
    for conv, inp in (("conv1", b["num_mel_bins"]), ("conv2", d)):
        sd[f"{t}.encoder.{conv}.weight"] = rng.standard_normal((d, inp, 3)) * (3 * inp) ** -0.5
        sd[f"{t}.encoder.{conv}.bias"] = 0.1 * rng.standard_normal(d)
    if family == "whisper":  # frozen sinusoids: the converters drop them
        sd[f"{t}.encoder.embed_positions.weight"] = rng.standard_normal((b["max_source_positions"], d))
        sd[f"{t}.decoder.embed_positions.weight"] = rng.standard_normal((b["max_target_positions"], d))
    sd[f"{t}.decoder.embed_tokens.weight"] = rng.standard_normal((vocab, d))
    cross = "cross_attn" if family == "varwhisper" else "encoder_attn"
    for side, n in (("encoder", b["encoder_layers"]), ("decoder", b["decoder_layers"])):
        norm(f"{t}.{side}.layer_norm")
        ffn = b[f"{side}_ffn_dim"]
        for i in range(n):
            p = f"{t}.{side}.layers.{i}"
            attn(f"{p}.self_attn", cross=False)
            norm(f"{p}.self_attn_layer_norm")
            if side == "decoder":
                attn(f"{p}.{cross}", cross=True)
                norm(f"{p}.{cross}_layer_norm")
            norm(f"{p}.final_layer_norm")
            mat(f"{p}.fc1", ffn, d)
            mat(f"{p}.fc2", d, ffn)
    mat("transformer.proj_out", vocab, d, bias=False)


def write_hf_checkpoint(directory, name: str, fmt: str = "safetensors", overrides=(), seed: int = 0):
    """A published checkpoint of ``-cn name``'s model at tiny widths:
    ``config.json``, ``tokenizer.json`` and the weights as ``fmt``
    (``safetensors``, ``bin`` or ``shards``). Returns (directory, its
    config.json, its state dict)."""
    args = tiny_args(name, overrides)
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    hf_cfg = {"backbone_model_name": args.train.model.name, **hf_config(cfg)}
    family = backbone_family(hf_cfg["backbone_model_name"])
    sd = hf_state_dict(family, hf_cfg, seed)
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "config.json").write_text(json.dumps(hf_cfg))
    vocab.save_pretrained(directory)
    if fmt == "safetensors":
        save_file(sd, str(directory / "model.safetensors"), metadata={"format": "pt"})
    elif fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, directory / "pytorch_model.bin")
    else:
        keys = sorted(sd)
        for i, part in enumerate((keys[::2], keys[1::2]), 1):
            torch.save({k: torch.from_numpy(sd[k]) for k in part}, directory / f"pytorch_model-0000{i}-of-00002.bin")
    return directory, hf_cfg, sd


@pytest.mark.parametrize("fmt", ["safetensors", "bin", "shards"])
@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_port_loads_the_jax_params(tmp_path, family, fmt):
    directory, hf_cfg, sd = write_hf_checkpoint(tmp_path / "ckpt", FAMILY_CONFIGS[family], fmt,
                                                FAMILY_OVERRIDES.get(family, ()))
    jmodel, jparams, jvocab = jax_load_checkpoint(directory)
    model, vocab = load_checkpoint(directory)
    assert vocab.state_dict() == jvocab.state_dict()
    want = params_from_flax(jparams)
    got = model.state_dict()
    # the HF decoder token table: the port's decoder (ids embedded by the wrapper, untied head) has none
    assert not model.cfg.backbone.tie_word_embeddings
    assert "transformer.decoder.embed_tokens.weight" not in got
    del want["transformer.decoder.embed_tokens.weight"]
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == torch.float32 and torch.equal(got[name], want[name]), name
    assert "transformer.encoder.embed_positions.weight" not in got  # frozen sinusoids: computed
    cfg = model.cfg
    assert cfg.spectrogram_implementation == "xla"
    assert (cfg.backbone.position_scheme, cfg.backbone.norm) == {
        "whisper": ("whisper_abs", "layer"), "ropewhisper": ("rope", "rms"), "varwhisper": ("rope", "rms"),
        "t5": ("t5_relpos", "rms")}[family]
    if family == "whisper":  # a fused bias's k slot is zero; the decoder's positions are learned
        bias = got["transformer.encoder.layers.0.self_attn.wqkv.bias"]
        assert not bias[32:64].any() and bias[:32].any() and bias[64:].any()
        assert torch.equal(got["transformer.decoder.embed_positions.weight"],
                           torch.from_numpy(sd["transformer.model.decoder.embed_positions.weight"]))
    if family == "ropewhisper":
        assert {"difficulty_embedder.rbf.basis_centers", "mapper_embedder.table.weight",
                "song_pos_embedder.proj2.weight"} <= set(got)
    if family == "t5":  # block 0's shared bias, the gate, the untied head; q / k / v fused in that order
        t = "transformer"
        assert torch.equal(got["transformer.decoder.rel_bias.embedding.weight"], torch.from_numpy(
            sd[f"{t}.decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]))
        assert torch.equal(got["transformer.encoder.layers.1.ffn.fc1_gate.weight"],
                           torch.from_numpy(sd[f"{t}.encoder.block.1.layer.1.DenseReluDense.wi_1.weight"]))
        assert torch.equal(got["transformer.proj_out.weight"], torch.from_numpy(sd[f"{t}.lm_head.weight"]))
        qkv = got["transformer.decoder.layers.0.self_attn.wqkv.weight"]
        assert qkv.shape == (3 * 2 * 64, TINY["d_model"])  # 2 heads of d_kv 64 over d_model 32
        assert torch.equal(qkv[128:256], torch.from_numpy(sd[f"{t}.decoder.block.0.layer.0.SelfAttention.k.weight"]))
        assert not any(name.endswith("bias") and "rel_bias" not in name and "embedder" not in name for name in got)


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_backbone_config_equals_jax_field_by_field(tmp_path, family):
    _, hf_cfg, _ = write_hf_checkpoint(tmp_path / "ckpt", FAMILY_CONFIGS[family], overrides=FAMILY_OVERRIDES.get(
        family, ()))
    for cfg in (hf_cfg, {**hf_cfg, "backbone_config": {}}, {"backbone_model_name": hf_cfg["backbone_model_name"],
                                                            "vocab_size": 100}):
        jax_family, want = jax_backbone_config_from_hf(cfg)
        got_family, got = _backbone_config_from_hf(cfg)
        assert got_family == jax_family == family
        want = dataclasses.asdict(want)
        got = dataclasses.asdict(got)
        for tree in (got, want):
            for key in ("dtype", "param_dtype"):
                tree[key] = str(tree[key]).split(".")[-1].replace("'>", "")
        assert got == want


@pytest.mark.parametrize("name", ["OliBomby/nwhisper-base", "UsefulSensors/moonshine-tiny",
                                  "UsefulSensors/moonshine-base"])
def test_unported_families_raise(tmp_path, name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 11"):
        _backbone_config_from_hf({"backbone_model_name": name, "vocab_size": 100})
    (tmp_path / "config.json").write_text(json.dumps({"backbone_model_name": name, "vocab_size": 100}))
    with pytest.raises(NotImplementedError, match="item 11"):
        load_checkpoint(tmp_path)


def test_half_precision_files_read_as_torch_casts(tmp_path):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((7, 5), generator=gen) * 3
    tensors = {"bf16": x.to(torch.bfloat16), "f16": x.to(torch.float16), "f32": x, "i64": torch.arange(6),
               "i8": torch.arange(-3, 3, dtype=torch.int8), "flag": torch.tensor([True, False]),
               "scalar": torch.tensor(2.5), "empty": torch.zeros((0, 4))}
    save_torch_file(tensors, str(tmp_path / "t.safetensors"))
    got = read_safetensors(tmp_path / "t.safetensors")
    assert set(got) == set(tensors)
    for name, want in tensors.items():
        assert got[name].dtype == want.dtype and got[name].shape == want.shape and torch.equal(got[name], want), name

    # a bf16 checkpoint loads into the fp32 model as the cast of its values
    directory, hf_cfg, sd = write_hf_checkpoint(tmp_path / "bf16", "v28", "bin")
    (directory / "pytorch_model.bin").unlink()
    save_torch_file({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                    str(directory / "model.safetensors"))
    model = load_hf_checkpoint(directory)
    w = model.state_dict()["transformer.proj_out.weight"]
    assert w.dtype == torch.float32
    assert torch.equal(w, torch.from_numpy(sd["transformer.proj_out.weight"]).to(torch.bfloat16).float())


def test_malformed_files_raise(tmp_path):
    path = tmp_path / "t.safetensors"
    save_file({"a": np.ones((4, 4), np.float32), "b": np.zeros(3, np.float32)}, str(path))
    data = path.read_bytes()
    (tmp_path / "short.safetensors").write_bytes(data[:-4])
    with pytest.raises(ValueError, match="covers"):
        read_safetensors(tmp_path / "short.safetensors")
    (tmp_path / "stub.safetensors").write_bytes(data[:20])
    with pytest.raises(ValueError, match="overruns"):
        read_safetensors(tmp_path / "stub.safetensors")

    def with_header(header: dict, payload: bytes) -> bytes:
        text = json.dumps(header).encode()
        return struct.pack("<Q", len(text)) + text + payload

    overlap = {"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]},
               "b": {"dtype": "F32", "shape": [4], "data_offsets": [8, 24]}}
    (tmp_path / "overlap.safetensors").write_bytes(with_header(overlap, bytes(24)))
    with pytest.raises(ValueError, match="overlap"):
        read_safetensors(tmp_path / "overlap.safetensors")
    gap = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
           "b": {"dtype": "F32", "shape": [2], "data_offsets": [12, 20]}}
    (tmp_path / "gap.safetensors").write_bytes(with_header(gap, bytes(20)))
    with pytest.raises(ValueError, match="gap"):
        read_safetensors(tmp_path / "gap.safetensors")
    wrong = {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 16]}}
    (tmp_path / "wrong.safetensors").write_bytes(with_header(wrong, bytes(16)))
    with pytest.raises(ValueError, match="needs 12"):
        read_safetensors(tmp_path / "wrong.safetensors")
    with pytest.raises(FileNotFoundError):
        read_torch_weights(tmp_path / "nothing")


def test_load_checkpoint_dispatches_on_the_directory(tmp_path):
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    (legacy / "custom_checkpoint_0.pkl").write_bytes(b"")
    (legacy / "pytorch_model.bin").write_bytes(b"")
    with pytest.raises(ValueError, match=r"models\.legacy\.load_legacy_checkpoint\(dir, train_args\)"):
        load_checkpoint(legacy)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no recognizable checkpoint"):
        load_checkpoint(tmp_path / "empty")
    # without tokenizer.json the vocabulary is the caller's to build
    directory, _, _ = write_hf_checkpoint(tmp_path / "hf", "v28")
    (directory / "tokenizer.json").unlink()
    model, vocab = load_checkpoint(directory)
    assert vocab is None and model.cfg.backbone.position_scheme == "whisper_abs"
