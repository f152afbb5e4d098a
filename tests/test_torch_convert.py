"""Published (HF-format) checkpoints on the port against the JAX loader.

For each backbone family the port builds (stock whisper under ``-cn v28``,
RoPEWhisper with the v31 conditioning embedders, VarWhisper under v32,
T5 v1.1 under v32 with ``train.model.name=google/t5-v1_1-base`` and a
projected encoder input, and NWhisper and moonshine under v32 with their
model presets' settings, ``FAMILY_OVERRIDES``) a tiny reference state dict is made from a numpy
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
field by field, the published widths of nwhisper-base, moonshine-tiny and
moonshine-base, bf16 and fp16 files read as torch's own cast, and malformed
files raising. NWhisper's state dict is the nGPT layout (``NormLinear``
weights at ``.linear.weight`` or ``.linear.parametrizations.weight.original``,
the residual slerps' ``branch_scale``, ``qk_scale``, ``alpha_positions``,
``logit_scale``, the encoder's learned ``embed_positions``); moonshine's the
HF ``MoonshineForConditionalGeneration`` one (the raw-wave stem, bias-free
``input_layernorm`` / ``post_attention_layernorm`` / ``final_layernorm``,
``mlp.fc1`` / ``fc2``).
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
from mapperatorinator_tpu_torch.models.mapperatorinator import Mapperatorinator, build_config
from mapperatorinator_tpu_torch.models.params import params_from_flax
from mapperatorinator_tpu_torch.models.safetensors import read_safetensors, read_torch_weights
from mapperatorinator_tpu_torch.osu import build_vocabulary

torch.set_num_threads(1)

# family -> the port config whose model it is, and the overrides that make it so
FAMILY_CONFIGS = {"whisper": "v28", "ropewhisper": "v31", "varwhisper": "v32", "t5": "v32", "nwhisper": "v32",
                  "moonshine": "v32"}
# nwhisper and moonshine as configs/model/nwhisper_base.yaml and moonshine_tiny.yaml set them
FAMILY_OVERRIDES = {
    "t5": ("train.model.name=google/t5-v1_1-base", "train.model.project_encoder_input=true"),
    "nwhisper": ("train.model.name=OliBomby/nwhisper-base", "train.model.embed_decoder_input=false",
                 "train.model.project_encoder_input=true"),
    "moonshine": ("train.model.name=UsefulSensors/moonshine-tiny", "train.model.input_raw_wave=true",
                  "train.model.project_encoder_input=false"),
}
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
    extra = {}
    if b.stem_type == "moonshine":  # HF MoonshineConfig's names
        backbone = dict(hidden_size=b.d_model, encoder_num_hidden_layers=b.encoder_layers,
                        decoder_num_hidden_layers=b.decoder_layers, encoder_num_attention_heads=b.encoder_heads,
                        decoder_num_attention_heads=b.decoder_heads, intermediate_size=b.encoder_ffn,
                        max_position_embeddings=b.max_target_positions, rope_theta=b.rope_global_theta,
                        partial_rotary_factor=b.rope_partial_factor, attention_bias=False, decoder_hidden_act="silu",
                        tie_word_embeddings=b.tie_word_embeddings)
        extra = {"max_source_positions": b.max_source_positions}
    elif b.position_scheme == "t5_relpos":  # HF T5Config's names
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
        if b.norm_scheme == "ngpt":
            backbone["input_vocab_size"] = b.input_vocab_size
    wrapper = {k: getattr(cfg, k) for k in (
        "vocab_size_in", "num_classes", "num_mappers", "input_features", "input_raw_wave", "project_encoder_input",
        "embed_decoder_input", "do_style_embed", "do_difficulty_embed", "do_mapper_embed", "do_song_position_embed",
        "cond_dim", "cond_size", "spectrogram_log_scale", "sample_rate", "n_fft", "n_mels", "hop_length", "f_min",
        "f_max", "pad_mode", "rhythm_token_start", "rhythm_token_end", "max_target_positions")}
    return {"backbone_config": backbone, "vocab_size": cfg.vocab_size_out, **extra, **wrapper}


def hf_state_dict(family: str, hf_cfg: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A reference Mapperatorinator state dict of ``family`` (fp32, numpy,
    seeded): the keys the JAX converter reads, at the shapes it expects."""
    rng = np.random.default_rng(seed)
    b = hf_cfg["backbone_config"]
    d, vocab = b.get("d_model", b.get("hidden_size")), hf_cfg["vocab_size"]
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
    elif family == "nwhisper":
        ngpt_backbone(sd, b, vocab, rng, mat)
    elif family == "moonshine":
        moonshine_backbone(sd, b, vocab, rng, mat)
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


def ngpt_backbone(sd: dict, b: dict, vocab: int, rng, mat) -> None:
    """An NWhisper backbone under ``transformer.model.``, its ``proj_out`` and
    ``logit_scale``: every projection a NormLinear, its weight at
    ``.linear.weight`` or, in layer 1 and for the decoder's token table, at
    ``.linear.parametrizations.weight.original``, the scales drawn near their
    inits (qk 1/d, the slerps' and the positions' d^-1/2)."""
    d = b["d_model"]
    t = "transformer.model"

    def scale(key, n, at):
        sd[f"{key}.scale"] = at * (1 + 0.2 * rng.standard_normal(n))

    def norm_linear(key, out, inp, bias, layer):
        where = "linear.parametrizations.weight.original" if layer == 1 else "linear.weight"
        sd[f"{key}.{where}"] = rng.standard_normal((out, inp)) * inp**-0.5
        if bias:
            sd[f"{key}.linear.bias"] = 0.1 * rng.standard_normal(out)

    def attn(key, layer):
        for p in ("q", "k", "v", "out"):
            norm_linear(f"{key}.fn.{p}_proj", d, d, p != "k", layer)  # k has no bias
        scale(f"{key}.fn.qk_scale", d, 1 / d)
        scale(f"{key}.branch_scale", d, d**-0.5)

    for conv in ("conv1", "conv2"):
        inp = b["num_mel_bins"] if conv == "conv1" else d
        sd[f"{t}.encoder.{conv}.weight"] = rng.standard_normal((d, inp, 3)) * (3 * inp) ** -0.5
        sd[f"{t}.encoder.{conv}.bias"] = 0.1 * rng.standard_normal(d)
    sd[f"{t}.encoder.embed_positions.weight"] = rng.standard_normal((b["max_source_positions"], d))
    sd[f"{t}.decoder.embed_positions.weight"] = rng.standard_normal((b["max_target_positions"], d))
    sd[f"{t}.decoder.embed_tokens.embedding.parametrizations.weight.original"] = rng.standard_normal(
        (b["input_vocab_size"], d))
    for side in ("encoder", "decoder"):
        scale(f"{t}.{side}.alpha_positions", d, d**-0.5)
        ffn = b[f"{side}_ffn_dim"]
        for i in range(b[f"{side}_layers"]):
            p = f"{t}.{side}.layers.{i}"
            for residual in ("self_attn_with_residual", "encoder_attn_with_residual") if side == "decoder" \
                    else ("attn_with_residual",):
                attn(f"{p}.{residual}", i)
            norm_linear(f"{p}.ff_with_residual.fn.fc1", ffn, d, False, i)
            norm_linear(f"{p}.ff_with_residual.fn.fc2", d, ffn, False, i)
            scale(f"{p}.ff_with_residual.branch_scale", d, d**-0.5)
    norm_linear("transformer.proj_out", vocab, d, False, 0)
    scale("transformer.logit_scale", vocab, 3 * d**-0.5)


def moonshine_backbone(sd: dict, b: dict, vocab: int, rng, mat) -> None:
    """A moonshine backbone under ``transformer.model.``: the raw-wave stem,
    bias-free attention and LayerNorms, ``mlp.fc1`` / ``fc2`` (the decoder's
    fc1 twice the width), the decoder's token table (the head where tied)
    and an untied ``proj_out`` where not."""
    d, ffn = b["hidden_size"], b["intermediate_size"]
    t = "transformer.model"

    def ln(key):
        sd[f"{key}.weight"] = 1 + 0.1 * rng.standard_normal(d)

    sd[f"{t}.encoder.conv1.weight"] = rng.standard_normal((d, 1, 127)) * 127**-0.5
    sd[f"{t}.encoder.groupnorm.weight"], sd[f"{t}.encoder.groupnorm.bias"] = 1 + 0.1 * rng.standard_normal((2, d))
    for conv, out, inp, k in (("conv2", 2 * d, d, 7), ("conv3", d, 2 * d, 3)):
        sd[f"{t}.encoder.{conv}.weight"] = rng.standard_normal((out, inp, k)) * (k * inp) ** -0.5
        sd[f"{t}.encoder.{conv}.bias"] = 0.1 * rng.standard_normal(out)
    ln(f"{t}.encoder.layer_norm")
    ln(f"{t}.decoder.norm")
    sd[f"{t}.decoder.embed_tokens.weight"] = rng.standard_normal((vocab, d))
    for side in ("encoder", "decoder"):
        for i in range(b[f"{side}_num_hidden_layers"]):
            p = f"{t}.{side}.layers.{i}"
            for attn in ("self_attn", "encoder_attn") if side == "decoder" else ("self_attn",):
                for proj in "qkvo":
                    mat(f"{p}.{attn}.{proj}_proj", d, d, bias=False)
            for name in ("input_layernorm", "post_attention_layernorm") + (("final_layernorm",) if side == "decoder"
                                                                           else ()):
                ln(f"{p}.{name}")
            mat(f"{p}.mlp.fc1", 2 * ffn if side == "decoder" else ffn, d)
            mat(f"{p}.mlp.fc2", d, ffn)
    if not b["tie_word_embeddings"]:
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
    assert not model.cfg.backbone.tie_word_embeddings
    if family == "nwhisper":  # the backbone embeds the decoder ids itself, from the HF token table
        assert not model.cfg.embed_decoder_input and "transformer.decoder.embed_tokens.weight" in got
    else:  # the HF decoder token table: the port's decoder (ids embedded by the wrapper, untied head) has none
        assert "transformer.decoder.embed_tokens.weight" not in got
        del want["transformer.decoder.embed_tokens.weight"]
    assert set(got) == set(want)
    for name in got:
        assert got[name].dtype == torch.float32 and torch.equal(got[name], want[name]), name
    assert "transformer.encoder.embed_positions.weight" not in got  # frozen sinusoids: computed
    cfg = model.cfg
    assert cfg.spectrogram_implementation == "xla"
    assert (cfg.backbone.position_scheme, cfg.backbone.norm, cfg.backbone.norm_scheme) == {
        "whisper": ("whisper_abs", "layer", "prenorm"), "ropewhisper": ("rope", "rms", "prenorm"),
        "varwhisper": ("rope", "rms", "prenorm"), "t5": ("t5_relpos", "rms", "prenorm"),
        "nwhisper": ("whisper_abs", "layer", "ngpt"), "moonshine": ("rope", "layer", "prenorm")}[family]
    if family in ("nwhisper", "moonshine"):
        check_family_params(family, got, sd)
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


def check_family_params(family: str, got: dict, sd: dict) -> None:
    """Where the nGPT and moonshine leaves land: the learned encoder position
    rows, both NormLinear storage keys, k without a bias, the scales;
    moonshine's stem, its gated fc1 of twice the width, no attention bias."""
    t = "transformer.model"
    if family == "nwhisper":
        assert torch.equal(got["transformer.encoder.embed_positions"],
                           torch.from_numpy(sd[f"{t}.encoder.embed_positions.weight"]))
        assert torch.equal(got["transformer.decoder.layers.1.cross_attn.wk.weight"], torch.from_numpy(
            sd[f"{t}.decoder.layers.1.encoder_attn_with_residual.fn.k_proj.linear.parametrizations.weight.original"]))
        assert torch.equal(got["transformer.decoder.embed_tokens.weight"], torch.from_numpy(
            sd[f"{t}.decoder.embed_tokens.embedding.parametrizations.weight.original"]))
        assert torch.equal(got["transformer.encoder.layers.0.attn_residual.branch_scale.weight"],
                           torch.from_numpy(sd[f"{t}.encoder.layers.0.attn_with_residual.branch_scale.scale"]))
        assert torch.equal(got["transformer.logit_scale.weight"], torch.from_numpy(sd["transformer.logit_scale.scale"]))
        assert "transformer.encoder.layers.0.self_attn.wk.bias" not in got
        assert not any("norm" in n for n in got if n.startswith("transformer."))
    else:
        assert got["transformer.encoder.conv1.weight"].shape == (TINY["d_model"], 1, 127)
        assert "transformer.encoder.conv1.bias" not in got and "transformer.encoder.groupnorm.bias" in got
        assert got["transformer.decoder.layers.0.ffn.fc1.weight"].shape == (2 * TINY["decoder_ffn_dim"],
                                                                            TINY["d_model"])
        assert not any(n.endswith("bias") for n in got if "attn" in n or n.endswith(("_norm.bias", ".norm.bias")))


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
    """The three published backbones that raised until the port built the
    nGPT and moonshine families: ``build_config`` gives each its published
    widths (nwhisper-base: d_model 512, 8 heads of 64; moonshine-tiny: 288,
    8 heads of 36; moonshine-base: 416, 8 of 52) as the JAX package does, the
    model builds, and a tiny published checkpoint under the name (moonshine-base
    with a tied head) loads to the JAX loader's parameters, exactly."""
    family = backbone_family(name)
    args = load_config("v32", [*FAMILY_OVERRIDES[family], f"train.model.name={name}"])
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    b = cfg.backbone
    assert (b.d_model, b.encoder_layers, b.decoder_heads, b.head_dim, b.encoder_ffn) == {
        "OliBomby/nwhisper-base": (512, 6, 8, 64, 2048), "UsefulSensors/moonshine-tiny": (288, 6, 8, 36, 1152),
        "UsefulSensors/moonshine-base": (416, 8, 8, 52, 1664)}[name]
    with torch.device("meta"):
        model = Mapperatorinator(cfg)
    assert sum(p.numel() for p in model.parameters()) > 10**6
    tied = ("train.model.overwrite.tie_word_embeddings=true",) if name.endswith("moonshine-base") else ()
    directory, hf_cfg, sd = write_hf_checkpoint(tmp_path / "ckpt", "v32", "safetensors",
                                                (*FAMILY_OVERRIDES[family], f"train.model.name={name}", *tied))
    assert hf_cfg["backbone_model_name"] == name
    jmodel, jparams, _ = jax_load_checkpoint(directory)
    model, _ = load_checkpoint(directory)
    want, got = params_from_flax(jparams), model.state_dict()
    if not model.cfg.embed_decoder_input or model.cfg.backbone.tie_word_embeddings:
        assert "transformer.decoder.embed_tokens.weight" in got  # the backbone's own table, or the tied head
    else:
        del want["transformer.decoder.embed_tokens.weight"]
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    assert ("transformer.proj_out.weight" in got) == (family == "nwhisper" or not tied)
    check_family_params(family, got, sd)


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
