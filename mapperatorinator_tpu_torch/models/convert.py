"""Published (HF-format) checkpoints: the JAX ``models/convert.py`` for the
backbone families the port builds.

A published checkpoint directory holds ``config.json`` (the HF
``MapperatorinatorConfig``: ``backbone_model_name``, ``backbone_config`` and
the wrapper's fields) and the torch state dict of the reference model, as
``model.safetensors`` or ``pytorch_model*.bin`` (:mod:`.safetensors`). The
state dict maps onto the port's own module names by rule, with no flax tree
between:

* VarWhisper (v32): fused ``Wqkv`` / ``Wkv``, RMSNorm;
* stock whisper (v28, v29): split ``q_proj`` / ``k_proj`` / ``v_proj``,
  LayerNorm, the learned decoder position table;
* RoPEWhisper (v30, v31): split projections, RMSNorm, RoPE;
* T5 (``T5ForConditionalGeneration``, the legacy osuT5 backbone): ``block.N.
  layer.M`` sub-layers, split ``q`` / ``k`` / ``v`` / ``o`` with no biases,
  ``DenseReluDense.wi_0`` / ``wi_1`` / ``wo`` (the gate ``wi_1`` is the
  port's ``fc1_gate``; a v1.0 ``wi`` is ``fc1``), RMSNorm, and one
  ``relative_attention_bias`` a stack, read from block 0.
* NWhisper (``NWhisperForConditionalGeneration``, nGPT): each projection a
  ``NormLinear`` whose weight is stored at ``.linear.weight`` or, under a
  torch parametrization, ``.linear.parametrizations.weight.original`` (the
  raw weight: the port normalises it on each forward, as the reference
  does), split ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj`` kept
  split, the residual slerps' ``*_with_residual.branch_scale.scale``,
  ``qk_scale``, ``alpha_positions``, ``logit_scale`` and the encoder's
  learned ``embed_positions``;
* moonshine (HF ``MoonshineForConditionalGeneration``): the raw-wave stem
  (``conv1`` without bias, ``groupnorm``, ``conv2``, ``conv3``), split
  ``q_proj`` / ``k_proj`` / ``v_proj`` / ``o_proj`` with no biases, fused,
  bias-free LayerNorms (``input_layernorm``, ``post_attention_layernorm``,
  ``final_layernorm``) and ``mlp.fc1`` / ``fc2``.

An ``nn.Linear`` weight is (out, in) in both, so the split projections are
concatenated along the output rows into the port's fused ``wqkv`` (q, k, v)
and ``wkv`` (k, v); ``k_proj`` has no bias, so its slot of the fused bias is
0, which computes the same. The whisper encoder's frozen sinusoid table is
dropped (the port computes it), and so is the HF decoder's token table where
the port's decoder has none (a wrapper that embeds its own ids with an untied
head).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

import torch

from .mapperatorinator import Mapperatorinator, MapperatorinatorConfig
from .safetensors import read_torch_weights
from .transformer import TransformerConfig

def backbone_family(backbone_model_name: str) -> str:
    """The reference's ``backbone_model_name`` -> converter family key."""
    name = backbone_model_name.lower()
    if "varwhisper" in name:
        return "varwhisper"
    if "ropewhisper" in name:
        return "ropewhisper"
    if "nwhisper" in name:
        return "nwhisper"
    if "moonshine" in name:
        return "moonshine"
    if name.startswith("google/t5") or "t5" in name:
        return "t5"
    if "whisper" in name:
        return "whisper"
    raise NotImplementedError(f"unknown backbone family: {backbone_model_name}")


def _backbone_config_from_hf(hf_cfg: dict) -> tuple[str, TransformerConfig]:
    """A checkpoint's ``config.json`` -> (family, TransformerConfig), with
    every default of the JAX ``_backbone_config_from_hf``."""
    name = hf_cfg.get("backbone_model_name", "OliBomby/varwhisper-small")
    family = backbone_family(name)
    bc = dict(hf_cfg.get("backbone_config", {}) or {})
    if family == "t5":
        return family, TransformerConfig(
            vocab_size=hf_cfg.get("vocab_size", bc.get("vocab_size")),
            d_model=bc.get("d_model", 512),
            encoder_layers=bc.get("num_layers", 8),
            decoder_layers=bc.get("num_decoder_layers", bc.get("num_layers", 8)),
            encoder_heads=bc.get("num_heads", 6),
            decoder_heads=bc.get("num_heads", 6),
            encoder_ffn=bc.get("d_ff", 1024),
            decoder_ffn=bc.get("d_ff", 1024),
            head_dim_override=bc.get("d_kv", 64),
            activation="gelu_tanh" if "gelu" in bc.get("feed_forward_proj", "gated-gelu") else "relu",
            ffn_gated="gated" in bc.get("feed_forward_proj", "gated-gelu"),
            max_source_positions=hf_cfg.get("max_source_positions", 1024),
            max_target_positions=hf_cfg.get("max_target_positions", 2048),
            num_mel_bins=hf_cfg.get("n_mels", 388),
            position_scheme="t5_relpos",
            relative_attention_num_buckets=bc.get("relative_attention_num_buckets", 32),
            relative_attention_max_distance=bc.get("relative_attention_max_distance", 128),
            norm="rms",
            norm_eps=bc.get("layer_norm_epsilon", 1e-6),
            attention_bias=False,
            attention_scale=False,
            mlp_bias=False,
            conv_stem=False,
            tie_word_embeddings=bc.get("tie_word_embeddings", False),
        )
    if family == "moonshine":  # HF MoonshineConfig's names
        return family, TransformerConfig(
            vocab_size=hf_cfg.get("vocab_size", bc.get("vocab_size")),
            d_model=bc.get("hidden_size", 288),
            encoder_layers=bc.get("encoder_num_hidden_layers", 6),
            decoder_layers=bc.get("decoder_num_hidden_layers", 6),
            encoder_heads=bc.get("encoder_num_attention_heads", 8),
            decoder_heads=bc.get("decoder_num_attention_heads", 8),
            encoder_ffn=bc.get("intermediate_size", 1152),
            decoder_ffn=bc.get("intermediate_size", 1152),
            max_source_positions=hf_cfg.get("max_source_positions", 1024),
            max_target_positions=bc.get("max_position_embeddings", 2048),
            num_mel_bins=1,
            position_scheme="rope",
            rope_global_theta=bc.get("rope_theta", 10000.0),
            rope_local_theta=bc.get("rope_theta", 10000.0),
            rope_partial_factor=bc.get("partial_rotary_factor", 0.9),
            norm="layer",
            norm_bias=False,
            attention_bias=bc.get("attention_bias", False),
            decoder_activation=bc.get("decoder_hidden_act", "silu"),
            decoder_ffn_gated_concat=True,
            conv_stem=True,
            stem_type="moonshine",
            tie_word_embeddings=bc.get("tie_word_embeddings", True),
        )
    common = dict(
        vocab_size=hf_cfg.get("vocab_size", bc.get("vocab_size")),
        d_model=bc.get("d_model", 768),
        encoder_layers=bc.get("encoder_layers", 12),
        decoder_layers=bc.get("decoder_layers", 12),
        encoder_heads=bc.get("encoder_attention_heads", 12),
        decoder_heads=bc.get("decoder_attention_heads", 12),
        encoder_ffn=bc.get("encoder_ffn_dim", 3072),
        decoder_ffn=bc.get("decoder_ffn_dim", 3072),
        activation=bc.get("activation_function", "gelu"),
        max_source_positions=bc.get("max_source_positions", 1024),
        max_target_positions=bc.get("max_target_positions", 2560),
        num_mel_bins=bc.get("num_mel_bins", 128),
        scale_embedding=bc.get("scale_embedding", False),
        tie_word_embeddings=bc.get("tie_word_embeddings", True),
    )
    if family == "varwhisper":
        cfg = TransformerConfig(
            position_scheme="rope", norm="rms",
            rope_global_theta=bc.get("global_rope_theta", 10000),
            rope_local_theta=bc.get("local_rope_theta", 10000),
            global_attn_every_n_layers=bc.get("global_attn_every_n_layers", 1),
            local_attention=bc.get("local_attention", 128),
            attention_bias=bc.get("attention_bias", True),
            **common,
        )
    elif family == "ropewhisper":
        cfg = TransformerConfig(
            position_scheme="rope", norm="rms",
            rope_type=bc.get("rope_type", "default"),
            rope_encoder_scaling_factor=bc.get("rope_encoder_scaling_factor", 1.0),
            rope_decoder_scaling_factor=bc.get("rope_decoder_scaling_factor", 1.0),
            **common,
        )
    elif family == "nwhisper":
        cfg = TransformerConfig(position_scheme="whisper_abs", norm="layer", norm_scheme="ngpt",
                                input_vocab_size=bc.get("input_vocab_size"), **common)
    else:  # stock whisper
        cfg = TransformerConfig(position_scheme="whisper_abs", norm="layer", **common)
    return family, cfg


def config_from_hf(hf_cfg: dict) -> tuple[str, MapperatorinatorConfig]:
    """A checkpoint's ``config.json`` -> (family, MapperatorinatorConfig), as
    the JAX ``load_hf_checkpoint`` builds it: every wrapper field from the
    file or its default there, and the FFT mel (``"xla"``) whatever the file
    says."""
    family, backbone = _backbone_config_from_hf(hf_cfg)
    return family, MapperatorinatorConfig(
        backbone=backbone,
        vocab_size_in=hf_cfg.get("vocab_size_in"),
        vocab_size_out=hf_cfg.get("vocab_size", backbone.vocab_size),
        num_classes=hf_cfg.get("num_classes", 0),
        num_mappers=hf_cfg.get("num_mappers", 3731),
        input_features=hf_cfg.get("input_features", True),
        input_raw_wave=hf_cfg.get("input_raw_wave", False),
        project_encoder_input=hf_cfg.get("project_encoder_input", False),
        embed_decoder_input=hf_cfg.get("embed_decoder_input", True),
        do_style_embed=hf_cfg.get("do_style_embed", False),
        do_difficulty_embed=hf_cfg.get("do_difficulty_embed", False),
        do_mapper_embed=hf_cfg.get("do_mapper_embed", False),
        do_song_position_embed=hf_cfg.get("do_song_position_embed", False),
        cond_dim=hf_cfg.get("cond_dim", 128),
        cond_size=hf_cfg.get("cond_size", 0),
        spectrogram_implementation="xla",
        spectrogram_log_scale=hf_cfg.get("spectrogram_log_scale", False),
        sample_rate=hf_cfg.get("sample_rate", 16000),
        n_fft=hf_cfg.get("n_fft", 1024),
        n_mels=hf_cfg.get("n_mels", 388),
        hop_length=hf_cfg.get("hop_length", 128),
        f_min=hf_cfg.get("f_min", 0),
        f_max=hf_cfg.get("f_max", 8000),
        pad_mode=hf_cfg.get("pad_mode", "constant"),
        rhythm_token_start=hf_cfg.get("rhythm_token_start", 17),
        rhythm_token_end=hf_cfg.get("rhythm_token_end", 836),
        max_target_positions=hf_cfg.get("max_target_positions", backbone.max_target_positions),
    )


# ---------------------------------------------------------------------------
# the backbone: HF names -> the port's, relative to ``transformer.``
# ---------------------------------------------------------------------------


def _linear(out: dict, sd: dict, theirs: str, ours: str) -> None:
    out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
    if f"{theirs}.bias" in sd:
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]


def _norm(out: dict, sd: dict, theirs: str, ours: str, kind: str) -> None:
    out[f"{ours}.weight"] = sd[f"{theirs}.weight"]
    if kind == "layer":
        out[f"{ours}.bias"] = sd[f"{theirs}.bias"]


def _fused_attn(out: dict, sd: dict, theirs: str, ours: str, cross: bool) -> None:
    """VarWhisper's ``Wqkv`` / ``Wq`` + ``Wkv`` / ``Wo``."""
    _linear(out, sd, f"{theirs}.Wo", f"{ours}.wo")
    if cross:
        _linear(out, sd, f"{theirs}.Wq", f"{ours}.wq")
        _linear(out, sd, f"{theirs}.Wkv", f"{ours}.wkv")
    else:
        _linear(out, sd, f"{theirs}.Wqkv", f"{ours}.wqkv")


def _split_attn(out: dict, sd: dict, theirs: str, ours: str, cross: bool) -> None:
    """Whisper's ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj`` -> the
    fused layout; the k bias slot is 0."""
    q, k, v = (sd[f"{theirs}.{p}_proj.weight"] for p in "qkv")
    _linear(out, sd, f"{theirs}.out_proj", f"{ours}.wo")
    has_bias = f"{theirs}.q_proj.bias" in sd
    if has_bias:
        qb, vb = sd[f"{theirs}.q_proj.bias"], sd[f"{theirs}.v_proj.bias"]
    if cross:
        out[f"{ours}.wq.weight"] = q
        out[f"{ours}.wkv.weight"] = torch.cat([k, v])
        if has_bias:
            out[f"{ours}.wq.bias"] = qb
            out[f"{ours}.wkv.bias"] = torch.cat([torch.zeros_like(vb), vb])
    else:
        out[f"{ours}.wqkv.weight"] = torch.cat([q, k, v])
        if has_bias:
            out[f"{ours}.wqkv.bias"] = torch.cat([qb, torch.zeros_like(qb), vb])


def _ffn(out: dict, sd: dict, theirs: str, ours: str) -> None:
    _linear(out, sd, f"{theirs}.fc1", f"{ours}.fc1")
    _linear(out, sd, f"{theirs}.fc2", f"{ours}.fc2")


def _convert_backbone(sd: dict, encoder_layers: int, decoder_layers: int, tied_head: bool, *, fused: bool,
                      norm: str, learned_decoder_positions: bool) -> dict[str, torch.Tensor]:
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    attn = _fused_attn if fused else _split_attn
    cross_name = "cross_attn" if fused else "encoder_attn"
    out: dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        _linear(out, sd, f"encoder.{conv}", f"encoder.{conv}")
    _norm(out, sd, "encoder.layer_norm", "encoder.norm", norm)
    for i in range(encoder_layers):
        p = f"encoder.layers.{i}"
        attn(out, sd, f"{p}.self_attn", f"{p}.self_attn", cross=False)
        _norm(out, sd, f"{p}.self_attn_layer_norm", f"{p}.self_attn_norm", norm)
        _norm(out, sd, f"{p}.final_layer_norm", f"{p}.final_norm", norm)
        _ffn(out, sd, p, f"{p}.ffn")
    out["decoder.embed_tokens.weight"] = sd["decoder.embed_tokens.weight"]
    _norm(out, sd, "decoder.layer_norm", "decoder.norm", norm)
    if learned_decoder_positions and "decoder.embed_positions.weight" in sd:
        out["decoder.embed_positions.weight"] = sd["decoder.embed_positions.weight"]
    for i in range(decoder_layers):
        p = f"decoder.layers.{i}"
        attn(out, sd, f"{p}.self_attn", f"{p}.self_attn", cross=False)
        _norm(out, sd, f"{p}.self_attn_layer_norm", f"{p}.self_attn_norm", norm)
        attn(out, sd, f"{p}.{cross_name}", f"{p}.cross_attn", cross=True)
        _norm(out, sd, f"{p}.{cross_name}_layer_norm", f"{p}.cross_attn_norm", norm)
        _norm(out, sd, f"{p}.final_layer_norm", f"{p}.final_norm", norm)
        _ffn(out, sd, p, f"{p}.ffn")
    if not tied_head and "proj_out.weight" in sd:
        out["proj_out.weight"] = sd["proj_out.weight"]
    return out


def convert_varwhisper_state_dict(sd: dict, encoder_layers: int, decoder_layers: int,
                                  tied_head: bool) -> dict[str, torch.Tensor]:
    """A VarWhisperForConditionalGeneration state dict -> the port's
    ``OsuTransformer`` state dict."""
    return _convert_backbone(sd, encoder_layers, decoder_layers, tied_head, fused=True, norm="rms",
                             learned_decoder_positions=False)


def convert_whisper_state_dict(sd: dict, encoder_layers: int, decoder_layers: int, tied_head: bool,
                               norm: str = "layer", learned_decoder_positions: bool = True) -> dict[str, torch.Tensor]:
    """A stock HF whisper state dict (LayerNorm, learned decoder positions;
    v28, v29) or, with ``norm="rms"`` and no learned positions, a
    RoPEWhisper one (v30, v31) -> the port's ``OsuTransformer`` state dict."""
    return _convert_backbone(sd, encoder_layers, decoder_layers, tied_head, fused=False, norm=norm,
                             learned_decoder_positions=learned_decoder_positions)


def convert_ropewhisper_state_dict(sd: dict, encoder_layers: int, decoder_layers: int,
                                   tied_head: bool) -> dict[str, torch.Tensor]:
    return convert_whisper_state_dict(sd, encoder_layers, decoder_layers, tied_head, norm="rms",
                                      learned_decoder_positions=False)


def _t5_attn(out: dict, sd: dict, theirs: str, ours: str, cross: bool) -> None:
    """T5's ``q`` / ``k`` / ``v`` / ``o`` (no biases) -> the fused layout."""
    q, k, v = (sd[f"{theirs}.{p}.weight"] for p in "qkv")
    out[f"{ours}.wo.weight"] = sd[f"{theirs}.o.weight"]
    if cross:
        out[f"{ours}.wq.weight"] = q
        out[f"{ours}.wkv.weight"] = torch.cat([k, v])
    else:
        out[f"{ours}.wqkv.weight"] = torch.cat([q, k, v])


def _t5_ffn(out: dict, sd: dict, theirs: str, ours: str) -> None:
    """``wi_0`` / ``wi_1`` / ``wo`` (v1.1, gated) or ``wi`` / ``wo``."""
    out[f"{ours}.fc2.weight"] = sd[f"{theirs}.wo.weight"]
    if f"{theirs}.wi_0.weight" in sd:
        out[f"{ours}.fc1.weight"] = sd[f"{theirs}.wi_0.weight"]
        out[f"{ours}.fc1_gate.weight"] = sd[f"{theirs}.wi_1.weight"]
    else:
        out[f"{ours}.fc1.weight"] = sd[f"{theirs}.wi.weight"]


def convert_t5_state_dict(sd: dict, encoder_layers: int, decoder_layers: int,
                          tied_head: bool) -> dict[str, torch.Tensor]:
    """An HF T5 state dict -> the port's ``OsuTransformer`` state dict. Each
    stack's relative-position bias is block 0's (HF T5 shares it, as the
    port's per-stack ``rel_bias`` does); the decoder's token table is
    ``decoder.embed_tokens`` or else ``shared``, where the file has one."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    for side, n in (("encoder", encoder_layers), ("decoder", decoder_layers)):
        out[f"{side}.norm.weight"] = sd[f"{side}.final_layer_norm.weight"]
        out[f"{side}.rel_bias.embedding.weight"] = sd[
            f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
        for i in range(n):
            theirs, ours = f"{side}.block.{i}.layer", f"{side}.layers.{i}"
            _t5_attn(out, sd, f"{theirs}.0.SelfAttention", f"{ours}.self_attn", cross=False)
            out[f"{ours}.self_attn_norm.weight"] = sd[f"{theirs}.0.layer_norm.weight"]
            if side == "decoder":
                _t5_attn(out, sd, f"{theirs}.1.EncDecAttention", f"{ours}.cross_attn", cross=True)
                out[f"{ours}.cross_attn_norm.weight"] = sd[f"{theirs}.1.layer_norm.weight"]
            ffn = 2 if side == "decoder" else 1
            _t5_ffn(out, sd, f"{theirs}.{ffn}.DenseReluDense", f"{ours}.ffn")
            out[f"{ours}.final_norm.weight"] = sd[f"{theirs}.{ffn}.layer_norm.weight"]
    for key in ("decoder.embed_tokens.weight", "shared.weight"):
        if key in sd:
            out["decoder.embed_tokens.weight"] = sd[key]
            break
    if not tied_head and "lm_head.weight" in sd:
        out["proj_out.weight"] = sd["lm_head.weight"]
    return out


def _nkernel(sd: dict, prefix: str) -> torch.Tensor:
    """A ``NormLinear``'s raw (out, in) weight, at ``.linear.weight`` or, under
    a parametrization, ``.linear.parametrizations.weight.original``."""
    for key in (f"{prefix}.linear.weight", f"{prefix}.linear.parametrizations.weight.original"):
        if key in sd:
            return sd[key]
    raise KeyError(f"missing NormLinear weight at {prefix}")


def _ngpt_attn(out: dict, sd: dict, theirs: str, ours: str) -> None:
    """nGPT's ``q_proj`` / ``k_proj`` / ``v_proj`` / ``out_proj`` (biases on
    q, v and out where the file has them) and ``qk_scale``."""
    for proj, name in (("q_proj", "wq"), ("k_proj", "wk"), ("v_proj", "wv"), ("out_proj", "wo")):
        out[f"{ours}.{name}.weight"] = _nkernel(sd, f"{theirs}.{proj}")
        if proj != "k_proj" and f"{theirs}.{proj}.linear.bias" in sd:
            out[f"{ours}.{name}.bias"] = sd[f"{theirs}.{proj}.linear.bias"]
    out[f"{ours}.qk_scale.weight"] = sd[f"{theirs}.qk_scale.scale"]


def _ngpt_block(out: dict, sd: dict, theirs: str, ours: str, branches: tuple) -> None:
    """One nGPT layer: each ``(reference residual, port attention or None
    for the feed-forward, port residual)`` of ``branches``."""
    for residual, attn, ours_residual in branches:
        fn = f"{theirs}.{residual}.fn"
        if attn is None:
            out[f"{ours}.ffn.fc1.weight"] = _nkernel(sd, f"{fn}.fc1")
            out[f"{ours}.ffn.fc2.weight"] = _nkernel(sd, f"{fn}.fc2")
        else:
            _ngpt_attn(out, sd, fn, f"{ours}.{attn}")
        out[f"{ours}.{ours_residual}.branch_scale.weight"] = sd[f"{theirs}.{residual}.branch_scale.scale"]


def convert_nwhisper_state_dict(sd: dict, encoder_layers: int, decoder_layers: int,
                                tied_head: bool) -> dict[str, torch.Tensor]:
    """An NWhisperForConditionalGeneration state dict -> the port's
    ``OsuTransformer`` state dict (the head is always the normalised
    ``proj_out`` with its ``logit_scale``)."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    for conv in ("conv1", "conv2"):
        _linear(out, sd, f"encoder.{conv}", f"encoder.{conv}")
    out["encoder.embed_positions"] = sd["encoder.embed_positions.weight"]
    for side in ("encoder", "decoder"):
        out[f"{side}.alpha_positions.weight"] = sd[f"{side}.alpha_positions.scale"]
    for i in range(encoder_layers):
        _ngpt_block(out, sd, f"encoder.layers.{i}", f"encoder.layers.{i}",
                    (("attn_with_residual", "self_attn", "attn_residual"), ("ff_with_residual", None, "ffn_residual")))
    for key in ("decoder.embed_tokens.embedding.weight", "decoder.embed_tokens.embedding.parametrizations.weight.original"):
        if key in sd:
            out["decoder.embed_tokens.weight"] = sd[key]
            break
    out["decoder.embed_positions.weight"] = sd["decoder.embed_positions.weight"]
    for i in range(decoder_layers):
        _ngpt_block(out, sd, f"decoder.layers.{i}", f"decoder.layers.{i}",
                    (("self_attn_with_residual", "self_attn", "attn_residual"),
                     ("encoder_attn_with_residual", "cross_attn", "cross_residual"),
                     ("ff_with_residual", None, "ffn_residual")))
    out["proj_out.weight"] = _nkernel(sd, "proj_out")
    out["logit_scale.weight"] = sd["logit_scale.scale"]
    return out


def _moonshine_attn(out: dict, sd: dict, theirs: str, ours: str, cross: bool) -> None:
    """Moonshine's ``q_proj`` / ``k_proj`` / ``v_proj`` / ``o_proj`` (no
    biases) -> the fused layout."""
    q, k, v = (sd[f"{theirs}.{p}_proj.weight"] for p in "qkv")
    out[f"{ours}.wo.weight"] = sd[f"{theirs}.o_proj.weight"]
    if cross:
        out[f"{ours}.wq.weight"] = q
        out[f"{ours}.wkv.weight"] = torch.cat([k, v])
    else:
        out[f"{ours}.wqkv.weight"] = torch.cat([q, k, v])


def convert_moonshine_state_dict(sd: dict, encoder_layers: int, decoder_layers: int,
                                 tied_head: bool) -> dict[str, torch.Tensor]:
    """An HF Moonshine state dict -> the port's ``OsuTransformer`` state dict
    (the raw-wave stem, bias-free norms, the gated-concat decoder MLP)."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {"encoder.conv1.weight": sd["encoder.conv1.weight"]}
    for name in ("groupnorm", "conv2", "conv3"):
        _linear(out, sd, f"encoder.{name}", f"encoder.{name}")
    out["encoder.norm.weight"] = sd["encoder.layer_norm.weight"]
    out["decoder.norm.weight"] = sd["decoder.norm.weight"]
    out["decoder.embed_tokens.weight"] = sd["decoder.embed_tokens.weight"]
    for side, n in (("encoder", encoder_layers), ("decoder", decoder_layers)):
        for i in range(n):
            p = f"{side}.layers.{i}"
            _moonshine_attn(out, sd, f"{p}.self_attn", f"{p}.self_attn", cross=False)
            out[f"{p}.self_attn_norm.weight"] = sd[f"{p}.input_layernorm.weight"]
            if side == "decoder":
                _moonshine_attn(out, sd, f"{p}.encoder_attn", f"{p}.cross_attn", cross=True)
                out[f"{p}.cross_attn_norm.weight"] = sd[f"{p}.post_attention_layernorm.weight"]
                out[f"{p}.final_norm.weight"] = sd[f"{p}.final_layernorm.weight"]
            else:
                out[f"{p}.final_norm.weight"] = sd[f"{p}.post_attention_layernorm.weight"]
            _ffn(out, sd, f"{p}.mlp", f"{p}.ffn")
    if not tied_head and "proj_out.weight" in sd:
        out["proj_out.weight"] = sd["proj_out.weight"]
    return out


_BACKBONE_CONVERTERS = {
    "varwhisper": convert_varwhisper_state_dict,
    "whisper": convert_whisper_state_dict,
    "ropewhisper": convert_ropewhisper_state_dict,
    "nwhisper": convert_nwhisper_state_dict,
    "t5": convert_t5_state_dict,
    "moonshine": convert_moonshine_state_dict,
}


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------


def _mlp_embedder(out: dict, sd: dict, prefix: str, proj: str) -> None:
    """RBF + [Linear, LayerNorm, ReLU, Dropout, Linear, LayerNorm]: the torch
    Sequential's indices 0 / 1 / 4 / 5 are the port's proj1 / norm1 / proj2 /
    norm2."""
    out[f"{prefix}.rbf.basis_centers"] = sd[f"{prefix}.basis_centers"]
    out[f"{prefix}.rbf.basis_widths"] = sd[f"{prefix}.basis_widths"]
    for index, ours in ((0, "proj1"), (1, "norm1"), (4, "proj2"), (5, "norm2")):
        for leaf in ("weight", "bias"):
            out[f"{prefix}.{ours}.{leaf}"] = sd[f"{prefix}.{proj}.{index}.{leaf}"]


def convert_mapperatorinator_state_dict(sd: dict, config: MapperatorinatorConfig,
                                        family: str = "varwhisper") -> dict[str, torch.Tensor]:
    """A reference Mapperatorinator state dict -> the port's
    ``Mapperatorinator`` state dict, every conditioning embedder included."""
    b = config.backbone
    transformer_sd = {k.removeprefix("transformer."): v for k, v in sd.items() if k.startswith("transformer.")}
    backbone = _BACKBONE_CONVERTERS[family](transformer_sd, b.encoder_layers, b.decoder_layers,
                                            b.tie_word_embeddings)
    tied = b.tie_word_embeddings and b.norm_scheme != "ngpt"  # an nGPT head is its own
    if config.embed_decoder_input and not tied:
        backbone.pop("decoder.embed_tokens.weight", None)  # the port's decoder has no token table to fill
    out = {f"transformer.{k}": v for k, v in backbone.items()}
    if config.embed_decoder_input and "decoder_embedder.weight" in sd:
        out["decoder_embedder.weight"] = sd["decoder_embedder.weight"]
    if config.project_encoder_input and "encoder_embedder.weight" in sd:
        out["encoder_embedder.weight"] = sd["encoder_embedder.weight"]
        out["encoder_embedder.bias"] = sd["encoder_embedder.bias"]
    if config.do_style_embed and "style_embedder.embedding_table.weight" in sd:
        out["style_embedder.weight"] = sd["style_embedder.embedding_table.weight"]
    if config.do_difficulty_embed and "difficulty_embedder.basis_centers" in sd:
        _mlp_embedder(out, sd, "difficulty_embedder", "difficulty_proj")
    if config.do_mapper_embed and "mapper_embedder.embedding.weight" in sd:
        out["mapper_embedder.table.weight"] = sd["mapper_embedder.embedding.weight"]
        out["mapper_embedder.norm.weight"] = sd["mapper_embedder.layer_norm.weight"]
        out["mapper_embedder.norm.bias"] = sd["mapper_embedder.layer_norm.bias"]
    if config.do_song_position_embed and "song_pos_embedder.basis_centers" in sd:
        _mlp_embedder(out, sd, "song_pos_embedder", "position_proj")
    return out


def load_hf_checkpoint(directory: Union[str, Path]) -> Mapperatorinator:
    """The model of a published checkpoint directory (``config.json`` +
    ``model.safetensors`` or ``pytorch_model*.bin``), on the CPU with its
    parameters in fp32 (a bf16 or fp16 file is cast on load)."""
    directory = Path(directory)
    with open(directory / "config.json", encoding="utf-8") as f:
        hf_cfg = json.load(f)
    family, config = config_from_hf(hf_cfg)
    state = convert_mapperatorinator_state_dict(read_torch_weights(directory), config, family)
    model = Mapperatorinator(config)
    model.load_state_dict(state)
    return model
