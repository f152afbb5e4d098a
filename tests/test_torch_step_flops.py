"""The frame-to-token ratio of the FLOPs count (``train/loop.py``): raw audio
encoder positions of a window come from the model's config
(``encoder_positions``: a position per hop times the whisper stem's stride
2, per hop alone without a stem, what moonshine's raw-wave stem makes),
where the JAX ``step_flops`` takes a position per 128 · 2 samples for every
model.

* v32 and its fine-tune and LoRA configs: the port's count equals the JAX
  ``step_flops`` exactly (rel 1e-12), the JAX function given the same
  parameter counts and the backbone's dims;
* the classifier (no stem: a position a hop) and moonshine (no spectrogram)
  give the derived count: the hand formula with their positions, within 2
  a row of what the classifier's encoder makes and exactly moonshine's
  stem length;
* every backbone family's training config (v28, v29, T5, nGPT, moonshine):
  the positions within 1 of what its encoder makes, the tokens, and the
  hand count at the attention widths heads x head dim, equal to the JAX
  count for the whisper stems.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mapperatorinator_tpu.train import loop as jax_loop
from mapperatorinator_tpu_torch.config import load_classifier_config, load_train_config
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.classifier import build_classifier
from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
from mapperatorinator_tpu_torch.models.transformer import moonshine_stem_length
from mapperatorinator_tpu_torch.osu import build_vocabulary
from mapperatorinator_tpu_torch.train import loop

N_ENC, N_DEC = 1_000, 3_000


class Counted(torch.nn.Module):
    """N_ENC encoder and N_DEC decoder-side parameters, and their JAX tree."""

    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(N_ENC, 1, bias=False)
        self.decoder = torch.nn.Linear(N_DEC, 1, bias=False)

    @staticmethod
    def jax_state():
        return SimpleNamespace(params={"encoder": {"w": np.zeros(N_ENC)}, "decoder": {"w": np.zeros(N_DEC)}})


def batch_of(rows: int, samples: int, tokens: int) -> dict:
    return {"frames": np.zeros((rows, samples), np.float32), "decoder_input_ids": np.zeros((rows, tokens), np.int64)}


def hand_count(cfg, batch, s_enc: float) -> float:
    """6 N per token a side, and 12 S^2 (heads x head dim) per layer and row."""
    rows, s_dec = batch["frames"].shape[0], batch["decoder_input_ids"].shape[1]
    b = cfg.backbone
    w_enc, w_dec = b.encoder_heads * b.head_dim, b.decoder_heads * b.head_dim
    attention = rows * 12.0 * (b.encoder_layers * int(s_enc) ** 2 * w_enc + b.decoder_layers * s_dec ** 2 * w_dec
                               + b.decoder_layers * s_dec * int(s_enc) * w_dec)
    return 6.0 * (N_ENC * rows * s_enc + N_DEC * rows * s_dec) + attention


@pytest.mark.parametrize("name", ["v32", "v32-mini", "v32_ft", "v32-mini_ft", "lora", "lora_v32"])
def test_v32_family_counts_equal_the_jax_step_flops(name):
    args = load_train_config(name)
    cfg = build_config(args, build_vocabulary(args))
    for rows, src in ((2, args.data.src_seq_len), (32, 2048), (3, 777)):
        samples = cfg.hop_length * (src - 1)
        assert loop.encoder_positions(cfg, samples) == samples / 256.0
        batch = batch_of(rows, samples, args.data.tgt_seq_len)
        want = jax_loop.step_flops(Counted.jax_state(), batch, cfg.backbone)
        assert loop.step_flops(Counted(), batch, cfg) == pytest.approx(want, rel=1e-12)
        assert loop.batch_tokens(batch, cfg) == pytest.approx(jax_loop._batch_tokens(batch), rel=1e-12)


def test_the_classifier_counts_a_position_a_hop():
    args = load_classifier_config("train_v1", ["model.d_model=64", "model.encoder_layers=1", "model.decoder_layers=1",
                                               "model.encoder_heads=2", "model.decoder_heads=2",
                                               "model.encoder_ffn=64", "model.decoder_ffn=64",
                                               "model.spectrogram.n_mels=16", "data.src_seq_len=64",
                                               "data.tgt_seq_len=16"])
    model = build_classifier(args, build_vocabulary(args))
    cfg = model.cfg
    samples = cfg.hop_length * (args.data.src_seq_len - 1)
    assert not cfg.backbone.conv_stem and cfg.hop_length == 128
    assert loop.encoder_positions(cfg, samples) == samples / 128.0
    batch = batch_of(2, samples, args.data.tgt_seq_len)
    assert loop.step_flops(Counted(), batch, cfg) == pytest.approx(hand_count(cfg, batch, samples / 128.0), rel=1e-12)
    with torch.no_grad():
        out = model(torch.zeros(batch["frames"].shape), torch.ones((2, 16), dtype=torch.long))
    positions = out["encoder_last_hidden_state"].shape[1]
    tok_enc, tok_dec = loop._batch_token_split(batch, cfg)
    assert abs(tok_enc / 2 - positions) <= 2 and tok_dec == 32
    # the JAX count halves the classifier's positions, as if it had a stem
    assert jax_loop._batch_tokens(batch) == pytest.approx(tok_enc / 2 + tok_dec)


def test_moonshine_counts_its_raw_wave_stem():
    args = load_train_config("moonshine_tiny")
    cfg = build_config(args, build_vocabulary(args))
    samples = 128 * (args.data.src_seq_len * 2 - 1)
    positions = moonshine_stem_length(samples)
    assert cfg.input_raw_wave and loop.encoder_positions(cfg, samples) == positions
    batch = batch_of(4, samples, args.data.tgt_seq_len)
    assert loop.step_flops(Counted(), batch, cfg) == pytest.approx(hand_count(cfg, batch, positions), rel=1e-12)
    tok_enc, _ = loop._batch_token_split(batch, cfg)
    assert tok_enc == 4 * positions


TINY = ["model.overwrite.d_model=32", "model.overwrite.encoder_layers=1", "model.overwrite.decoder_layers=1",
        "model.overwrite.encoder_attention_heads=2", "model.overwrite.decoder_attention_heads=2",
        "model.overwrite.encoder_ffn_dim=32", "model.overwrite.decoder_ffn_dim=32", "mixed_precision=no"]
# (the backbone's stem, its attention widths encoder and decoder) at full width
FAMILY_COUNTS = {"v28": ("whisper", 512, 512), "v29": ("whisper", 768, 768), "nwhisper_base": ("whisper", 512, 512),
                 "t5_base": (None, 768, 768), "moonshine_tiny": ("moonshine", 288, 288)}


@pytest.mark.parametrize("name", sorted(FAMILY_COUNTS))
def test_each_backbone_family_counts_what_its_encoder_makes(name):
    """Each family's training config at full width: the encoder positions
    counted a window are within 1 of what the model's own encoder makes of
    it (a tiny model of the same stem: a whisper stem halves a position a
    hop, T5 has no stem, moonshine's raw-wave stem makes its length), the
    tokens are those positions plus the decoder's, and ``step_flops`` is the
    hand count at the attention widths heads x head dim (T5's d_kv 64,
    moonshine's 36); with a whisper stem it equals the JAX ``step_flops``."""
    args = load_train_config(name)
    cfg = build_config(args, build_vocabulary(args))
    stem, w_enc, w_dec = FAMILY_COUNTS[name]
    b = cfg.backbone
    assert ((b.stem_type if b.conv_stem else None), *loop.attention_widths(b)) == (stem, w_enc, w_dec)
    samples = cfg.hop_length * (args.data.src_seq_len - 1)
    positions = loop.encoder_positions(cfg, samples)
    tiny_args = load_train_config(name, TINY)
    tiny = Mapperatorinator(build_config(tiny_args, build_vocabulary(tiny_args)))
    with torch.no_grad():
        made = tiny.encode(torch.zeros((1, samples))).shape[1]
    assert abs(made - positions) <= 1
    rows, tokens = 4, args.data.tgt_seq_len
    batch = batch_of(rows, samples, tokens)
    assert loop.batch_tokens(batch, cfg) == pytest.approx(rows * (positions + tokens), rel=1e-12)
    assert loop.step_flops(Counted(), batch, cfg) == pytest.approx(hand_count(cfg, batch, positions), rel=1e-12)
    if stem == "whisper":
        want = jax_loop.step_flops(Counted.jax_state(), batch, cfg.backbone)
        assert loop.step_flops(Counted(), batch, cfg) == pytest.approx(want, rel=1e-12)
