"""The mapper-style classifier and the rhythm-complexity estimator
(``models/classifier.py``).

* :class:`OsuClassifier`: a whisper-style encoder-decoder over the audio
  (the unlogged power mel, embedded by a dense layer and fed to the encoder
  in place of its conv stem's input) and the beatmap's tokens (embedded by
  the classifier's own table: the backbone's decoder has none, and no LM
  head), then a projector whose output, averaged over every target position
  (pads included), is the FID feature vector, and a linear head over the
  mapper classes. Each attention call the flash kernel covers runs on it:
  the encoder's, the decoder's causal self-attention under the token mask,
  and the cross attention.
* :class:`OsuR`: an MLP over a window of embedded rhythm tokens that
  predicts the next time shift; its per-token cross-entropy is the rhythm
  complexity.
* :func:`build_classifier` builds the classifier from a classifier config as
  ``classifier_train.py:build_classifier`` does; :func:`transfer_from_pretrained`
  grafts a generation checkpoint's towers into it;
  :func:`save_classifier_bundle` and :func:`load_classifier_bundle` write
  and read the bundle (``params.msgpack``, ``classifier_config.json``,
  ``tokenizer.json``) that ``classifier_train.py`` exports and
  ``calc_fid.py`` reads.

Both losses are the log-softmax's negative log-likelihood in fp32, averaged
over the batch (OsuR's weighted by ``sample_weights`` first).
"""

from __future__ import annotations

import dataclasses
import json
import types
from pathlib import Path
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ..audio.mel import MelSpectrogram
from ..config import PARSER_DATA_DEFAULTS, load_classifier_config
from ..osu.vocab import Vocabulary
from .io import load_params, save_params
from .params import flax_paths
from .transformer import Dense, OsuTransformer, TransformerConfig


@dataclasses.dataclass(frozen=True)
class ClassifierConfig:
    backbone: TransformerConfig = TransformerConfig()
    vocab_size: int = 4096  # beatmap-token vocab (decoder side)
    num_classes: int = 3731  # mappers
    classifier_proj_size: int = 256
    sample_rate: int = 16000
    n_fft: int = 1024
    n_mels: int = 388
    hop_length: int = 128


class OsuClassifier(nn.Module):
    def __init__(self, cfg: ClassifierConfig):
        super().__init__()
        self.cfg = cfg
        b = cfg.backbone
        self.spectrogram = MelSpectrogram("xla", sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, n_mels=cfg.n_mels,
                                          hop_length=cfg.hop_length)
        # the conv stem (under input_features) takes the embedded mel, d_model wide
        self.transformer = OsuTransformer(dataclasses.replace(b, num_mel_bins=b.d_model), embed_inputs=False,
                                          head=False)
        self.decoder_embedder = nn.Embedding(cfg.vocab_size, b.d_model)
        self.encoder_embedder = Dense(cfg.n_mels, b.d_model)
        self.projector = Dense(b.d_model, cfg.classifier_proj_size)
        self.classifier = Dense(cfg.classifier_proj_size, cfg.num_classes)

    def forward(self, frames: torch.Tensor, decoder_input_ids: torch.Tensor,
                decoder_attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None) -> dict:
        """frames: (B, n_samples) raw audio; decoder_input_ids: (B, T), int32
        or int64; decoder_attention_mask: (B, T), True (or 1) where a token is
        real."""
        inputs_embeds = self.encoder_embedder(self.spectrogram(frames))
        decoder_embeds = self.decoder_embedder(decoder_input_ids)
        self_mask = None
        if decoder_attention_mask is not None:
            self_mask = decoder_attention_mask[:, None, None, :].bool()
        encoder_states = self.transformer.encoder(inputs_embeds)
        hidden = self.transformer.decoder(decoder_embeds, encoder_states, self_mask=self_mask)
        pooled = self.projector(hidden).mean(dim=1)
        logits = self.classifier(pooled)
        loss = None if labels is None else F.cross_entropy(logits.float(), labels.long())
        return {"loss": loss, "logits": logits, "feature_vector": pooled, "decoder_last_hidden_state": hidden,
                "encoder_last_hidden_state": encoder_states}


@dataclasses.dataclass(frozen=True)
class OsuRConfig:
    vocab_size_in: int = 9920
    vocab_size_out: int = 3988
    src_seq_len: int = 64
    hidden_size: int = 128


class OsuR(nn.Module):
    """Next-note-timing MLP; per-token CE gives the rhythm-complexity signal."""

    def __init__(self, cfg: OsuRConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed = nn.Embedding(cfg.vocab_size_in, h)
        self.fc1 = Dense(cfg.src_seq_len * h, 4 * h)
        self.fc2 = Dense(4 * h, 2 * h)
        self.fc3 = Dense(2 * h, h)
        self.head = Dense(h, cfg.vocab_size_out)

    def forward(self, input_ids: torch.Tensor, labels: Optional[torch.Tensor] = None,
                sample_weights: Optional[torch.Tensor] = None) -> dict:
        h = self.embed(input_ids).flatten(1)
        h = F.relu(self.fc3(F.relu(self.fc2(F.relu(self.fc1(h))))))
        logits = self.head(h)
        loss = None
        if labels is not None:
            nll = F.cross_entropy(logits.float(), labels.long(), reduction="none")
            if sample_weights is not None:
                nll = nll * sample_weights
            loss = nll.mean()
        return {"loss": loss, "logits": logits}


def build_classifier(args, vocab) -> OsuClassifier:
    """The classifier of a classifier config (``args.model``, ``args.data``)
    and its vocabulary, on the CPU with PyTorch's default initialisation:
    ``classifier_train.py:build_classifier``. Under ``input_features`` the
    conv stem halves the mel frames, so the encoder has half the source
    positions; without it the embedded mel enters the encoder directly."""
    m = args.model
    backbone = TransformerConfig(
        vocab_size=vocab.vocab_size_out,
        d_model=m.d_model,
        encoder_layers=m.encoder_layers,
        decoder_layers=m.decoder_layers,
        encoder_heads=m.encoder_heads,
        decoder_heads=m.decoder_heads,
        encoder_ffn=m.encoder_ffn,
        decoder_ffn=m.decoder_ffn,
        max_source_positions=args.data.src_seq_len // 2 if m.input_features else args.data.src_seq_len,
        max_target_positions=args.data.tgt_seq_len,
        num_mel_bins=m.spectrogram.n_mels,
        position_scheme=getattr(m, "position_scheme", "whisper_abs"),
        norm=getattr(m, "norm", "layer"),
        conv_stem=bool(m.input_features),
    )
    return OsuClassifier(ClassifierConfig(
        backbone=backbone,
        vocab_size=vocab.vocab_size_in,
        num_classes=vocab.num_mapper_classes,
        classifier_proj_size=m.classifier_proj_size,
        sample_rate=m.spectrogram.sample_rate,
        n_fft=m.spectrogram.n_fft,
        n_mels=m.spectrogram.n_mels,
        hop_length=m.spectrogram.hop_length,
    ))


# the JAX ignore list (classifier/train.py:22-29), as flax path prefixes: the
# decoder token / position embeddings and LM head belong to the generation
# vocab, the decoder_embedder to the classifier's own input vocab, loss
# weights to the osuT5 objective; none transfer
_TRANSFER_IGNORE = ("params/transformer/decoder/embed_tokens", "params/transformer/decoder/embed_positions",
                    "params/transformer/proj_out", "params/decoder_embedder", "params/loss_fn")


def transfer_from_pretrained(classifier: nn.Module, pretrained: nn.Module) -> dict[str, torch.Tensor]:
    """The classifier's state dict with its towers taken from a pretrained
    generation model (a :class:`.mapperatorinator.Mapperatorinator`), the JAX
    ``transfer_from_pretrained``: every tensor whose flax path both models
    hold is grafted, but for the ignore list; the classifier's own tensors
    (projector, head) keep their values. Matching by flax path, as the JAX
    function matches its trees, keeps a LayerNorm from taking an RMSNorm's
    scale. Raises on a shape mismatch at a transferable path, and when
    nothing transfers."""
    state = classifier.state_dict()
    theirs = {path: name for name, path in flax_paths(pretrained).items()}
    source = pretrained.state_dict()
    grafted = 0
    for name, path in flax_paths(classifier).items():
        if any(path == p or path.startswith(p + "/") for p in _TRANSFER_IGNORE) or path not in theirs:
            continue
        src = source[theirs[path]]
        if tuple(src.shape) != tuple(state[name].shape):
            raise ValueError(f"pretrained checkpoint shape mismatch at {path.removeprefix('params/')}: "
                             f"{tuple(src.shape)} vs classifier {tuple(state[name].shape)} — configure the "
                             "classifier backbone to the checkpoint's dims")
        state[name] = src.to(state[name].dtype).clone()
        grafted += 1
    if grafted == 0:
        raise ValueError("no transferable parameters found in the pretrained checkpoint "
                         "(wrong backbone family/scheme for this classifier config?)")
    return state


# -- bundles ------------------------------------------------------------------


def _plain(node):
    """A config namespace -> JSON-shaped data, enums as their values."""
    if isinstance(node, types.SimpleNamespace):
        node = vars(node)
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return getattr(node, "value", node)


def save_classifier_bundle(directory, model: OsuClassifier, args, vocab: Vocabulary) -> Path:
    """The bundle ``classifier_train.py`` exports: ``params.msgpack`` (the
    flax tree), ``classifier_config.json`` (the config's ``model`` and
    ``data`` nodes) and ``tokenizer.json``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    save_params(directory / "params.msgpack", model)
    with open(directory / "classifier_config.json", "w", encoding="utf-8") as f:
        json.dump({"model": _plain(args.model), "data": _plain(args.data)}, f)
    vocab.save_pretrained(directory)
    return directory


def load_classifier_bundle(directory) -> tuple[OsuClassifier, types.SimpleNamespace, Vocabulary]:
    """(classifier on the CPU, its config as ``model`` and ``data``
    namespaces, vocabulary) of a bundle, as ``calc_fid.py:load_classifier``
    rebuilds one: the model fields over those of
    ``configs/classifier/train_v1.yaml``, the data fields (but the context
    types, which the classifier does not read) over the JAX ``DataConfig()``
    defaults the parser reads."""
    directory = Path(directory)
    with open(directory / "classifier_config.json", encoding="utf-8") as f:
        saved = json.load(f)
    preset = load_classifier_config("train_v1")
    model_cfg = {**vars(preset.model), **saved["model"]}
    model_cfg["spectrogram"] = types.SimpleNamespace(**{**vars(preset.model.spectrogram),
                                                         **saved["model"].get("spectrogram", {})})
    data = {k: v for k, v in saved["data"].items() if k != "context_types"}
    clf_args = types.SimpleNamespace(model=types.SimpleNamespace(**model_cfg),
                                     data=types.SimpleNamespace(**{**PARSER_DATA_DEFAULTS, **data}))
    vocab = Vocabulary.from_pretrained(directory)
    model = load_params(directory / "params.msgpack", build_classifier(clf_args, vocab))
    return model, clf_args, vocab
