"""Autoregressive decode engine (``decode/engine.py``), eager PyTorch.

Semantics of the JAX ``DecodeEngine.generate``:

* the prompt is right-padded to its power-of-two bucket and prefilled in one
  chunk into a fixed ``max_length`` KV buffer; the loop then starts at the
  prompt's true length, its first step recomputing the last prompt token;
* a multi-EOS stopping set (a vocab-sized mask);
* the logits chain of :mod:`.logits`;
* classifier-free guidance as a folded ``[negative; positive]`` batch whose
  halves receive the same sampled token;
* rows that have finished emit pad.

Sampling draws from a ``torch.Generator`` seeded per call. The JAX engine
draws with ``jax.random``: the two frameworks' streams differ, so sampled
tokens are compared through the processed logits, and greedy decode token
for token.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .logits import LogitsPipeline


def _bucket(p: int) -> int:
    """Smallest power of two >= p (min 64)."""
    b = 64
    while b < p:
        b *= 2
    return b


class DecodeEngine:
    """Wraps a :class:`..models.Mapperatorinator` on ``device``, which the
    caller names: there is no default device."""

    def __init__(self, model, max_length: int, pad_token_id: int, device):
        self.model = model
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.device = torch.device(device)

    @torch.inference_mode()
    def encode_with_cond(self, frames, cond: Optional[dict] = None) -> torch.Tensor:
        """Audio windows (B, n_samples) -> encoder states on the device."""
        if cond:
            raise NotImplementedError(
                f"conditioning inputs {sorted(cond)}: the embedders are not ported yet (ROADMAP queue 1, item 10)"
            )
        frames = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        return self.model.encode(frames)

    @torch.inference_mode()
    def generate(
        self,
        encoder_states: torch.Tensor,
        decoder_input_ids: np.ndarray,
        pipeline: LogitsPipeline,
        eos_ids: list[int],
        seed: int = 0,
        decoder_attention_mask: Optional[np.ndarray] = None,
        cfg_scale: float = 1.0,
        max_length: Optional[int] = None,
        step_logits: Optional[list] = None,
    ) -> tuple[np.ndarray, int]:
        """Decode from a left-padded prompt (B, P); with ``cfg_scale > 1`` the
        rows are the folded ``[negative; positive]`` batch and
        ``encoder_states`` matches them. Returns the (B, max_length) token
        buffer, right-padded with pad, and the final write position. A list
        passed as ``step_logits`` receives each step's processed scores."""
        max_length = max_length or self.max_length
        model, dev, pad_id = self.model, self.device, self.pad_token_id
        B, P_orig = decoder_input_ids.shape
        if P_orig >= max_length:
            raise ValueError(f"prompt length {P_orig} >= max_length {max_length}")
        if decoder_attention_mask is None:
            decoder_attention_mask = decoder_input_ids != pad_id
        use_cfg = cfg_scale > 1.0
        half = B // 2 if use_cfg else B

        P = min(_bucket(P_orig), max_length)
        ids = torch.full((B, P), pad_id, dtype=torch.long, device=dev)
        ids[:, :P_orig] = torch.as_tensor(np.asarray(decoder_input_ids), device=dev)
        prompt_mask = torch.zeros((B, P), dtype=torch.bool, device=dev)
        prompt_mask[:, :P_orig] = torch.as_tensor(np.asarray(decoder_attention_mask, bool), device=dev)
        eos_mask = torch.zeros(pipeline.vocab_size, dtype=torch.bool, device=dev)
        eos_mask[list(eos_ids)] = True

        # prefill: one chunked step writes the prompt's KV slots
        cache = model.init_cache(B, max_length, encoder_states)
        tokens = torch.full((B, max_length), pad_id, dtype=torch.long, device=dev)
        tokens[:, :P] = ids
        attn = torch.zeros((B, max_length), dtype=torch.bool, device=dev)
        attn[:, :P] = prompt_mask
        positions = (torch.cumsum(prompt_mask.long(), dim=1) - 1).clamp(min=0)
        n_valid = prompt_mask.sum(dim=1)
        model.decode_step(model.embed_tokens(ids), cache, 0, self_mask=attn[:, None, None, :], positions=positions)

        gen = torch.Generator(device=dev).manual_seed(seed)
        lstate = pipeline.init_state(half, dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        cur_len = P_orig
        while cur_len < max_length and not bool(finished.all()):
            last = tokens[:, cur_len - 1:cur_len]
            logits, cache = model.decode_step(
                model.embed_tokens(last), cache, cur_len - 1,
                self_mask=attn[:, None, None, :], positions=(n_valid - 1)[:, None],
            )
            scores = logits[:, -1].float()
            if use_cfg:
                neg, pos = scores[:half], scores[half:]
                scores = pos + (neg - pos) * cfg_scale
            lstate, scores = pipeline(lstate, scores)
            if step_logits is not None:
                step_logits.append(scores)
            if pipeline.do_sample:
                sampled = torch.multinomial(torch.softmax(scores, dim=-1), 1, generator=gen)[:, 0]
            else:
                sampled = scores.argmax(dim=-1)
            lstate = pipeline.update_state(lstate, sampled)
            if use_cfg:
                sampled = torch.cat([sampled, sampled])
            sampled = torch.where(finished, pad_id, sampled)
            hit_eos = eos_mask[sampled[:half]]
            finished = finished | (torch.cat([hit_eos, hit_eos]) if use_cfg else hit_eos)
            tokens[:, cur_len] = sampled
            attn[:, cur_len] = True
            cur_len += 1
            n_valid = n_valid + 1
        return tokens.cpu().numpy(), cur_len

    def generate_beams(self, *args, **kwargs):
        raise NotImplementedError("beam search: ROADMAP queue 1, item 8")

    def forward(self, *args, **kwargs):
        raise NotImplementedError("teacher-forced engine forward: ROADMAP queue 1, item 8")

    def forward_stats(self, *args, **kwargs):
        raise NotImplementedError("forward_stats (ai_mod): ROADMAP queue 1, item 8")

    def generate_forced(self, *args, **kwargs):
        raise NotImplementedError("forced decode: ROADMAP queue 1, item 8")
