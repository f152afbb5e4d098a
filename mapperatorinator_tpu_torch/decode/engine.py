"""Autoregressive decode engine (``decode/engine.py``).

Semantics of the JAX ``DecodeEngine.generate``:

* the prompt is right-padded to its power-of-two bucket and prefilled in one
  chunk into a fixed ``max_length`` KV buffer; the loop then starts at the
  prompt's true length, its first step recomputing the last prompt token;
* a multi-EOS stopping set (a vocab-sized mask);
* the logits chain of :mod:`.logits`;
* classifier-free guidance as a folded ``[negative; positive]`` batch whose
  halves receive the same sampled token;
* rows that have finished emit pad, and the returned position is the first
  step after which every row had finished (else ``max_length``).

The JAX engine compiles its loop into one program. Here one step function
(:meth:`DecodeEngine._step`) runs over static per-engine buffers (the KV
cache, tokens, masks, the write position, ``finished``, the logits chain's
state), indexed by device tensors and with no host read. Its cached
attention reads a static prefix, the end of the ``decode_attend_bucket``
bucket that holds the write slot. On a CUDA device each (batch, length,
pipeline, CFG scale, bucket) is captured as a CUDA graph the first time the
loop reaches it, that step itself running eagerly first as the capture's
warm-up, and replayed once a token; ``use_graphs = False`` runs the same
step eagerly instead (to hold the two against each other), as the CPU always
does. The host counts the write position itself, picks each step's bucket
and reads whether every row has finished once every ``sync_every`` steps;
steps past the stop write pad. Each cached path also hands the model the
logical position of every cache slot (``k_positions``, which a T5
relative-position bias reads), as the JAX engine builds it: the prompt's
pad-free rank, then each row's logical length onward (in ``generate``, a
static buffer written before any step, so a graph reads it); the slot less
the row's left pads (``generate_forced``, ``generate_beams``). The
teacher-forced paths take the model's default, as in JAX.

Sampling is the exponential race of ``torch.multinomial``: the argmax of
``probs / noise`` with ``Exp(1)`` noise, drawn outside the step from a
``torch.Generator`` seeded per call, ``NOISE_BLOCK`` steps at a time, one
draw a step as ``torch.multinomial`` draws it, so graph and eager steps (and
``torch.multinomial``) pick the same tokens. The JAX engine draws with
``jax.random``: the two frameworks' streams differ, so sampled tokens are
compared through the processed logits, and greedy decode token for token.

A model placed on the tensor axis (:func:`..parallel.sharding.shard_params`)
serves through the same engine, every rank calling it with the same inputs:
the caches hold the rank's heads and the logits are whole on every rank. A
graph captures the step's all-reduces where the tensor group is NCCL's;
under a gloo tensor group, whose collectives run on the host and cannot be
captured, :meth:`generate` steps eagerly (the rule is printed when the
engine is made).

The other entry points of the JAX engine: :meth:`DecodeEngine.forward` and
:meth:`DecodeEngine.forward_stats` (teacher-forced logits, and the per-token
analysis statistics reduced on the device), :meth:`DecodeEngine.generate_forced`
(the stepwise path fed given tokens, returning the processed scores) and
:meth:`DecodeEngine.generate_beams` (HF-style beam search and beam sampling).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.transformer import decode_read_limit
from ..ops import launches
from ..parallel.tensor import tensor_group_of
from .logits import LogitsPipeline, LogitsState

COND_IDS = frozenset({"beatmap_idx", "mapper_idx"})  # the conditions that are ids
NOISE_BLOCK = 8  # steps of sampling noise drawn at a time, outside the step
SYNC_EVERY = 8  # steps between the host's reads of whether every row has finished


def _bucket(p: int) -> int:
    """Smallest power of two >= p (min 64)."""
    b = 64
    while b < p:
        b *= 2
    return b


def _row_bucket(n: int) -> int:
    """Smallest power of two >= n (min 1): batch-row bucketing."""
    b = 1
    while b < n:
        b *= 2
    return b


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: ties go to the lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


NEG = -1e9  # the beam search's "no hypothesis" score


class _Chain(NamedTuple):
    """The logits chain's buffers for ``half`` sampled rows."""

    state: LogitsState
    scores: torch.Tensor  # (half, V) fp32: the step's processed scores
    noise: torch.Tensor  # (NOISE_BLOCK, half, V) fp32: Exp(1) sampling noise


class _DecodeState:
    """The static buffers of one (B, max_length) decode, reused from call to
    call, and the CUDA graphs captured over them."""

    def __init__(self, model, batch: int, max_length: int, encoder_states: torch.Tensor, pad_id: int):
        dev = encoder_states.device
        self.cache = model.init_cache(batch, max_length, encoder_states)
        self.tokens = torch.full((batch, max_length), pad_id, dtype=torch.long, device=dev)
        self.attn = torch.zeros((batch, max_length), dtype=torch.bool, device=dev)
        self.n_valid = torch.zeros(batch, dtype=torch.long, device=dev)  # logical (pad-free) lengths
        # the logical position of each slot, which a relative-position bias
        # reads: written once a decode, before any step (or its graph) runs
        self.k_positions = torch.zeros((batch, max_length), dtype=torch.long, device=dev)
        self.cur_len = torch.zeros((), dtype=torch.long, device=dev)  # the next write slot
        self.start = torch.zeros((), dtype=torch.long, device=dev)  # the prompt's length
        self.finished = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.stop = torch.zeros((), dtype=torch.long, device=dev)  # the returned position
        self.stop_host = torch.zeros((), dtype=torch.long).pin_memory() if dev.type == "cuda" else None
        self.eos_mask = torch.zeros(model.cfg.vocab_size_out, dtype=torch.bool, device=dev)
        self.chains: dict[int, _Chain] = {}  # by sampled rows
        self.graphs: dict[tuple, dict] = {}  # (pipeline, cfg_scale) -> {bucket end: (Graph, pipeline)}

    def chain(self, half: int) -> _Chain:
        c = self.chains.get(half)
        if c is None:
            dev, vocab_size = self.tokens.device, self.eos_mask.shape[0]
            scores = lambda *lead: torch.zeros((*lead, half, vocab_size), dtype=torch.float32, device=dev)  # noqa: E731
            c = self.chains[half] = _Chain(
                LogitsState(torch.full((half,), -1, dtype=torch.int32, device=dev),
                            torch.full((half,), -1, dtype=torch.int32, device=dev), scores()),
                scores(), scores(NOISE_BLOCK))
        return c

    def read_stop(self) -> int:
        """The device's stop position, through a pinned copy on CUDA."""
        if self.stop_host is None:
            return int(self.stop)
        self.stop_host.copy_(self.stop, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.stop.device))
        event.synchronize()
        return int(self.stop_host)


class DecodeEngine:
    """Wraps a :class:`..models.Mapperatorinator` on ``device``, which the
    caller names: there is no default device. On a CUDA device
    :meth:`generate` replays CUDA graphs unless ``use_graphs`` is cleared;
    ``captures`` and ``capture_seconds`` count the graphs captured and the
    host time spent capturing them."""

    def __init__(self, model, max_length: int, pad_token_id: int, device):
        self.model = model
        self.max_length = max_length
        self.pad_token_id = pad_token_id
        self.device = torch.device(device)
        # cleared, generate runs its step eagerly on a card too (chip_smoke.py
        # and the card tests hold the two against each other)
        self.use_graphs = True
        self.sync_every = SYNC_EVERY
        self.captures, self.capture_seconds = 0, 0.0
        self._states: dict[tuple, _DecodeState] = {}
        self._pool = None  # the graphs' shared memory pool
        self._capture_stream: Optional[torch.cuda.Stream] = None
        # the tensor group's collectives are captured only where NCCL runs them on the card
        tg = tensor_group_of(model)
        self.graphable = tg is None or tg.backend == "nccl"
        if tg is not None and self.device.type == "cuda":
            print(f"DecodeEngine: tensor axis of {tg.size} on {tg.backend}: "
                  + ("CUDA graphs capture its all-reduces" if self.graphable
                     else "eager steps (gloo's collectives run on the host and cannot be captured)"), flush=True)

    @torch.inference_mode()
    def encode_with_cond(self, frames, cond: Optional[dict] = None) -> torch.Tensor:
        """Audio windows (B, n_samples) -> encoder states on the device.
        ``cond`` holds the window conditions the Processor builds
        (``beatmap_idx``, ``difficulty``, ``mapper_idx``, ``song_position``,
        one row a window), which go to the device as int64 ids and fp32
        values; the model uses those its config embeds. The JAX engine pads
        the batch to a power of two for its compile cache; no row depends on
        another, so the port encodes the rows it is given."""
        frames = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        cond = {k: torch.as_tensor(np.asarray(v, np.int64 if k in COND_IDS else np.float32), device=self.device)
                for k, v in (cond or {}).items()}
        return self.model.encode(frames, **cond)

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
        buffer, right-padded with pad, and the position at which the JAX loop
        stops: the first step after which every row had finished, else
        ``max_length``. A list passed as ``step_logits`` receives the
        processed scores of each step up to there. A model with a learned
        position table stops the loop at its end (:meth:`_cap`)."""
        max_length = self._cap(max_length or self.max_length)
        B, P_orig = decoder_input_ids.shape
        if P_orig >= max_length:
            raise ValueError(f"prompt length {P_orig} >= max_length {max_length}")
        if decoder_attention_mask is None:
            decoder_attention_mask = decoder_input_ids != self.pad_token_id
        use_cfg = cfg_scale > 1.0
        state = self._state(B, max_length, encoder_states)
        chain = state.chain(B // 2 if use_cfg else B)
        self._start(state, chain, encoder_states, decoder_input_ids, decoder_attention_mask, eos_ids)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        graphs = state.graphs.setdefault((pipeline, cfg_scale), {})
        graphed = self.use_graphs and self.device.type == "cuda" and self.graphable
        bucket = self.model.cfg.backbone.decode_attend_bucket
        first_logits = len(step_logits) if step_logits is not None else 0
        cur_len = P_orig  # the host's count of the device's write position
        while cur_len < max_length:
            if pipeline.do_sample and (cur_len - P_orig) % NOISE_BLOCK == 0:
                for row in chain.noise:  # one draw a step, as torch.multinomial draws it
                    row.exponential_(generator=gen)
            limit = decode_read_limit(bucket, cur_len - 1, max_length)
            if graphed:
                self._replay(graphs, limit, state, chain, pipeline, cfg_scale)
            else:
                self._step(state, chain, pipeline, cfg_scale, limit)
            cur_len += 1
            if step_logits is not None:
                step_logits.append(chain.scores.clone())
            if (cur_len - P_orig) % self.sync_every == 0 and cur_len < max_length \
                    and state.read_stop() < max_length:
                break
        end = state.read_stop()
        if step_logits is not None:
            del step_logits[first_logits + end - P_orig:]
        return state.tokens.cpu().numpy(), end

    def _cap(self, max_length: int) -> int:
        """``max_length`` within a learned position table's reach. A step
        feeds the token at slot ``cur_len - 1`` at its logical position, at
        most ``max_length - 2``, so a table of N rows serves a buffer of
        N + 1 slots; one position past it would be an out-of-range lookup,
        which JAX's gather fills with NaN and a CUDA gather asserts on.
        RoPE models have no table and keep ``max_length``."""
        table = self.model.transformer.position_table
        return max_length if table is None else min(max_length, table + 1)

    def _state(self, batch: int, max_length: int, encoder_states: torch.Tensor) -> _DecodeState:
        key = (batch, max_length, tuple(encoder_states.shape[1:]), encoder_states.dtype)
        state = self._states.get(key)
        if state is None:
            state = self._states[key] = _DecodeState(self.model, batch, max_length, encoder_states,
                                                     self.pad_token_id)
        return state

    def _start(self, s: _DecodeState, chain: _Chain, encoder_states, decoder_input_ids, decoder_attention_mask,
               eos_ids) -> None:
        """Prefill ``s`` for a new decode: the window's cross k/v, the prompt
        right-padded to its bucket and written at slot 0, and the loop's
        state at the prompt's end."""
        dev, pad_id = self.device, self.pad_token_id
        B, P_orig = decoder_input_ids.shape
        max_length = s.tokens.shape[1]
        P = min(_bucket(P_orig), max_length)
        ids = torch.full((B, P), pad_id, dtype=torch.long, device=dev)
        ids[:, :P_orig] = torch.as_tensor(np.asarray(decoder_input_ids), device=dev)
        mask = torch.zeros((B, P), dtype=torch.bool, device=dev)
        mask[:, :P_orig] = torch.as_tensor(np.asarray(decoder_attention_mask, bool), device=dev)
        for layer, cross in zip(s.cache, self.model.cross_cache(encoder_states)):
            for name, x in cross.items():
                layer["cross"][name].copy_(x)
        s.attn.zero_()
        s.attn[:, :P] = mask
        # the prompt's slots keep their pad-free rank (pads clamp to 0 and are
        # masked), each generated slot follows its row's logical length: the
        # JAX prefill's and decode loop's k_positions
        rank = (torch.cumsum(s.attn.long(), dim=1) - 1).clamp(min=0)
        n_valid, _ = self._write_prompt(s.cache, s.attn, ids, mask, rank)
        slot = torch.arange(max_length, device=dev)[None]
        s.k_positions.copy_(torch.where(slot < P_orig, rank, n_valid[:, None] + slot - P_orig))
        s.n_valid.copy_(n_valid)
        s.tokens.fill_(pad_id)
        s.tokens[:, :P] = ids
        s.cur_len.fill_(P_orig)
        s.start.fill_(P_orig)
        s.finished.zero_()
        s.stop.fill_(max_length)
        s.eos_mask.zero_()
        s.eos_mask[torch.as_tensor(list(eos_ids), dtype=torch.long, device=dev)] = True
        chain.state.last_time_shift.fill_(-1)
        chain.state.last_token.fill_(-1)
        chain.state.last_scores.zero_()

    def _step(self, s: _DecodeState, chain: _Chain, pipeline: LogitsPipeline, cfg_scale: float,
              limit: int) -> None:
        """One token for every row, on the device alone: the last token by
        the device's write position, the cached decoder step reading the
        cache's first ``limit`` slots, the CFG fold, the logits chain, the
        sample; then the token, its mask slot, ``finished``, the stop
        position (the first time every row has finished) and the write
        position, all written in place."""
        model, pad_id = self.model, self.pad_token_id
        use_cfg = cfg_scale > 1.0
        half = chain.scores.shape[0]
        index = s.cur_len - 1
        last = s.tokens.index_select(1, index.view(1))
        logits, _ = model.decode_step(model.embed_tokens(last), s.cache, index, self_mask=s.attn[:, None, None, :],
                                      positions=(s.n_valid - 1)[:, None], limit=limit, k_positions=s.k_positions)
        scores = logits[:, -1].float()
        if use_cfg:
            neg, pos = scores[:half], scores[half:]
            scores = pos + (neg - pos) * cfg_scale
        lstate, scores = pipeline(chain.state, scores)
        chain.scores.copy_(scores)
        if pipeline.do_sample:
            noise = chain.noise.index_select(0, torch.remainder(s.cur_len - s.start, NOISE_BLOCK).view(1))[0]
            sampled = (torch.softmax(scores, dim=-1) / noise).argmax(dim=-1)
        else:
            sampled = scores.argmax(dim=-1)
        for dst, src in zip(chain.state, pipeline.update_state(lstate, sampled)):
            dst.copy_(src)
        if use_cfg:
            sampled = torch.cat([sampled, sampled])
        sampled = torch.where(s.finished, pad_id, sampled)
        hit_eos = s.eos_mask[sampled[:half]]
        finished = s.finished | (torch.cat([hit_eos, hit_eos]) if use_cfg else hit_eos)
        s.stop.copy_(torch.where(finished.all() & ~s.finished.all(), s.cur_len + 1, s.stop))
        s.finished.copy_(finished)
        s.tokens.index_copy_(1, s.cur_len.view(1), sampled[:, None])
        s.attn.index_fill_(1, s.cur_len.view(1), True)
        s.cur_len.add_(1)
        s.n_valid.add_(1)

    def _replay(self, graphs: dict, limit: int, s: _DecodeState, chain: _Chain, pipeline: LogitsPipeline,
                cfg_scale: float) -> None:
        """Replay the step's graph for the bucket that ends at ``limit``. On
        its first step the bucket's step runs eagerly on the capture stream
        (the capture's warm-up), then is captured; a capture that fails
        raises."""
        entry = graphs.get(limit)
        if entry is not None:
            entry[0].replay()
            return
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(self.device)
        stream, current = self._capture_stream, torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._step(s, chain, pipeline, cfg_scale, limit)
        current.wait_stream(stream)
        t0 = time.perf_counter()
        graph = launches.Graph()
        graph.capture(lambda: self._step(s, chain, pipeline, cfg_scale, limit), pool=self._pool, stream=stream)
        self.capture_seconds += time.perf_counter() - t0
        self.captures += 1
        graphs[limit] = (graph, pipeline)  # the graph reads this pipeline's constants

    @torch.inference_mode()
    def precompile(self, encoder_states: torch.Tensor, max_length: Optional[int] = None,
                   max_prompt: Optional[int] = None) -> None:
        """Serving warm-up, the JAX ``precompile``: allocate the static
        buffers for the batch shape of ``encoder_states`` and run the prefill
        of every prompt bucket once (64, 128, ... up to ``max_prompt`` or
        ``max_length``). The decode step's graphs are captured by the first
        :meth:`generate` that reaches each bucket, for its pipeline."""
        max_length = max_length or self.max_length
        limit = min(max_prompt or max_length, max_length)
        B = encoder_states.shape[0]
        s = self._state(B, max_length, encoder_states)
        p = 64
        while True:
            P = min(p, limit)
            ids = torch.full((B, P), self.pad_token_id, dtype=torch.long, device=self.device)
            mask = torch.zeros((B, P), dtype=torch.bool, device=self.device)
            mask[:, 0] = True
            s.attn.zero_()
            self._write_prompt(s.cache, s.attn, ids, mask)
            if p >= limit:
                break
            p *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _teacher_forced(self, encoder_states, decoder_input_ids, decoder_attention_mask, cfg_scale):
        """The JAX ``forward`` padding, then the model: T right-padded to its
        power-of-two bucket (within ``max_target_positions``), rows padded per
        CFG half by repeating the half's last row. Returns (fp32 logits of the
        padded batch, padded ids, rows per half, padded rows per half)."""
        B, T = decoder_input_ids.shape
        if decoder_attention_mask is None:
            decoder_attention_mask = decoder_input_ids != self.pad_token_id
        dev = self.device
        ids = torch.as_tensor(np.asarray(decoder_input_ids), dtype=torch.long, device=dev)
        mask = torch.as_tensor(np.asarray(decoder_attention_mask, bool), device=dev)
        enc = encoder_states
        table = self.model.transformer.position_table
        if table is not None and T > table:
            raise ValueError(f"{T} tokens: the model's position table has {table} rows")
        Tb = _bucket(T)
        limit = self.model.cfg.max_target_positions  # padded positions are looked up too
        limit = limit if table is None else min(limit, table)
        if Tb > limit:
            Tb = limit if limit >= T else T
        if Tb != T:
            ids = torch.nn.functional.pad(ids, (0, Tb - T), value=self.pad_token_id)
            mask = torch.nn.functional.pad(mask, (0, Tb - T), value=False)
        halves = 2 if cfg_scale > 1.0 else 1
        H = B // halves
        Hb = _row_bucket(H)
        if Hb != H:
            def pad_rows(x):
                return torch.cat([torch.cat([p, p[-1:].expand(Hb - H, *p.shape[1:])])
                                  for p in x.chunk(halves)])
            ids, mask, enc = pad_rows(ids), pad_rows(mask), pad_rows(enc)
        logits = self.model(decoder_input_ids=ids, decoder_attention_mask=mask, encoder_states=enc)
        return logits.float(), ids, H, Hb

    @torch.inference_mode()
    def forward(self, encoder_states, decoder_input_ids: np.ndarray,
                decoder_attention_mask: Optional[np.ndarray] = None, cfg_scale: float = 1.0) -> np.ndarray:
        """Teacher-forced forward -> fp32 logits (B, T, V) on the host. With
        ``cfg_scale > 1`` the rows are the folded ``[negative; positive]``
        batch, folded here, and B halves on return."""
        T = decoder_input_ids.shape[1]
        logits, _, H, Hb = self._teacher_forced(encoder_states, decoder_input_ids, decoder_attention_mask,
                                                cfg_scale)
        if cfg_scale > 1.0:
            neg, pos = logits[:Hb][:H], logits[Hb:][:H]
            logits = pos + (neg - pos) * cfg_scale
        else:
            logits = logits[:H]
        return logits[:, :T].cpu().numpy()

    @torch.inference_mode()
    def forward_stats(self, encoder_states, decoder_input_ids: np.ndarray,
                      decoder_attention_mask: Optional[np.ndarray] = None,
                      cfg_scale: float = 1.0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Teacher-forced analysis statistics, reduced on the device:
        ``(surprisal_bits, entropy_bits, argmax_ids)``, each (B, T), after the
        same CFG fold as :meth:`forward` and with its ``+1e-10`` guards.
        ``surprisal_bits[p]`` scores the next prompt token ``ids[p + 1]`` (of
        the positive half under CFG), NaN where that token is outside the
        output vocabulary (a context token), as the JAX gather gives; only the
        three arrays reach the host."""
        T = decoder_input_ids.shape[1]
        logits, ids, H, Hb = self._teacher_forced(encoder_states, decoder_input_ids, decoder_attention_mask,
                                                  cfg_scale)
        if cfg_scale > 1.0:
            neg, pos = logits.chunk(2)
            logits = pos + (neg - pos) * cfg_scale
            ids = ids.chunk(2)[1]
        probs = torch.softmax(logits, dim=-1)
        entropy = -(probs * torch.log2(probs + 1e-10)).sum(-1)
        targets = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], self.pad_token_id)], dim=1)
        in_vocab = (targets >= 0) & (targets < probs.shape[-1])
        p_target = probs.gather(-1, torch.where(in_vocab, targets, 0)[..., None])[..., 0]
        p_target = torch.where(in_vocab, p_target, float("nan"))
        surprisal = -torch.log(p_target + 1e-10) / float(np.log(2.0))
        argmax = logits.argmax(-1).to(torch.int32)
        return tuple(x[:H, :T].cpu().numpy() for x in (surprisal, entropy, argmax))

    def _prefill(self, encoder_states, ids, mask, buffer_len: int):
        """A new cache of ``buffer_len`` slots holding the left-padded prompt
        (B, P) (:meth:`_write_prompt`). Returns (cache, attention mask over
        the buffer, each slot's logical position, logical lengths, the
        prompt's logits). A slot's position is its index less the row's
        pads, clamped at 0: the JAX ``k_positions`` of the stepwise paths
        (``generate_forced``, ``generate_beams``), fixed for the decode."""
        B, P = ids.shape
        cache = self.model.init_cache(B, buffer_len, encoder_states)
        attn = torch.zeros((B, buffer_len), dtype=torch.bool, device=self.device)
        pads = P - mask.sum(dim=1)
        k_positions = (torch.arange(buffer_len, device=self.device)[None] - pads[:, None]).clamp(min=0)
        return cache, attn, k_positions, *self._write_prompt(cache, attn, ids, mask, k_positions)

    def _write_prompt(self, cache, attn, ids, mask, k_positions=None):
        """Write the prompt (B, P) into ``cache`` in one chunk at slot 0, at
        logical positions that skip its pads, and its mask into ``attn``.
        ``k_positions`` (B, buffer slots) are the slots' logical positions
        (default: the pad-free rank over ``attn``, the JAX prefill's).
        Returns (logical lengths, the prompt's logits)."""
        model = self.model
        attn[:, :ids.shape[1]] = mask
        positions = (torch.cumsum(mask.long(), dim=1) - 1).clamp(min=0)
        if k_positions is None:
            k_positions = (torch.cumsum(attn.long(), dim=1) - 1).clamp(min=0)
        logits, _ = model.decode_step(model.embed_tokens(ids), cache, 0, self_mask=attn[:, None, None, :],
                                      positions=positions, k_positions=k_positions)
        return mask.sum(dim=1), logits

    @torch.inference_mode()
    def generate_forced(self, encoder_states, decoder_input_ids: np.ndarray, pipeline: LogitsPipeline,
                        forced_tokens: np.ndarray, decoder_attention_mask: Optional[np.ndarray] = None,
                        cfg_scale: float = 1.0) -> np.ndarray:
        """The stepwise path of :meth:`generate` (prefill, one cached step a
        token, the logits chain with its state), taking each step's token from
        ``forced_tokens`` (B or, under CFG, B // 2 rows of T tokens) instead of
        the sampler. Returns the fp32 processed scores (B, T, V) the sampler
        would have drawn from."""
        model, dev = self.model, self.device
        forced = torch.as_tensor(np.asarray(forced_tokens), dtype=torch.long, device=dev)
        B, P = decoder_input_ids.shape
        T = forced.shape[1]
        use_cfg = cfg_scale > 1.0
        half = B // 2 if use_cfg else B
        if decoder_attention_mask is None:
            decoder_attention_mask = decoder_input_ids != self.pad_token_id
        ids = torch.as_tensor(np.asarray(decoder_input_ids), dtype=torch.long, device=dev)
        mask = torch.as_tensor(np.asarray(decoder_attention_mask, bool), device=dev)
        if self._cap(P + T) < P + T:
            raise ValueError(f"{P} prompt and {T} forced tokens: past the model's position table")
        cache, attn, k_positions, n_valid, logits = self._prefill(encoder_states, ids, mask, P + T)
        last = logits[:, -1].float()
        lstate = pipeline.init_state(half, dev)
        scores_all = []
        for t in range(T):
            if use_cfg:
                neg, pos = last[:half], last[half:]
                last = pos + (neg - pos) * cfg_scale
            lstate, scores = pipeline(lstate, last)
            scores_all.append(scores)
            if t == T - 1:  # the step after the last token would feed no score
                break
            lstate = pipeline.update_state(lstate, forced[:, t])
            written = torch.cat([forced[:, t], forced[:, t]]) if use_cfg else forced[:, t]
            attn[:, P + t] = True
            logits, _ = model.decode_step(model.embed_tokens(written[:, None]), cache, P + t,
                                          self_mask=attn[:, None, None, :], positions=n_valid[:, None],
                                          k_positions=k_positions)
            n_valid = n_valid + 1
            last = logits[:, -1].float()
        return torch.stack(scores_all, dim=1).cpu().numpy()

    @torch.inference_mode()
    def generate_beams(
        self,
        encoder_states: torch.Tensor,
        decoder_input_ids: np.ndarray,
        pipeline: LogitsPipeline,
        eos_ids: list[int],
        num_beams: int,
        decoder_attention_mask: Optional[np.ndarray] = None,
        max_length: Optional[int] = None,
        length_penalty: float = 1.0,
        seed: int = 0,
        cfg_scale: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray]:
        """HF-style beam search (``early_stopping=False``) over N = ``num_beams``
        beams a row, from a left-padded prompt (B, P) that is left-padded
        further to its power-of-two bucket. Each step takes the top 2N
        candidates of the beams' summed log-probabilities (the logits chain
        runs on the log-softmax, after the CFG fold); candidates ending in EOS
        retire into a finished set, scored by sum / length ** length_penalty,
        and the N best others continue, reordering the KV cache and the chain's
        state. With a sampling pipeline the 2N candidates are drawn without
        replacement (Gumbel top-k, the noise from a ``torch.Generator`` seeded
        with ``seed``). Under CFG the rows are ``[negative; positive]`` and,
        as in the reference, both halves' caches are reordered from the
        negative half's rows. Returns the best hypothesis per row, right-padded
        to P + max_length, and its logical length."""
        model, dev, pad_id = self.model, self.device, self.pad_token_id
        max_length = self._cap(max_length or self.max_length)
        use_cfg = cfg_scale > 1.0
        B_rows, P_orig = decoder_input_ids.shape
        if use_cfg and B_rows % 2:
            raise ValueError("the CFG fold needs an even row count")
        if P_orig >= max_length:
            raise ValueError(f"prompt length {P_orig} >= max_length {max_length}")
        B = B_rows // 2 if use_cfg else B_rows
        N = num_beams
        BN = B * N
        if decoder_attention_mask is None:
            decoder_attention_mask = decoder_input_ids != pad_id
        P = _bucket(P_orig)
        ids = torch.full((B_rows, P), pad_id, dtype=torch.long, device=dev)
        ids[:, P - P_orig:] = torch.as_tensor(np.asarray(decoder_input_ids), device=dev)
        mask = torch.zeros((B_rows, P), dtype=torch.bool, device=dev)
        mask[:, P - P_orig:] = torch.as_tensor(np.asarray(decoder_attention_mask, bool), device=dev)
        gen_limit = max_length - P_orig
        buffer_len = P + max_length
        eos_mask = torch.zeros(pipeline.vocab_size, dtype=torch.bool, device=dev)
        eos_mask[list(eos_ids)] = True
        V = pipeline.vocab_size

        def expand(x):  # (B | 2B, ...) -> (BN | 2BN, ...), each row N times within its half
            return torch.cat([half.repeat_interleave(N, dim=0) for half in x.chunk(2 if use_cfg else 1)])

        def fold(step_logits):  # HF beam order: log-softmax first, then the CFG fold
            logp = torch.log_softmax(step_logits, dim=-1)
            if use_cfg:
                neg, pos = logp.chunk(2)
                return pos + (neg - pos) * cfg_scale
            return logp

        ids_bn, mask_bn = expand(ids), expand(mask)
        cache, attn, k_positions, n_valid, logits = self._prefill(expand(encoder_states), ids_bn, mask_bn,
                                                                  buffer_len)
        tokens = torch.full((ids_bn.shape[0], buffer_len), pad_id, dtype=torch.long, device=dev)
        tokens[:, :P] = ids_bn
        lstate = pipeline.init_state(BN, dev)
        beam_scores = torch.full((B, N), NEG, device=dev)
        beam_scores[:, 0] = 0.0
        fin_scores = torch.full((B, N), NEG, device=dev)
        fin_tokens = torch.full((B, N, buffer_len), pad_id, dtype=torch.long, device=dev)
        fin_lengths = torch.zeros((B, N), dtype=torch.long, device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tiny = torch.finfo(torch.float32).tiny
        step_logits = fold(logits[:, -1].float())
        cur_len = P
        while True:
            gen_len = float(max(cur_len - P, 1))
            lstate, logp = pipeline(lstate, step_logits)
            cand = (beam_scores[:, :, None] + logp.view(B, N, V)).view(B, N * V)
            if pipeline.do_sample:
                u = torch.rand(cand.shape, generator=gen, device=dev).clamp(min=tiny)
                _, top_idx = _top_k(cand - torch.log(-torch.log(u)), 2 * N)
                top_vals = cand.gather(1, top_idx)
            else:
                top_vals, top_idx = _top_k(cand, 2 * N)
            beam_idx, token_ids = top_idx // V, top_idx % V
            is_eos = eos_mask[token_ids]

            # candidates that end in EOS retire into the finished set
            cand_fin = torch.where(is_eos, top_vals / gen_len ** length_penalty, NEG)
            live_rows = (tokens[BN:] if use_cfg else tokens).view(B, N, buffer_len)
            cand_rows = live_rows.gather(1, beam_idx[:, :, None].expand(B, 2 * N, buffer_len)).clone()
            cand_rows[:, :, cur_len] = token_ids
            live_nv = (n_valid[BN:] if use_cfg else n_valid).view(B, N)
            all_scores = torch.cat([fin_scores, cand_fin], dim=1)
            fin_scores, keep = _top_k(all_scores, N)
            fin_tokens = torch.cat([fin_tokens, cand_rows], dim=1).gather(
                1, keep[:, :, None].expand(B, N, buffer_len))
            fin_lengths = torch.cat([fin_lengths, live_nv.gather(1, beam_idx) + 1], dim=1).gather(1, keep)

            # the N best other candidates continue
            beam_scores, sel = _top_k(torch.where(is_eos, NEG, top_vals), N)
            sel_tok = token_ids.gather(1, sel).reshape(BN)
            global_idx = (torch.arange(B, device=dev)[:, None] * N + beam_idx.gather(1, sel)).reshape(BN)
            row_idx = torch.cat([global_idx, global_idx + BN]) if use_cfg else global_idx
            tokens, attn, n_valid = tokens[row_idx], attn[row_idx], n_valid[row_idx] + 1
            tokens[:, cur_len] = torch.cat([sel_tok, sel_tok]) if use_cfg else sel_tok
            attn[:, cur_len] = True
            # the reference reorders both halves' caches with beam_idx.repeat(2)
            # (cache_utils.py:16-20): from the second step on, both halves
            # decode over the negative prompt's KV history
            cache_idx = torch.cat([global_idx, global_idx]) if use_cfg else global_idx
            for layer in cache:
                for part in layer.values():
                    for key in part:
                        part[key] = part[key][cache_idx]
            lstate = pipeline.update_state(type(lstate)(*(
                x[global_idx] if x.dim() >= 1 and x.shape[0] == BN else x for x in lstate)), sel_tok)
            cur_len += 1

            # HF early_stopping=False: a row is done once its worst finished
            # hypothesis beats the best score a live beam can still reach
            best_reachable = beam_scores.max(dim=1).values / float(max(cur_len - P, 1)) ** length_penalty
            if cur_len >= P + gen_limit or bool((fin_scores.min(dim=1).values >= best_reachable).all()):
                break
            last = tokens[:, cur_len - 1:cur_len]
            logits, _ = model.decode_step(model.embed_tokens(last), cache, cur_len - 1,
                                          self_mask=attn[:, None, None, :], positions=(n_valid - 1)[:, None],
                                          k_positions=k_positions)
            step_logits = fold(logits[:, -1].float())

        # live beams compete with the finished hypotheses
        live_norm = beam_scores / float(max(cur_len - P, 1)) ** length_penalty
        merged_scores = torch.cat([fin_scores, live_norm], dim=1)
        live_rows = (tokens[BN:] if use_cfg else tokens).view(B, N, buffer_len)
        merged_tokens = torch.cat([fin_tokens, live_rows], dim=1)
        merged_lengths = torch.cat([fin_lengths, (n_valid[BN:] if use_cfg else n_valid).view(B, N)], dim=1)
        best = merged_scores.argmax(dim=1)
        out_tokens = merged_tokens[torch.arange(B, device=dev), best]
        out_lengths = merged_lengths.gather(1, best[:, None])[:, 0]
        return out_tokens.cpu().numpy(), out_lengths.cpu().numpy()
