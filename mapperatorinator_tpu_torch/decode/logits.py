"""The logits processor chain (``decode/logits.py``), in PyTorch.

Order and semantics of the JAX pipeline (HF order, as in the reference):

    CFG -> MonotonicTimeShift -> TimeshiftBias -> (Conditional)Temperature
        -> LookbackBias -> TopK -> TopP

CFG is folded by the engine before the chain. The per-row state (last time
shift, last token, last raw scores) is carried between steps instead of
re-scanning the emitted ids.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..osu.events import EventType
from ..osu.streams import TIMED_EVENTS
from ..osu.vocab import MILLISECONDS_PER_STEP, Vocabulary


class LogitsState(NamedTuple):
    last_time_shift: torch.Tensor  # (B,) int32, -1 if none yet
    last_token: torch.Tensor  # (B,) int32, -1 at start
    last_scores: torch.Tensor  # (B, V) fp32 raw scores of the previous step


@dataclasses.dataclass(frozen=True)
class LogitsPipeline:
    vocab_size: int
    time_start: int
    time_end: int  # exclusive
    sos_ids: tuple[int, ...]
    eos_ids: tuple[int, ...]
    cfg_scale: float = 1.0
    timeshift_bias: float = 0.0
    temperature: float = 1.0
    types_first: bool = False
    timing_temperature: float = 1.0
    mania_column_temperature: float = 1.0
    taiko_hit_temperature: float = 1.0
    beat_type_tokens: tuple[int, ...] = ()
    mania_type_tokens: tuple[int, ...] = ()
    scroll_speed_tokens: tuple[int, ...] = ()
    lookback_max_time: float = 0.0
    timed_token_mask: Optional[tuple] = None
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = True

    def init_state(self, batch: int, device) -> LogitsState:
        return LogitsState(
            last_time_shift=torch.full((batch,), -1, dtype=torch.int32, device=device),
            last_token=torch.full((batch,), -1, dtype=torch.int32, device=device),
            last_scores=torch.zeros((batch, self.vocab_size), dtype=torch.float32, device=device),
        )

    def __call__(self, state: LogitsState, scores: torch.Tensor) -> tuple[LogitsState, torch.Tensor]:
        """scores: (B, V) fp32 raw logits, CFG already folded. Returns
        (state, processed scores); the sampled token enters the state in
        :meth:`update_state`."""
        raw = scores
        scores = self._monotonic_time_shift(state, scores)
        if self.timeshift_bias != 0.0:
            scores = scores.clone()
            scores[:, self.time_start:self.time_end] += self.timeshift_bias
        scores = self._temperature(state, scores)
        if self.lookback_max_time > 0:
            scores = self._lookback_bias(state, scores)
        state = state._replace(last_scores=raw)
        if self.do_sample:
            if self.top_k > 0:
                scores = top_k_filter(scores, self.top_k)
            if self.top_p < 1.0:
                scores = top_p_filter(scores, self.top_p)
        return state, scores

    def update_state(self, state: LogitsState, token: torch.Tensor) -> LogitsState:
        is_ts = (token >= self.time_start) & (token < self.time_end)
        is_sos = torch.zeros_like(is_ts)
        for sid in self.sos_ids:
            is_sos = is_sos | (token == sid)
        last_ts = torch.where(is_ts, token - self.time_start, state.last_time_shift)
        last_ts = torch.where(is_sos, -1, last_ts)  # SOS resets monotonicity
        return state._replace(last_time_shift=last_ts.to(torch.int32), last_token=token.to(torch.int32))

    def _monotonic_time_shift(self, state: LogitsState, scores: torch.Tensor) -> torch.Tensor:
        """Mask time shifts earlier than the last emitted one."""
        ts = torch.arange(self.time_start, self.time_end, device=scores.device)
        invalid = ts[None, :] < (self.time_start + state.last_time_shift)[:, None]
        invalid = invalid & (state.last_time_shift >= 0)[:, None]
        mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
        mask[:, self.time_start:self.time_end] = invalid
        return torch.where(mask, -torch.inf, scores)

    def _temperature(self, state: LogitsState, scores: torch.Tensor) -> torch.Tensor:
        if not self.types_first:
            return scores / self.temperature
        # keyed on the previous token of the FIRST row, for the whole batch
        # (as the reference's processor reads input_ids[0])
        temp = torch.tensor(self.temperature, dtype=torch.float32, device=scores.device)
        prev = state.last_token[0]
        for t, tokens in self._conditionals():
            hit = torch.zeros((), dtype=torch.bool, device=scores.device)
            for tok in tokens:
                hit = hit | (prev == tok)
            temp = torch.where(hit, torch.tensor(t, dtype=torch.float32, device=scores.device), temp)
        return scores / temp

    def _conditionals(self):
        # the reference returns on the first matching conditional; applying
        # them in reverse lets the first one overwrite the later ones
        conds = []
        if self.timing_temperature != self.temperature and self.beat_type_tokens:
            conds.append((self.timing_temperature, self.beat_type_tokens))
        if self.mania_column_temperature != self.temperature and self.mania_type_tokens:
            conds.append((self.mania_column_temperature, self.mania_type_tokens))
        if self.taiko_hit_temperature != self.temperature and self.scroll_speed_tokens:
            conds.append((self.taiko_hit_temperature, self.scroll_speed_tokens))
        return reversed(conds)

    def _lookback_bias(self, state: LogitsState, scores: torch.Tensor) -> torch.Tensor:
        """Move the lookback-window token mass into EOS."""
        device = scores.device
        lb_start = self.time_start
        lb_end = self.time_start + int(self.lookback_max_time / MILLISECONDS_PER_STEP)
        lb_mask = torch.zeros(self.vocab_size, dtype=torch.bool, device=device)
        lb_mask[lb_start:lb_end] = True
        if not self.types_first:
            return torch.where(lb_mask[None, :], -torch.inf, scores)

        timed = torch.tensor(self.timed_token_mask, dtype=torch.bool, device=device)
        last = state.last_token.long()
        last_timed = timed[last.clamp(0, self.vocab_size - 1)] & (last >= 0)
        last_probs = torch.softmax(state.last_scores, dim=-1)
        probs = torch.softmax(scores, dim=-1)
        eos_mask = torch.zeros(self.vocab_size, dtype=torch.bool, device=device)
        eos_mask[list(self.eos_ids)] = True
        prob_eos = (last_probs * eos_mask[None, :]).sum(-1)
        prob_event = 1 - prob_eos
        other = ~lb_mask
        s = 1 / ((probs * other[None, :]).sum(-1) * prob_event + prob_eos)
        probs = torch.where(lb_mask[None, :], 0.0, probs)
        probs = torch.where(other[None, :], probs * s[:, None], probs)
        probs[:, lb_start] = ((s - 1) * prob_eos / prob_event).clamp(0, 1)
        return torch.where(last_timed[:, None], torch.log(probs), scores)


def top_k_filter(scores: torch.Tensor, k: int) -> torch.Tensor:
    kth = torch.topk(scores, k, dim=-1).values[:, -1:]
    return torch.where(scores < kth, -torch.inf, scores)


def top_p_filter(scores: torch.Tensor, top_p: float, min_tokens_to_keep: int = 1) -> torch.Tensor:
    """HF TopPLogitsWarper: sort ascending, cumulative softmax, drop the
    tokens whose cumulative probability is <= 1 - top_p."""
    sorted_logits = torch.sort(scores, dim=-1).values
    cumulative = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    sorted_remove = cumulative <= (1 - top_p)
    if min_tokens_to_keep > 0:
        sorted_remove[:, -min_tokens_to_keep:] = False
    keep_from = sorted_remove.sum(-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, keep_from)
    return torch.where(scores < cutoff, -torch.inf, scores)


def build_logits_pipeline(
    vocab: Vocabulary,
    *,
    cfg_scale: float = 1.0,
    timeshift_bias: float = 0.0,
    temperature: float = 1.0,
    timing_temperature: Optional[float] = None,
    mania_column_temperature: Optional[float] = None,
    taiko_hit_temperature: Optional[float] = None,
    types_first: bool = False,
    lookback_max_time: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    do_sample: bool = True,
) -> LogitsPipeline:
    ts_start = vocab.event_start[EventType.TIME_SHIFT]
    ts_end = vocab.event_end[EventType.TIME_SHIFT]

    beat_tokens = [vocab.event_start[EventType.BEAT], vocab.event_start[EventType.MEASURE]]
    if EventType.TIMING_POINT in vocab.event_start:
        beat_tokens.append(vocab.event_start[EventType.TIMING_POINT])
    mania_tokens = (
        [vocab.event_start[EventType.CIRCLE], vocab.event_start[EventType.HOLD_NOTE],
         vocab.event_start[EventType.HOLD_NOTE_END]]
        if EventType.HOLD_NOTE_END in vocab.event_start
        else []
    )
    scroll_tokens = (
        list(range(vocab.event_start[EventType.SCROLL_SPEED], vocab.event_end[EventType.SCROLL_SPEED]))
        if EventType.SCROLL_SPEED in vocab.event_start
        else []
    )
    timed_mask = [False] * vocab.vocab_size_out
    for event_type in TIMED_EVENTS:
        if event_type in vocab.event_start:
            for tid in range(vocab.event_start[event_type], min(vocab.event_end[event_type], vocab.vocab_size_out)):
                timed_mask[tid] = True

    return LogitsPipeline(
        vocab_size=vocab.vocab_size_out,
        time_start=ts_start,
        time_end=ts_end,
        sos_ids=tuple([vocab.sos_id] + list(vocab.context_sos.values())),
        eos_ids=tuple([vocab.eos_id] + list(vocab.context_eos.values())),
        cfg_scale=cfg_scale,
        timeshift_bias=timeshift_bias,
        temperature=temperature,
        types_first=types_first,
        timing_temperature=timing_temperature if timing_temperature is not None else temperature,
        mania_column_temperature=mania_column_temperature if mania_column_temperature is not None else temperature,
        taiko_hit_temperature=taiko_hit_temperature if taiko_hit_temperature is not None else temperature,
        beat_type_tokens=tuple(beat_tokens),
        mania_type_tokens=tuple(mania_tokens),
        scroll_speed_tokens=tuple(scroll_tokens),
        lookback_max_time=lookback_max_time,
        timed_token_mask=tuple(timed_mask),
        top_k=top_k,
        top_p=top_p,
        do_sample=do_sample,
    )


def get_eos_token_ids(vocab: Vocabulary, lookback_time: float = 0, lookahead_time: float = 0,
                      context_type=None) -> list[int]:
    """Multi-EOS set: base EOS, the context's EOS, and the time shifts inside
    the lookback and lookahead edges of the window."""
    eos = [vocab.eos_id]
    if context_type is not None and context_type in vocab.context_eos:
        eos.append(vocab.context_eos[context_type])
    ts_start = vocab.event_start[EventType.TIME_SHIFT]
    ts_end = vocab.event_end[EventType.TIME_SHIFT]
    if lookback_time > 0:
        eos.extend(range(ts_start, ts_start + int(lookback_time / MILLISECONDS_PER_STEP)))
    if lookahead_time > 0:
        eos.extend(range(ts_end - int(lookahead_time / MILLISECONDS_PER_STEP), ts_end))
    return eos
