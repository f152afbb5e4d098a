"""Sequence construction: song -> fixed-window training examples.

Torch-free port of the reference's SequenceDatasetMixin (reference:
``osuT5/osuT5/dataset/data_utils.py:366-721``): slices a song into
``src_seq_len - 1`` audio-frame windows, maps events to frames by time,
builds in/out context slices with ``labels_offset`` for the lookback
augmentation, tracks rolling last-kiai/last-SV special state, normalizes
time shifts to window-relative steps, and emits
``decoder_input_ids``/``decoder_attention_mask``/``labels`` with the layout
``[in-contexts][special tokens][pre_tokens][SOS][out-contexts...][EOS]``.
Outputs are numpy arrays ready for host->device batching.
"""

from __future__ import annotations

import random
from typing import Any, Iterable, Optional

import numpy as np

from ...osu.events import ContextType, Event, EventType
from ...osu.vocab import Vocabulary

MILLISECONDS_PER_SECOND = 1000
STEPS_PER_MILLISECOND = 0.1
LABEL_IGNORE_ID = -100


class SequenceProcessor:
    """Stateless-ish converter from parsed songs to training sequences.

    ``data_args`` is the TrainConfig.data node. ``shared`` optionally exposes
    ``current_train_step`` for the add-empty-sequences / pre-tokens curricula.
    """

    def __init__(self, data_args, vocab: Vocabulary, test: bool = False, shared: Any = None):
        self.args = data_args
        self.tokenizer = vocab
        self.test = test
        self.shared = shared
        self.frame_seq_len = data_args.src_seq_len - 1
        self.pre_token_len = data_args.tgt_seq_len // 2
        self.min_pre_token_len = 4
        self.add_pre_tokens = data_args.add_pre_tokens
        self.add_empty_sequences = data_args.add_empty_sequences

    # -- framing -------------------------------------------------------------

    def get_frames(self, samples: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        samples = np.pad(samples, [0, self.args.hop_length - len(samples) % self.args.hop_length])
        frames = np.reshape(samples, (-1, self.args.hop_length))
        frames_per_ms = self.args.sample_rate / self.args.hop_length / MILLISECONDS_PER_SECOND
        frame_times = np.arange(len(frames)) / frames_per_ms
        return frames, frame_times

    # -- windowing -------------------------------------------------------------

    def create_sequences(
        self,
        frames: np.ndarray,
        frame_times: np.ndarray,
        out_context: list[dict],
        in_context: list[dict],
        extra_data: Optional[dict] = None,
    ) -> list[dict]:
        extra_data = {} if extra_data is None else extra_data

        def get_event_indices(events2, event_times2):
            start_indices = []
            event_index = 0
            for current_time in frame_times:
                while event_index < len(events2) and event_times2[event_index] < current_time:
                    event_index += 1
                start_indices.append(event_index)
            end_indices = start_indices[1:] + [start_indices[-1]]
            return start_indices, end_indices

        start_indices, end_indices = {}, {}
        for context in in_context + out_context:
            cid = context["extra"]["id"]
            start_indices[cid], end_indices[cid] = get_event_indices(context["events"], context["event_times"])

        sequences = []
        n_frames = len(frames)
        offset = (
            random.randint(0, min(self.frame_seq_len, 2000))
            if not self.test and random.random() < self.args.frame_offset_augment_prob
            else 0
        )
        gen_start_frame_x = (
            int(round(self.args.lookback * self.frame_seq_len))
            if not self.test and random.random() < self.args.lookback_prob
            else 0
        )
        gen_end_frame_x = int(round((1 - self.args.lookahead) * self.frame_seq_len))
        last_kiai: dict = {}
        last_sv: dict = {}

        for frame_start_idx in range(offset, n_frames - gen_start_frame_x, self.frame_seq_len):
            frame_end_idx = min(frame_start_idx + self.frame_seq_len, n_frames)
            gen_start_frame = min(frame_start_idx + gen_start_frame_x, n_frames - 1)
            gen_end_frame = min(frame_start_idx + gen_end_frame_x, n_frames)
            frame_pre_idx = max(frame_start_idx - self.frame_seq_len, 0)

            def slice_events(context, start_idx, end_idx):
                if len(context["events"]) == 0:
                    return []
                cid = context["extra"]["id"]
                return context["events"][start_indices[cid][start_idx] : end_indices[cid][end_idx - 1]]

            def slice_context(context, start_idx, end_idx):
                result = {"events": slice_events(context, start_idx, end_idx)} | context["extra"]
                result["time"] = frame_times[start_idx]
                cid = context["extra"]["id"]
                result["labels_offset"] = start_indices[cid][gen_start_frame] - start_indices[cid][start_idx]
                return result

            sequence = {
                "frames": frames[frame_start_idx:frame_end_idx],
                "out_context": [slice_context(c, frame_start_idx, gen_end_frame) for c in out_context],
                "in_context": [slice_context(c, frame_start_idx, frame_end_idx) for c in in_context],
                "song_position": np.array([frame_start_idx / n_frames, frame_end_idx / n_frames], np.float32),
            } | extra_data

            sequence["special"] = sequence["special"].copy()
            sequence["special"]["time"] = frame_times[frame_start_idx]

            if out_context and (self.args.add_pre_tokens or self.args.add_pre_tokens_at_step >= 0):
                sequence["pre_events"] = slice_events(out_context[0], frame_pre_idx, frame_start_idx)

            def add_last_kiai(seq_ctx, state):
                if seq_ctx["context_type"] != ContextType.KIAI and not (
                    self.args.add_kiai and seq_ctx["context_type"] in (ContextType.GD, ContextType.MAP)
                ):
                    return
                seq_ctx["last_kiai"] = state.get(seq_ctx["id"], Event(EventType.KIAI, 0))
                for event in reversed(seq_ctx["events"]):
                    if event.type == EventType.KIAI:
                        state[seq_ctx["id"]] = event
                        break

            if self.args.add_kiai_special_token:
                for seq_ctx in sequence["in_context"]:
                    add_last_kiai(seq_ctx, last_kiai)
                for seq_ctx in sequence["out_context"]:
                    add_last_kiai(seq_ctx, last_kiai)
                    if "last_kiai" in seq_ctx:
                        sequence["special"]["last_kiai"] = seq_ctx["last_kiai"]

            def add_last_sv(seq_ctx, state):
                if seq_ctx["context_type"] != ContextType.SV and not (
                    (self.args.add_sv or self.args.add_mania_sv)
                    and seq_ctx["context_type"] in (ContextType.GD, ContextType.MAP)
                ):
                    return
                seq_ctx["last_sv"] = state.get(seq_ctx["id"], Event(EventType.SCROLL_SPEED, 100))
                for event in reversed(seq_ctx["events"]):
                    if event.type == EventType.SCROLL_SPEED:
                        state[seq_ctx["id"]] = event
                        break

            if self.args.add_sv_special_token:
                for seq_ctx in sequence["in_context"]:
                    add_last_sv(seq_ctx, last_sv)
                for seq_ctx in sequence["out_context"]:
                    add_last_sv(seq_ctx, last_sv)
                    if "last_sv" in seq_ctx:
                        sequence["special"]["last_sv"] = seq_ctx["last_sv"]

            sequences.append(sequence)

        return sequences

    # -- normalization + tokenization -------------------------------------------------

    def normalize_time_shifts(self, sequence: dict, beatmap_path=None) -> dict:
        min_t = self.tokenizer.event_range[EventType.TIME_SHIFT].min_value
        max_t = self.tokenizer.event_range[EventType.TIME_SHIFT].max_value

        def process(events, start_time):
            for i, event in enumerate(events):
                if event.type == EventType.TIME_SHIFT:
                    t = int((event.value - start_time) * STEPS_PER_MILLISECOND)
                    if t < min_t or t > max_t:
                        t = int(np.clip(t, min_t, max_t))
                    events[i] = Event(EventType.TIME_SHIFT, t)
            return events

        if "pre_events" in sequence and sequence["out_context"]:
            sequence["pre_events"] = process(sequence["pre_events"], sequence["out_context"][0]["time"])
        for context in sequence["in_context"] + sequence["out_context"]:
            context["events"] = process(context["events"], context["time"])
        return sequence

    def get_special_tokens(self, context: dict) -> list[int]:
        tok = self.tokenizer
        a = self.args
        special_tokens: list[int] = []
        if "beatmap_id" in context:
            r = random.random
            if a.add_gamemode_token:
                special_tokens.append(tok.encode_gamemode(context["gamemode"]))
            if a.add_style_token:
                special_tokens.append(
                    tok.encode_style_idx(context["beatmap_idx"])
                    if self.test or r() >= a.class_dropout_prob
                    else tok.style_unk
                )
            if a.add_diff_token:
                special_tokens.append(
                    tok.encode_diff(context["difficulty"]) if self.test or r() >= a.diff_dropout_prob else tok.diff_unk
                )
            if a.add_mapper_token:
                special_tokens.append(
                    tok.encode_mapper(context["beatmap_id"])
                    if self.test or r() >= a.mapper_dropout_prob
                    else tok.mapper_unk
                )
            if a.add_year_token:
                special_tokens.append(
                    tok.encode_year(context["year"]) if self.test or r() >= a.year_dropout_prob else tok.year_unk
                )
            if a.add_hitsounded_token:
                special_tokens.append(tok.encode(Event(EventType.HITSOUNDED, int(context["hitsounded"]))))
            if a.add_song_length_token:
                special_tokens.append(tok.encode_song_length(context["song_length"]))
            if a.add_global_sv_token and "global_sv" in context:
                special_tokens.append(tok.encode_global_sv(context["global_sv"]))
            if a.add_cs_token and "circle_size" in context:
                special_tokens.append(
                    tok.encode_cs(context["circle_size"]) if self.test or r() >= a.cs_dropout_prob else tok.cs_unk
                )
            if a.add_keycount_token and "keycount" in context:
                special_tokens.append(tok.encode(Event(EventType.MANIA_KEYCOUNT, context["keycount"])))
            if a.add_hold_note_ratio_token and "hold_note_ratio" in context:
                special_tokens.append(
                    tok.encode_hold_note_ratio(context["hold_note_ratio"])
                    if self.test or r() >= a.hold_note_ratio_dropout_prob
                    else tok.hold_note_ratio_unk
                )
            if a.add_scroll_speed_ratio_token and "scroll_speed_ratio" in context:
                special_tokens.append(
                    tok.encode_scroll_speed_ratio(context["scroll_speed_ratio"])
                    if self.test or r() >= a.scroll_speed_ratio_dropout_prob
                    else tok.scroll_speed_ratio_unk
                )
            if a.add_descriptors:
                special_tokens.extend(
                    tok.encode_descriptor(context["beatmap_id"])
                    if self.test or r() >= a.descriptor_dropout_prob
                    else [tok.descriptor_unk]
                )
            if a.add_kiai_special_token and "last_kiai" in context:
                special_tokens.append(tok.encode(context["last_kiai"]))
            if a.add_sv_special_token and "last_sv" in context:
                special_tokens.append(tok.encode(context["last_sv"]))
            if a.add_song_position_token:
                special_tokens.append(tok.encode_song_position(context["time"], context["song_length"]))
        return special_tokens

    def tokenize_sequence(self, sequence: dict) -> dict:
        sequence["special_tokens"] = self.get_special_tokens(sequence["special"])
        for context in sequence["in_context"] + sequence["out_context"]:
            context["tokens"] = np.array([self.tokenizer.encode(e) for e in context["events"]], np.int64)
            context["special_tokens"] = self.get_special_tokens(context)
        if "pre_events" in sequence:
            sequence["pre_tokens"] = np.array([self.tokenizer.encode(e) for e in sequence["pre_events"]], np.int64)
            del sequence["pre_events"]
        return sequence

    def pad_and_split_token_sequence(self, sequence: dict) -> dict:
        tok = self.tokenizer
        a = self.args
        stl = 1 + len(sequence["special_tokens"])
        for context in sequence["in_context"] + sequence["out_context"]:
            if context["add_type"]:
                stl += 2
            stl += len(context["special_tokens"])

        num_tokens = sum(len(c["tokens"]) for c in sequence["out_context"])
        num_pre_tokens = len(sequence["pre_tokens"]) if "pre_tokens" in sequence else 0
        if a.max_pre_token_len > 0:
            num_pre_tokens = min(num_pre_tokens, a.max_pre_token_len)
        num_other_tokens = sum(len(c["tokens"]) for c in sequence["in_context"])

        if a.center_pad_decoder:
            n = min(a.tgt_seq_len - self.pre_token_len - 1, num_tokens)
            m = min(self.pre_token_len - stl + 1, num_pre_tokens)
            o = min(self.pre_token_len - m - stl + 1, num_other_tokens)
            si = self.pre_token_len - m - stl + 1 - o
        else:
            n = min(a.tgt_seq_len - stl - min(self.min_pre_token_len, num_pre_tokens), num_tokens)
            m = min(a.tgt_seq_len - stl - n, num_pre_tokens)
            o = min(a.tgt_seq_len - stl - n - m, num_other_tokens)
            si = 0

        input_tokens = np.full(a.tgt_seq_len, tok.pad_id, np.int64)
        label_tokens = np.full(a.tgt_seq_len, LABEL_IGNORE_ID, np.int64)

        def add_special_tokens(special_tokens, start_index):
            for token in special_tokens:
                input_tokens[start_index] = token
                start_index += 1
            return start_index

        def add_context(context, start_index, max_tokens, add_labels=False):
            if context["add_type"]:
                input_tokens[start_index] = tok.context_sos[context["context_type"]]
                if add_labels:
                    label_tokens[start_index - 1] = tok.context_sos[context["context_type"]]
                start_index += 1

            start_label_index = start_index + context["labels_offset"]
            start_index = add_special_tokens(context["special_tokens"], start_index)

            take = min(len(context["tokens"]), max_tokens)
            input_tokens[start_index : start_index + take] = context["tokens"][:take]
            start_index += take
            max_tokens -= take

            if context["add_type"]:
                input_tokens[start_index] = tok.context_eos[context["context_type"]]
                start_index += 1

            if add_labels:
                label_tokens[start_label_index - 1 : start_index - 1] = input_tokens[start_label_index:start_index]
            return start_index, max_tokens

        for context in sequence["in_context"]:
            si, o = add_context(context, si, o)

        si = add_special_tokens(sequence["special_tokens"], si)
        start_random_index = si

        if m > 0:
            input_tokens[si : si + m] = sequence["pre_tokens"][-m:]
            si += m

        input_tokens[si] = tok.sos_id
        si += 1
        for context in sequence["out_context"]:
            si, n = add_context(context, si, n, True)
        end_index = si
        label_tokens[end_index - 1] = tok.eos_id

        ts_start = tok.event_start[EventType.TIME_SHIFT]
        ts_end = tok.event_end[EventType.TIME_SHIFT]

        def randomize_tokens(tokens):
            offset_tokens = tokens.copy()
            if random.random() < a.timing_random_offset_prob:
                offset_tokens = offset_tokens + np.random.randint(
                    -a.timing_random_offset, a.timing_random_offset + 1, tokens.shape
                )
            if random.random() < a.timing_random_offset_prob:
                offset_tokens = offset_tokens + np.random.randint(
                    -a.timing_random_offset_2, a.timing_random_offset_2 + 1, (1,)
                )
            return np.where(
                (ts_start <= tokens) & (tokens < ts_end),
                np.clip(offset_tokens, ts_start, ts_end - 1),
                tokens,
            )

        if not self.test and (a.timing_random_offset > 0 or a.timing_random_offset_2 > 0):
            input_tokens[start_random_index:end_index] = randomize_tokens(
                input_tokens[start_random_index:end_index]
            )

        if not self.test and a.snapping_random_prob > 0:
            snap_start = tok.event_start[EventType.SNAPPING]
            snap_end = tok.event_end[EventType.SNAPPING]
            random_snappings = np.random.randint(snap_start, snap_end, input_tokens.shape)
            mask = (snap_start <= input_tokens) & (input_tokens < snap_end)
            mask &= np.random.random(input_tokens.shape) < a.snapping_random_prob
            input_tokens = np.where(mask, random_snappings, input_tokens)

        sequence["decoder_input_ids"] = input_tokens
        sequence["decoder_attention_mask"] = (input_tokens != tok.pad_id).astype(np.int64)
        sequence["labels"] = label_tokens

        for key in ("out_context", "in_context", "special_tokens", "special", "pre_tokens"):
            sequence.pop(key, None)
        return sequence

    def pad_frame_sequence(self, sequence: dict) -> dict:
        frames = np.asarray(sequence["frames"], np.float32)
        if frames.shape[0] != self.frame_seq_len:
            n = min(self.frame_seq_len, len(frames))
            padded = np.zeros((self.frame_seq_len, frames.shape[-1]), np.float32)
            padded[:n] = frames[:n]
            sequence["frames"] = padded.reshape(-1)
        else:
            sequence["frames"] = frames.reshape(-1)
        return sequence

    def maybe_change_dataset(self) -> None:
        if self.shared is None:
            return
        step = self.shared.current_train_step
        if 0 <= self.args.add_empty_sequences_at_step <= step and not self.add_empty_sequences:
            self.add_empty_sequences = True
        if 0 <= self.args.add_pre_tokens_at_step <= step and not self.add_pre_tokens:
            self.add_pre_tokens = True

    def process_sequences(self, sequences: Iterable[dict], beatmap_path=None):
        for sequence in sequences:
            self.maybe_change_dataset()
            sequence = self.normalize_time_shifts(sequence, beatmap_path)
            sequence = self.tokenize_sequence(sequence)
            sequence = self.pad_frame_sequence(sequence)
            sequence = self.pad_and_split_token_sequence(sequence)
            if not self.add_empty_sequences and (
                (sequence["labels"] == self.tokenizer.eos_id) | (sequence["labels"] == LABEL_IGNORE_ID)
            ).all():
                continue
            yield sequence
