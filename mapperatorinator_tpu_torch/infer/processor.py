"""Windowed generation orchestrator: the JAX ``infer/processor.py`` on the
torch engine (reference: ``osuT5/osuT5/inference/processor.py:70-1373``).

Differences from the JAX file: the engine is :class:`..decode.DecodeEngine`,
the CFG fold concatenates encoder states with ``torch.cat``, and ``ai_mod``
(with its ``_process_event_str``) waits for ROADMAP queue 1, item 9.

Host-side Python drives template resolution, prompt assembly, and event
bookkeeping on numpy token arrays; only ``DecodeEngine.generate`` crosses the
device boundary. Both execution shapes are supported:

* sequential — window-by-window, carrying generated events forward as the
  decoder prompt inside the lookback region and force-stopping at the
  lookahead edge via the EOS-token-range trick,
* parallel — all windows batched at once (the TPU-preferred shape), contexts
  split per out-context by SOS/EOS scan.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..decode.engine import DecodeEngine
from ..decode.logits import build_logits_pipeline, get_eos_token_ids
from ..osu.beatmap import Beatmap
from ..osu.events import ContextType, Event, EventType
from ..osu.parsing import BeatmapParser
from ..osu.streams import (
    get_hitsounded_status,
    get_hold_note_ratio,
    get_scroll_speed_ratio,
    remove_events_of_type,
    update_event_times,
)
from ..osu.vocab import MILLISECONDS_PER_STEP, Vocabulary

MILLISECONDS_PER_SECOND = 1000


def calculate_difficulty(path=None, content=None, speed: float = 1.0) -> Optional[float]:
    """Star rating via the native C++ calculator (the reference uses rosu-pp;
    reference: data_utils.py:190-226). None on failure -> conditioning falls
    back to the 'unknown difficulty' token."""
    from ..native import calculate_difficulty as native_calculate_difficulty

    return native_calculate_difficulty(content=content, path=path, speed=speed)


@dataclasses.dataclass
class GenerationConfig:
    gamemode: int = 0
    beatmap_id: Optional[int] = None
    difficulty: Optional[float] = None
    mapper_id: Optional[int] = None
    year: Optional[int] = None
    hitsounded: bool = True
    hp_drain_rate: Optional[float] = None
    circle_size: Optional[float] = None
    overall_difficulty: Optional[float] = None
    approach_rate: Optional[float] = None
    slider_multiplier: float = 1.4
    slider_tick_rate: Optional[float] = None
    keycount: int = 4
    hold_note_ratio: Optional[float] = None
    scroll_speed_ratio: Optional[float] = None
    descriptors: Optional[list] = None
    negative_descriptors: Optional[list] = None


def generation_config_from_beatmap(beatmap: Beatmap, beatmap_path, vocab: Optional[Vocabulary] = None) -> GenerationConfig:
    gamemode = int(beatmap.mode)
    difficulty = calculate_difficulty(path=beatmap_path)
    return GenerationConfig(
        gamemode=gamemode,
        beatmap_id=beatmap.beatmap_id,
        difficulty=difficulty,
        mapper_id=vocab.beatmap_mapper.get(beatmap.beatmap_id, None) if vocab else None,
        hp_drain_rate=beatmap.hp_drain_rate,
        circle_size=beatmap.circle_size,
        overall_difficulty=beatmap.overall_difficulty,
        approach_rate=beatmap.approach_rate,
        slider_multiplier=beatmap.slider_multiplier,
        slider_tick_rate=beatmap.slider_tick_rate,
        hitsounded=get_hitsounded_status(beatmap),
        keycount=int(beatmap.circle_size) if gamemode == 3 else 4,
        hold_note_ratio=get_hold_note_ratio(beatmap) if gamemode == 3 else None,
        scroll_speed_ratio=get_scroll_speed_ratio(beatmap) if gamemode in (1, 3) else None,
        descriptors=[vocab.descriptor_name(idx) for idx in vocab.beatmap_descriptors.get(beatmap.beatmap_id, [])]
        if vocab and beatmap.beatmap_id in vocab.beatmap_descriptors
        else None,
    )


class Processor:
    def __init__(self, args, engine: DecodeEngine, vocab: Vocabulary, cfg_scale: Optional[float] = None,
                 client=None):
        self.args = args
        self.engine = engine
        self.vocab = vocab
        # when set, generation routes over IPC to the batching server
        # (reference: processor.py:155-176 with use_server)
        self.client = client
        data = args.train.data
        self.tgt_seq_len = data.tgt_seq_len
        self.frame_seq_len = data.src_seq_len - 1
        self.frame_size = args.train.model.spectrogram.hop_length
        self.sample_rate = args.train.model.spectrogram.sample_rate
        self.samples_per_sequence = self.frame_seq_len * self.frame_size
        self.miliseconds_per_sequence = self.samples_per_sequence * MILLISECONDS_PER_SECOND / self.sample_rate
        self.lookback_time = args.lookback * self.miliseconds_per_sequence
        ts_start = vocab.event_start[EventType.TIME_SHIFT]
        self.lookback_time_range = range(
            ts_start, vocab.encode(Event(EventType.TIME_SHIFT, int(self.lookback_time / MILLISECONDS_PER_STEP)))
        )
        self.lookahead_max_time = (1 - args.lookahead) * self.miliseconds_per_sequence
        self.lookahead_time = args.lookahead * self.miliseconds_per_sequence
        self.lookahead_time_range = range(
            vocab.encode(Event(EventType.TIME_SHIFT, int(self.lookahead_max_time / MILLISECONDS_PER_STEP))),
            vocab.event_end[EventType.TIME_SHIFT],
        )
        self.eos_time = (1 - data.lookahead) * self.miliseconds_per_sequence
        self.center_pad_decoder = data.center_pad_decoder
        self.add_out_context_types = data.add_out_context_types
        self.add_gamemode_token = data.add_gamemode_token
        self.add_style_token = data.add_style_token
        self.add_diff_token = data.add_diff_token
        self.add_mapper_token = data.add_mapper_token
        self.add_year_token = data.add_year_token
        self.add_hitsounded_token = data.add_hitsounded_token
        self.add_song_length_token = data.add_song_length_token
        self.add_global_sv_token = data.add_global_sv_token
        self.add_cs_token = data.add_cs_token
        self.add_keycount_token = data.add_keycount_token
        self.add_hold_note_ratio_token = data.add_hold_note_ratio_token
        self.add_scroll_speed_ratio_token = data.add_scroll_speed_ratio_token
        self.add_descriptors = data.add_descriptors
        self.add_sv_special_token = data.add_sv_special_token
        self.add_kiai_special_token = data.add_kiai_special_token
        self.add_song_position_token = data.add_song_position_token
        self.add_kiai = data.add_kiai
        self.max_pre_token_len = data.max_pre_token_len
        self.add_pre_tokens = data.add_pre_tokens
        self.add_gd_context = data.add_gd_context
        self.add_timing = data.add_timing
        self.parser = BeatmapParser(args.train, vocab)
        self.do_style_embed = args.train.model.do_style_embed
        self.do_difficulty_embed = args.train.model.do_difficulty_embed
        self.do_mapper_embed = args.train.model.do_mapper_embed
        self.do_song_position_embed = args.train.model.do_song_position_embed
        self.add_positions = data.add_positions
        self.add_sv = data.add_sv
        self.add_mania_sv = data.add_mania_sv
        self.context_types: list[dict[str, list[ContextType]]] = [
            {k: [ContextType(t) if not isinstance(t, ContextType) else t for t in v] for k, v in ct.items()}
            for ct in data.context_types
        ]
        self.add_to_beatmap = args.add_to_beatmap
        self.start_time = args.start_time
        self.end_time = args.end_time

        if self.add_positions:
            self.position_precision = data.position_precision
            self.position_refinement = data.position_refinement
            x_min, x_max, y_min, y_max = data.position_range
            self.x_min = x_min // self.position_precision
            self.x_max = x_max // self.position_precision
            self.y_min = y_min // self.position_precision
            self.y_max = y_max // self.position_precision
            self.x_count = self.x_max - self.x_min + 1

        self.cfg_scale = cfg_scale or args.cfg_scale
        self.top_p = args.top_p
        self.top_k = args.top_k
        self.temperature = args.temperature
        self.timing_temperature = args.timing_temperature
        self.mania_column_temperature = args.mania_column_temperature
        self.taiko_hit_temperature = args.taiko_hit_temperature
        self.do_sample = args.do_sample
        self.num_beams = args.num_beams
        self.parallel = args.parallel
        self.max_batch_size = args.max_batch_size
        self.timeshift_bias = args.timeshift_bias
        self.types_first = data.types_first
        self.seed = args.seed if args.seed is not None else 0
        self._seed_counter = 0
        self.last_generation_stats: Optional[dict] = None

    # -- device call -------------------------------------------------------------

    def model_generate(
        self,
        frames: np.ndarray,
        cond_prompt: np.ndarray,
        uncond_prompt: Optional[np.ndarray],
        model_kwargs: dict,
        lookback_time: float = 0,
        lookahead_time: float = 0,
        context_type: Optional[ContextType] = None,
    ) -> np.ndarray:
        """Encode frames, assemble the (CFG-doubled) prompt batch, and run the
        compiled decode (reference: server.py:84-156)."""
        import time as _time

        if self.client is not None:
            mk = {"frames": np.asarray(frames), "decoder_input_ids": np.asarray(cond_prompt)}
            if self.cfg_scale > 1 and uncond_prompt is not None:
                mk["uncond_prompt"] = np.asarray(uncond_prompt)
            mk.update({k: np.asarray(v) for k, v in model_kwargs.items()})
            gk = {
                "cfg_scale": self.cfg_scale,
                "do_sample": self.do_sample,
                "num_beams": self.num_beams,
                "temperature": self.temperature,
                "timing_temperature": self.timing_temperature,
                "mania_column_temperature": self.mania_column_temperature,
                "taiko_hit_temperature": self.taiko_hit_temperature,
                "top_k": self.top_k,
                "top_p": self.top_p,
                "timeshift_bias": self.timeshift_bias,
                "types_first": self.types_first,
                "lookback_time": lookback_time,
                "lookahead_time": lookahead_time,
                "context_type": context_type.value if context_type is not None else None,
                # no per-request seed: it would fragment the batching group
                # key; the server varies its own seed per batch call
                "max_length": self.tgt_seq_len,
            }
            tokens = self.client.generate(mk, gk)
            stats = self.client.last_generation_stats
            if stats:
                self._record_generation_stats(stats)
            return tokens

        pipeline = build_logits_pipeline(
            self.vocab,
            cfg_scale=self.cfg_scale,
            timeshift_bias=self.timeshift_bias,
            temperature=self.temperature,
            timing_temperature=self.timing_temperature,
            mania_column_temperature=self.mania_column_temperature,
            taiko_hit_temperature=self.taiko_hit_temperature,
            types_first=self.types_first,
            lookback_max_time=lookback_time,
            top_k=self.top_k,
            top_p=self.top_p,
            do_sample=self.do_sample,
        )
        eos_ids = get_eos_token_ids(
            self.vocab, lookback_time=lookback_time, lookahead_time=lookahead_time, context_type=context_type
        )

        encoder_states = self.engine.encode_with_cond(frames, model_kwargs)

        if self.cfg_scale > 1 and uncond_prompt is not None:
            # fold dual batch: [negative; positive]
            import numpy as _np

            prompts = _np.concatenate([uncond_prompt, cond_prompt], axis=0)
            encoder_states = torch.cat([encoder_states, encoder_states], dim=0)
        else:
            prompts = cond_prompt

        t0 = _time.perf_counter()
        if self.num_beams > 1:
            # beam search / beam sample (reference: HF GenerationMixin
            # num_beams paths, used by the super-timing generator when
            # timer_num_beams > 1); with CFG the folded [negative; positive]
            # rows flow through the beam loop (reference get_cache sizes the
            # cache batch*beams*2, cache_utils.py:23-35)
            tokens, _ = self.engine.generate_beams(
                encoder_states,
                prompts,
                pipeline,
                eos_ids=eos_ids,
                num_beams=self.num_beams,
                max_length=self.tgt_seq_len,
                seed=self._next_seed(),
                cfg_scale=self.cfg_scale if uncond_prompt is not None else 1.0,
            )
        else:
            tokens, _ = self.engine.generate(
                encoder_states,
                prompts,
                pipeline,
                eos_ids=eos_ids,
                seed=self._next_seed(),
                cfg_scale=self.cfg_scale,
                max_length=self.tgt_seq_len,
            )
        elapsed = _time.perf_counter() - t0

        if self.cfg_scale > 1 and uncond_prompt is not None and self.num_beams <= 1:
            # beams already return only the positive-half best hypotheses
            tokens = tokens[tokens.shape[0] // 2 :]

        gen_count = int((tokens != self.vocab.pad_id).sum()) - int((prompts != self.vocab.pad_id).sum())
        self._record_generation_stats(
            {
                "generated_tokens": max(gen_count, 0),
                "elapsed_seconds": elapsed,
                "tokens_per_second": max(gen_count, 0) / elapsed if elapsed > 0 else 0.0,
            }
        )
        return tokens

    def _next_seed(self) -> int:
        self._seed_counter += 1
        return self.seed * 1_000_003 + self._seed_counter

    # -- top level ------------------------------------------------------------------

    def generate(
        self,
        *,
        sequences: tuple[np.ndarray, np.ndarray, float],
        generation_config: GenerationConfig,
        in_context: Optional[list[ContextType]] = None,
        out_context: Optional[list[ContextType]] = None,
        beatmap_path: Optional[str] = None,
        extra_in_context: Optional[dict] = None,
        verbose: bool = True,
    ) -> list[tuple[list[Event], list[int]]]:
        state = self._prepare_generation(
            sequences=sequences,
            generation_config=generation_config,
            in_context=in_context,
            out_context=out_context,
            beatmap_path=beatmap_path,
            extra_in_context=extra_in_context,
            verbose=verbose,
        )
        self._reset_generation_stats()
        if self.parallel:
            self.open_parallel_session(state)
            self.run_parallel_sessions([state], verbose=verbose)
        else:
            self.generate_sequential(
                sequences=state["sequences"],
                in_context=state["in_context"],
                out_context=state["out_context"],
                model_kwargs=state["model_kwargs"],
                req_special_tokens=state["req_special_tokens"],
                verbose=verbose,
            )
        return self._finalize_generation(state)

    def _prepare_generation(
        self,
        *,
        sequences,
        generation_config: GenerationConfig,
        in_context: Optional[list[ContextType]] = None,
        out_context: Optional[list[ContextType]] = None,
        beatmap_path: Optional[str] = None,
        extra_in_context: Optional[dict] = None,
        verbose: bool = True,
    ) -> dict:
        """Template resolution + context assembly; no model calls. Returns a
        generation-state dict consumed by the sequential loop or by the
        parallel-session API below."""
        gen_in_context, gen_out_context, req_special_tokens = self._get_viable_template(
            in_context=in_context,
            out_context=out_context,
            extra_in_context=extra_in_context,
            gamemode=generation_config.gamemode,
        )

        model_kwargs = self._get_model_cond_kwargs(generation_config)
        song_length = sequences[2]
        in_context_data = self.get_in_context(
            in_context=gen_in_context,
            beatmap_path=beatmap_path,
            extra_in_context=extra_in_context,
            song_length=song_length,
        )
        out_context_data = self.get_out_context(
            out_context=gen_out_context,
            generation_config=generation_config,
            given_context=in_context or [],
            beatmap_path=beatmap_path,
            extra_in_context=extra_in_context,
            song_length=song_length,
            verbose=verbose,
        )
        return dict(
            sequences=sequences,
            in_context=in_context_data,
            out_context=out_context_data,
            model_kwargs=model_kwargs,
            req_special_tokens=req_special_tokens,
            generation_config=generation_config,
            beatmap_path=beatmap_path,
            extra_in_context=extra_in_context,
            requested=list(out_context or []),
        )

    def _finalize_generation(self, state: dict) -> list[tuple[list[Event], list[int]]]:
        sequences = state["sequences"]
        out_context_data = state["out_context"]
        generation_config = state["generation_config"]
        beatmap_path = state["beatmap_path"]
        extra_in_context = state["extra_in_context"]
        song_length = sequences[2]

        # Post-process events
        for context in out_context_data:
            context["event_times"] = []
            update_event_times(context["events"], context["event_times"], song_length, self.types_first)

            if self.start_time is not None:
                self._trim_events_before_time(context["events"], context["event_times"], self.start_time - 10)
            if self.end_time is not None:
                self._trim_events_after_time(context["events"], context["event_times"], self.end_time + 10)

            if context["context_type"] == ContextType.MAP and self.add_positions:
                context["events"], context["event_times"] = self._rescale_positions(
                    context["events"], context["event_times"]
                )

        # add-to-beatmap: splice the reference beatmap's events back in
        if self.add_to_beatmap and (self.start_time is not None or self.end_time is not None):
            parser = BeatmapParser(self.args.train, self.vocab)
            parser.position_precision = 1
            parser.position_split_axes = True
            for context in out_context_data:
                ref_context = self.get_context(
                    context["context_type"],
                    beatmap_path=beatmap_path,
                    extra_in_context=extra_in_context,
                    finished=True,
                    parser=parser,
                )
                if self.start_time is not None:
                    ref_events = ref_context["events"].copy()
                    ref_times = ref_context["event_times"].copy()
                    self._trim_events_after_time(ref_events, ref_times, self.start_time - 1)
                    context["events"] = ref_events + context["events"]
                    context["event_times"] = ref_times + context["event_times"]
                if self.end_time is not None:
                    ref_events = ref_context["events"].copy()
                    ref_times = ref_context["event_times"].copy()
                    self._trim_events_before_time(ref_events, ref_times, self.end_time + 1)
                    context["events"] += ref_events
                    context["event_times"] += ref_times

        for context in out_context_data:
            if context["context_type"] == ContextType.MAP and generation_config.gamemode == 3:
                context["events"], context["event_times"] = self._convert_column_to_position(
                    context["events"], context["event_times"], generation_config.keycount
                )

        requested = state["requested"]
        return [
            (context["events"], context["event_times"])
            for context in out_context_data
            if context["context_type"] in requested
        ]

    def generate_sequential(
        self,
        *,
        sequences,
        in_context: list[dict],
        out_context: list[dict],
        model_kwargs: dict,
        req_special_tokens: list[str],
        verbose: bool = True,
    ) -> None:
        song_length = sequences[2]
        frames_all, frame_times = sequences[0], sequences[1]

        for i, context in enumerate(out_context):
            if context["finished"]:
                continue
            if verbose:
                print(f"Generating {context['context_type'].value}")
            iterator = list(zip(frames_all, frame_times))
            if verbose:
                from tqdm import tqdm

                iterator = tqdm(iterator, dynamic_ncols=True)
            for sequence_index, (frames, frame_time) in enumerate(iterator):
                trim_lookback = sequence_index != 0 and self.lookback_time > 0
                trim_lookahead = sequence_index != len(frames_all) - 1
                frame_time = int(frame_time)

                cond_prompt, uncond_prompt = self.get_prompts(
                    self.prepare_context_sequences(in_context, frame_time, False, req_special_tokens),
                    self.prepare_context_sequences(out_context[: i + 1], frame_time, True, req_special_tokens),
                )
                [cond_prompt, uncond_prompt], max_len = self.pad_prompts([cond_prompt, uncond_prompt])

                kwargs = dict(model_kwargs)
                if self.do_song_position_embed:
                    kwargs["song_position"] = np.array(
                        [[frame_time / song_length, (frame_time + self.miliseconds_per_sequence) / song_length]],
                        np.float32,
                    )

                result = self.model_generate(
                    frames[None] if frames.ndim == 1 else frames,
                    cond_prompt,
                    uncond_prompt,
                    kwargs,
                    lookback_time=self.lookback_time if trim_lookback else 0,
                    lookahead_time=self.lookahead_time if trim_lookahead else 0,
                    context_type=context["context_type"],
                )
                predicted_tokens = self._strip_result_row(result[0], max_len)
                self.add_predicted_tokens_to_context(
                    context, predicted_tokens, frame_time, trim_lookback, trim_lookahead
                )

    # -- parallel sessions -------------------------------------------------------------
    #
    # Parallel ("all windows at once") generation is split into open/run/
    # consume so that SEVERAL independent generation jobs — e.g. the N
    # jittered passes of the super-timing ensemble, or different songs in an
    # offline batch — can pool every window into one shared device batch.
    # Each row of the decode output routes back to the session that owns it.

    def open_parallel_session(self, state: dict) -> dict:
        """Attach per-window prompts/kwargs to a prepared generation state."""
        frames, frame_times, song_length = state["sequences"]
        windows = []
        for i in range(len(frame_times)):
            frame_time = int(frame_times[i])
            cond_prompt, uncond_prompt = self.get_prompts(
                self.prepare_context_sequences(state["in_context"], frame_time, False, state["req_special_tokens"]),
                self.prepare_context_sequences(state["out_context"][:1], frame_time, True, state["req_special_tokens"]),
            )
            kwargs = dict(state["model_kwargs"])
            if self.do_song_position_embed:
                kwargs["song_position"] = np.array(
                    [[frame_time / song_length, (frame_time + self.miliseconds_per_sequence) / song_length]],
                    np.float32,
                )
            windows.append(
                dict(frames=frames[i], frame_time=frame_time, cond=cond_prompt, uncond=uncond_prompt, kwargs=kwargs)
            )
        state["windows"] = windows
        return state

    def run_parallel_sessions(self, sessions: list[dict], verbose: bool = True) -> None:
        """Decode every window of every open session in shared batches.

        Chunks are padded up to the next power of two (capped at the
        effective max batch) by repeating the final window, so the compiled
        decode program is reused across songs of any window count instead of
        recompiling for every remainder size; padded rows are discarded."""
        flat = [(state, window) for state in sessions for window in state["windows"]]
        if not flat:
            return
        cond_prompt, uncond_prompt, _ = self.stack_prompts(
            [w["cond"] for _, w in flat], [w["uncond"] for _, w in flat]
        )
        kw_keys = list(flat[0][1]["kwargs"].keys())

        max_batch_size = max(1, self.max_batch_size // self.num_beams // (2 if self.cfg_scale > 1 else 1))
        batches = list(range(0, len(flat), max_batch_size))
        if verbose:
            from tqdm import tqdm

            batches = tqdm(batches, dynamic_ncols=True)
        for b in batches:
            chunk = flat[b : b + max_batch_size]
            n = len(chunk)
            bucket = min(1 << (n - 1).bit_length(), max_batch_size)
            pad = bucket - n

            def padded(rows: np.ndarray) -> np.ndarray:
                if pad == 0:
                    return rows
                return np.concatenate([rows, np.repeat(rows[-1:], pad, axis=0)], axis=0)

            frames_batch = padded(np.stack([w["frames"] for _, w in chunk]))
            cond_batch = padded(cond_prompt[b : b + n])
            uncond_batch = padded(uncond_prompt[b : b + n]) if uncond_prompt is not None else None
            kw_batch = {
                k: padded(np.concatenate([w["kwargs"][k] for _, w in chunk], axis=0)) for k in kw_keys
            }
            result = self.model_generate(frames_batch, cond_batch, uncond_batch, kw_batch)

            for (state, window), row in zip(chunk, result[:n]):
                self.consume_parallel_row(state, window["frame_time"], row)

    def consume_parallel_row(self, state: dict, frame_time: int, row: np.ndarray) -> None:
        """Route one decoded row into its session's out-context events."""
        out_context = state["out_context"]
        sequence = self._strip_left_pads(row)
        if self.add_out_context_types:
            for context in out_context:
                start, end = self._get_token_context(
                    sequence,
                    self.vocab.context_sos[context["context_type"]],
                    self.vocab.context_eos[context["context_type"]],
                    strict=True,
                )
                self.add_predicted_tokens_to_context(context, sequence[start:end], frame_time)
        else:
            start, end = self._get_token_context(sequence, self.vocab.sos_id, self.vocab.eos_id)
            self.add_predicted_tokens_to_context(out_context[0], sequence[start:end], frame_time)

    # -- result trimming helpers -----------------------------------------------------

    def _strip_result_row(self, row: np.ndarray, prompt_len: int) -> np.ndarray:
        """The engine writes [prompt][generated...] into a max_length-wide
        buffer (prompt bucket pads exist only inside the prefill program);
        generated tokens start exactly at the prompt width."""
        return row[prompt_len:]

    @staticmethod
    def _strip_left_pads(row: np.ndarray) -> np.ndarray:
        nz = np.nonzero(row)[0]
        return row[nz[0] :] if len(nz) > 0 else row[:0]

    def _get_token_context(self, tokens: np.ndarray, sos: int, eos: int, strict: bool = False):
        start_idx = np.nonzero(tokens == sos)[0]
        start = int(start_idx[0]) + 1 if len(start_idx) > 0 else (None if strict else 0)
        end_idx = np.nonzero(tokens == eos)[0]
        end = int(end_idx[0]) if len(end_idx) > 0 else (None if strict else len(tokens))
        if start is None or end is None:
            return 0, 0
        return start, end

    # -- template & context assembly ---------------------------------------------------

    def _get_viable_template(
        self,
        in_context: Optional[list[ContextType]] = None,
        out_context: Optional[list[ContextType]] = None,
        extra_in_context: Optional[dict] = None,
        gamemode: int = 0,
    ):
        in_context = in_context or []
        out_context = out_context or []
        requested_out_context = out_context.copy()

        if extra_in_context is not None:
            in_context = in_context.copy()
            for context_type in extra_in_context:
                if context_type not in in_context:
                    in_context.append(context_type)

        viable_templates = [
            ct
            for ct in self.context_types
            if all(oc in ct["out"] for oc in out_context)
            and all(ic in in_context or ic == ContextType.NONE for ic in ct["in"])
        ]
        if len(viable_templates) == 0:
            raise ValueError(
                "No viable template found for the given context types. Candidates are: " + str(self.context_types)
            )

        template = max(viable_templates, key=lambda ct: sum(1 for ic in ct["in"] if ic != ContextType.NONE))
        all_out_context = template["out"]
        gen_out_context = all_out_context.copy()
        gen_in_context = template["in"].copy()

        req_special_tokens = self.get_required_extra_special_tokens(all_out_context)

        if gamemode != 3 and ContextType.SV in gen_out_context:
            gen_out_context.remove(ContextType.SV)

        requested_was_explicit = len(requested_out_context) > 0
        requested_out_context = [oc for oc in requested_out_context if oc in gen_out_context]
        if len(requested_out_context) == 0:
            if requested_was_explicit:
                raise ValueError("No requested output contexts are available for the selected template and gamemode.")
            gen_out_context = all_out_context.copy()
        else:
            count = max(all_out_context.index(oc) for oc in requested_out_context) + 1
            gen_out_context = all_out_context[:count]

        return gen_in_context, gen_out_context, req_special_tokens

    def _get_model_cond_kwargs(self, generation_config: GenerationConfig) -> dict:
        model_kwargs = {}
        if self.do_style_embed:
            if generation_config.beatmap_id is not None:
                model_kwargs["beatmap_idx"] = np.array(
                    [self.vocab.beatmap_idx[generation_config.beatmap_id]], np.int32
                )
            else:
                model_kwargs["beatmap_idx"] = np.array([self.vocab.num_classes], np.int32)
        if self.do_difficulty_embed:
            diff = generation_config.difficulty if generation_config.difficulty is not None else 5.0
            model_kwargs["difficulty"] = np.array([diff], np.float32)
        if self.do_mapper_embed:
            if generation_config.mapper_id is not None:
                model_kwargs["mapper_idx"] = np.array(
                    [self.vocab.get_mapper_idx(generation_config.mapper_id)], np.int32
                )
            else:
                model_kwargs["mapper_idx"] = np.array([-1], np.int32)
        return model_kwargs

    def get_context(
        self,
        context: ContextType,
        *,
        beatmap_path: Optional[str] = None,
        extra_in_context: Optional[dict] = None,
        song_length: Optional[float] = None,
        add_type: bool = False,
        add_class: bool = False,
        finished: bool = False,
        partial: bool = False,
        parser: Optional[BeatmapParser] = None,
    ) -> dict:
        if context != ContextType.NONE and finished and (extra_in_context is None or context not in extra_in_context):
            beatmap_path = Path(beatmap_path)
            if not beatmap_path.is_file():
                raise FileNotFoundError(f"Beatmap file {beatmap_path} not found.")

        data = {
            "events": [],
            "event_times": [],
            "context_type": context,
            "add_type": add_type,
            "add_class": add_class,
            "add_pre_tokens": False,
            "song_length": song_length,
            "finished": finished,
        }

        if finished or partial:
            parser = parser or self.parser
            if extra_in_context is not None and context in extra_in_context:
                if context == ContextType.TIMING and isinstance(extra_in_context[context], list):
                    timing = extra_in_context[context]
                    data["events"], data["event_times"] = parser.parse_timing(timing, song_length=song_length)
                else:
                    if len(extra_in_context[context]) == 2:
                        data["events"], data["event_times"] = extra_in_context[context]
                    elif len(extra_in_context[context]) == 3:
                        data["events"], data["event_times"], data["class"] = extra_in_context[context]
            elif context == ContextType.NONE:
                pass
            elif context == ContextType.TIMING:
                beatmap = Beatmap.from_path(beatmap_path)
                data["events"], data["event_times"] = parser.parse_timing(beatmap, song_length=song_length)
            elif context == ContextType.MAP:
                beatmap = Beatmap.from_path(beatmap_path)
                data["events"], data["event_times"] = parser.parse(beatmap, song_length=song_length)
                if add_class:
                    data["class"] = self.get_class_vector(
                        generation_config_from_beatmap(beatmap, beatmap_path, self.vocab), song_length
                    )
            elif context == ContextType.NO_HS:
                beatmap = Beatmap.from_path(beatmap_path)
                hs_events, hs_times = parser.parse(beatmap, song_length=song_length)
                data["events"], data["event_times"] = remove_events_of_type(
                    hs_events, hs_times, [EventType.HITSOUND, EventType.VOLUME]
                )
            elif context == ContextType.GD:
                beatmap = Beatmap.from_path(beatmap_path)
                data["events"], data["event_times"] = parser.parse(beatmap, song_length=song_length)
                if add_class:
                    data["class"] = self.get_class_vector(
                        generation_config_from_beatmap(beatmap, beatmap_path, self.vocab), song_length
                    )
            elif context == ContextType.KIAI:
                beatmap = Beatmap.from_path(beatmap_path)
                data["events"], data["event_times"] = parser.parse_kiai(beatmap)
            elif context == ContextType.SV:
                beatmap = Beatmap.from_path(beatmap_path)
                data["events"], data["event_times"] = parser.parse_scroll_speeds(beatmap)
            else:
                raise ValueError(f"Invalid context type {context}")

            if not finished and partial:
                self._trim_events_after_time(data["events"], data["event_times"], self.start_time - 1)
        return data

    def get_in_context(
        self,
        *,
        in_context: list[ContextType],
        beatmap_path: Optional[str],
        extra_in_context: Optional[dict] = None,
        song_length: float,
    ) -> list[dict]:
        result = [
            self.get_context(
                context,
                beatmap_path=beatmap_path,
                extra_in_context=extra_in_context,
                song_length=song_length,
                add_type=True,
                add_class=True,
                finished=True,
            )
            for context in in_context
        ]
        if self.add_gd_context:
            result.append(
                self.get_context(
                    ContextType.GD,
                    beatmap_path=beatmap_path,
                    extra_in_context=extra_in_context,
                    song_length=song_length,
                    add_type=False,
                    add_class=True,
                    finished=True,
                )
            )
        return result

    def get_out_context(
        self,
        *,
        out_context: list[ContextType],
        generation_config: GenerationConfig,
        given_context: list[ContextType],
        beatmap_path: Optional[str],
        extra_in_context: Optional[dict] = None,
        song_length: float,
        verbose: bool = True,
    ) -> list[dict]:
        out = []
        for i, context in enumerate(out_context):
            context_is_provided = context in given_context or (
                extra_in_context is not None and context in extra_in_context
            )
            context_data = self.get_context(
                context,
                beatmap_path=beatmap_path,
                extra_in_context=extra_in_context,
                song_length=song_length,
                add_type=self.add_out_context_types,
                add_class=False,
                finished=context_is_provided,
                partial=self.add_to_beatmap and self.start_time is not None,
            )
            if i == 0:
                context_data["class"] = self.get_class_vector(generation_config, song_length, verbose=verbose)
                context_data["negative_class"] = self.get_class_vector(
                    GenerationConfig(
                        gamemode=generation_config.gamemode,
                        difficulty=generation_config.difficulty,
                        mapper_id=generation_config.mapper_id
                        if (generation_config.descriptors and len(generation_config.descriptors) > 0)
                        or (generation_config.negative_descriptors and len(generation_config.negative_descriptors) > 0)
                        else None,
                        year=generation_config.year,
                        hp_drain_rate=generation_config.hp_drain_rate,
                        circle_size=generation_config.circle_size,
                        overall_difficulty=generation_config.overall_difficulty,
                        approach_rate=generation_config.approach_rate,
                        slider_multiplier=generation_config.slider_multiplier,
                        slider_tick_rate=generation_config.slider_tick_rate,
                        hitsounded=generation_config.hitsounded,
                        keycount=generation_config.keycount,
                        hold_note_ratio=generation_config.hold_note_ratio,
                        scroll_speed_ratio=generation_config.scroll_speed_ratio,
                        descriptors=generation_config.negative_descriptors,
                    ),
                    song_length,
                )
                context_data["add_pre_tokens"] = self.add_pre_tokens
            out.append(context_data)
        return out

    def get_class_vector(
        self,
        config: GenerationConfig,
        song_length: float,
        verbose: bool = False,
    ) -> np.ndarray:
        """Conditioning token prefix (reference: processor.py:945-1020)."""
        vocab = self.vocab
        cond_tokens: list[int] = []

        if self.add_gamemode_token:
            cond_tokens.append(vocab.encode_gamemode(config.gamemode))
        if self.add_style_token:
            cond_tokens.append(vocab.encode_style(config.beatmap_id) if config.beatmap_id is not None else vocab.style_unk)
            if config.beatmap_id is not None and config.beatmap_id not in vocab.beatmap_idx and verbose:
                print(f"Beatmap class {config.beatmap_id} not found. Using default.")
        if self.add_diff_token:
            cond_tokens.append(vocab.encode_diff(config.difficulty) if config.difficulty is not None else vocab.diff_unk)
        if self.add_mapper_token:
            cond_tokens.append(
                vocab.encode_mapper_id(config.mapper_id) if config.mapper_id is not None else vocab.mapper_unk
            )
            if config.mapper_id is not None and config.mapper_id not in vocab.mapper_idx and verbose:
                print(f"Mapper class {config.mapper_id} not found. Using default.")
        if self.add_year_token:
            cond_tokens.append(vocab.encode_year(config.year) if config.year is not None else vocab.year_unk)
        if self.add_hitsounded_token:
            cond_tokens.append(vocab.encode(Event(EventType.HITSOUNDED, int(config.hitsounded))))
        if self.add_song_length_token:
            cond_tokens.append(vocab.encode_song_length(song_length))
        if self.add_global_sv_token and self.add_sv and config.gamemode in (0, 2):
            cond_tokens.append(vocab.encode_global_sv(config.slider_multiplier))
        if self.add_cs_token and config.gamemode in (0, 2):
            cond_tokens.append(vocab.encode_cs(config.circle_size) if config.circle_size is not None else vocab.cs_unk)
        if config.gamemode == 3:
            if self.add_keycount_token:
                cond_tokens.append(vocab.encode(Event(EventType.MANIA_KEYCOUNT, config.keycount)))
            if self.add_hold_note_ratio_token:
                cond_tokens.append(
                    vocab.encode_hold_note_ratio(config.hold_note_ratio)
                    if config.hold_note_ratio is not None
                    else vocab.hold_note_ratio_unk
                )
        if self.add_scroll_speed_ratio_token and config.gamemode in (1, 3):
            cond_tokens.append(
                vocab.encode_scroll_speed_ratio(config.scroll_speed_ratio)
                if config.scroll_speed_ratio is not None
                else vocab.scroll_speed_ratio_unk
            )

        descriptors = config.descriptors if config.descriptors is not None else []
        descriptors_added = 0
        if self.add_descriptors:
            if descriptors:
                for descriptor in descriptors:
                    if isinstance(descriptor, str):
                        if descriptor not in vocab.descriptor_idx:
                            if verbose:
                                print(f"Descriptor class {descriptor} not found. Skipping.")
                            continue
                        cond_tokens.append(vocab.encode_descriptor_name(descriptor))
                        descriptors_added += 1
                    elif isinstance(descriptor, int):
                        er = vocab.event_range[EventType.DESCRIPTOR]
                        if descriptor < er.min_value or descriptor > er.max_value:
                            if verbose:
                                print(f"Descriptor idx {descriptor} out of range. Skipping.")
                            continue
                        cond_tokens.append(vocab.encode_descriptor_idx(descriptor))
                        descriptors_added += 1
            if config.descriptors is None or descriptors_added == 0:
                cond_tokens.append(vocab.descriptor_unk)

        return np.array([cond_tokens], np.int32)

    # -- prompt assembly ------------------------------------------------------------------

    def get_required_extra_special_tokens(self, all_out_context: list[ContextType]) -> list[str]:
        result = []
        if ContextType.KIAI in all_out_context or (
            self.add_kiai and any(c in all_out_context for c in (ContextType.GD, ContextType.MAP))
        ):
            result.append("last_kiai")
        if ContextType.SV in all_out_context or (
            (self.add_sv or self.add_mania_sv) and any(c in all_out_context for c in (ContextType.GD, ContextType.MAP))
        ):
            result.append("last_sv")
        if self.add_song_position_token:
            result.append("song_position")
        return result

    def prepare_context_sequences(
        self, contexts: list[dict], frame_time, out_context: bool, req_special_tokens: list[str]
    ) -> list[dict]:
        results = []
        for i, context in enumerate(contexts):
            result = self.prepare_context_sequence(context, frame_time)
            results.append(result)
            if out_context and i != 0:
                for k, v in result["extra_special_events"].items():
                    results[0]["extra_special_events"][k] = v
                del result["extra_special_events"]

        if out_context:
            for k in req_special_tokens:
                if k not in results[0]["extra_special_events"]:
                    results[0]["extra_special_events"][k] = self._default_special_event(k)

        special_token_order = ["last_kiai", "last_sv", "song_position"]
        for result in results:
            if "extra_special_events" not in result:
                continue
            ev = result["extra_special_events"]
            ordered = [ev[k] for k in special_token_order if k in ev]
            result["extra_special_tokens"] = self._encode(ordered, frame_time)
        return results

    def prepare_context_sequence(self, context: dict, frame_time) -> dict:
        result = context.copy()
        result["frame_time"] = frame_time

        if context["add_pre_tokens"]:
            s, e = self._get_events_time_range(
                context["event_times"], frame_time - self.miliseconds_per_sequence, frame_time
            )
            pre_tokens = self._encode(context["events"][s:e], frame_time)
            if 0 <= self.max_pre_token_len < pre_tokens.shape[1]:
                pre_tokens = pre_tokens[:, -self.max_pre_token_len :]
            result["pre_tokens"] = pre_tokens

        s, e = self._get_events_time_range(context["event_times"], frame_time, frame_time + self.miliseconds_per_sequence)
        result["tokens"] = self._encode(context["events"][s:e], frame_time)

        extra_special_events = {}
        if self.add_kiai_special_token and (
            context["context_type"] == ContextType.KIAI
            or (self.add_kiai and context["context_type"] in (ContextType.GD, ContextType.MAP))
        ):
            extra_special_events["last_kiai"] = self._kiai_before_time(
                context["events"], context["event_times"], frame_time
            )
        if self.add_sv_special_token and (
            context["context_type"] == ContextType.SV
            or ((self.add_sv or self.add_mania_sv) and context["context_type"] in (ContextType.GD, ContextType.MAP))
        ):
            extra_special_events["last_sv"] = self._sv_before_time(context["events"], context["event_times"], frame_time)
        if self.add_song_position_token and "class" in context:
            extra_special_events["song_position"] = self.vocab.encode_song_position_event(
                frame_time, context["song_length"]
            )
        result["extra_special_events"] = extra_special_events
        return result

    def get_context_tokens(self, context: dict, max_token_length=None, add_type_end=True) -> np.ndarray:
        context_type = context["context_type"]
        tokens = context["tokens"]
        if max_token_length is not None and tokens.shape[1] > max_token_length:
            tokens = tokens[:, -max_token_length:]
        to_concat = []
        if context["add_type"]:
            to_concat.append(np.array([[self.vocab.context_sos[context_type]]], np.int32))
        if context["add_class"]:
            if "class" in context:
                to_concat.append(context["class"])
            if "extra_special_tokens" in context:
                to_concat.append(context["extra_special_tokens"])
        to_concat.append(tokens)
        if context["add_type"] and add_type_end:
            to_concat.append(np.array([[self.vocab.context_eos[context_type]]], np.int32))
        return np.concatenate(to_concat, axis=-1)

    def get_prompt(
        self, in_context, out_context, negative=False, max_token_length=None, close_last_context=False
    ) -> np.ndarray:
        class_container = out_context[0]
        user_prompt = class_container["negative_class"] if negative else class_container["class"]
        extra_special_tokens = class_container.get("extra_special_tokens", np.zeros((1, 0), np.int32))
        pre_tokens = class_container.get("pre_tokens", np.zeros((1, 0), np.int32))

        in_tokens = [self.get_context_tokens(c, max_token_length) for c in in_context]
        # the last out context's type-EOS is normally left for the model to
        # generate; teacher-forced analysis (ai_mod) closes it explicitly
        out_tokens = [
            self.get_context_tokens(c, max_token_length, close_last_context or i != len(out_context) - 1)
            for i, c in enumerate(out_context)
        ]
        if max_token_length is not None:
            pre_tokens = pre_tokens[:, -max_token_length:]

        prefix = np.concatenate(in_tokens + [user_prompt, extra_special_tokens, pre_tokens], axis=-1)
        if self.center_pad_decoder:
            pad = self.tgt_seq_len // 2 - prefix.shape[1]
            prefix = np.pad(prefix, ((0, 0), (pad, 0)), constant_values=self.vocab.pad_id)

        sos = np.array([[self.vocab.sos_id]], np.int32)
        return np.concatenate([prefix, sos] + out_tokens, axis=-1).astype(np.int32)

    def get_prompts(self, in_context, out_context, close_last_context=False):
        kw = dict(close_last_context=close_last_context)
        cond_prompt = self.get_prompt(in_context, out_context, **kw)
        uncond_prompt = self.get_prompt(in_context, out_context, negative=True, **kw) if self.cfg_scale > 1 else None

        i = 0
        max_length = self.tgt_seq_len
        while cond_prompt.shape[1] >= self.tgt_seq_len:
            i += 1
            if i > 10:
                raise ValueError("Prompt is too long.")
            max_length = max_length // 2
            cond_prompt = self.get_prompt(in_context, out_context, max_token_length=max_length, **kw)
            uncond_prompt = (
                self.get_prompt(in_context, out_context, negative=True, max_token_length=max_length, **kw)
                if self.cfg_scale > 1
                else None
            )
        return cond_prompt, uncond_prompt

    @staticmethod
    def pad_prompts(prompts):
        max_len = max(p.shape[1] if p is not None else 0 for p in prompts)
        out = [
            np.pad(p, ((0, 0), (max_len - p.shape[1], 0))) if p is not None else None for p in prompts
        ]
        return out, max_len

    def stack_prompts(self, cond_prompts, uncond_prompts):
        length = len(cond_prompts)
        padded, max_len = self.pad_prompts(cond_prompts + uncond_prompts)
        cond_prompt = np.concatenate(padded[:length], axis=0)
        uncond_prompt = np.concatenate(padded[length:], axis=0) if self.cfg_scale > 1 else None
        return cond_prompt, uncond_prompt, max_len

    # -- event <-> token plumbing -------------------------------------------------------

    @staticmethod
    def _get_events_time_range(event_times: list, start_time: float, end_time: float):
        s = 0
        for i in range(len(event_times) - 1, -1, -1):
            if event_times[i] < start_time:
                s = i + 1
                break
        e = 0
        for i in range(len(event_times) - 1, -1, -1):
            if event_times[i] < end_time:
                e = i + 1
                break
        return s, e

    @staticmethod
    def _trim_events_before_time(events, event_times, time) -> None:
        for i in range(len(event_times) - 1, -1, -1):
            if event_times[i] < time:
                del events[i]
                del event_times[i]

    @staticmethod
    def _trim_events_after_time(events, event_times, time) -> None:
        for i in range(len(event_times) - 1, -1, -1):
            if event_times[i] > time:
                del events[i]
                del event_times[i]
            else:
                break

    def _encode(self, events: list[Event], frame_time: float) -> np.ndarray:
        ts_range = self.vocab.event_range[EventType.TIME_SHIFT]
        tokens = np.empty((1, len(events)), np.int32)
        for i, event in enumerate(events):
            if event.type == EventType.TIME_SHIFT:
                value = int((event.value - frame_time) / MILLISECONDS_PER_STEP)
                value = int(np.clip(value, ts_range.min_value, ts_range.max_value))
                event = Event(type=event.type, value=value)
            tokens[0, i] = self.vocab.encode(event)
        return tokens

    def _decode(self, tokens, frame_time: float, allow_non_events: bool = False) -> list[Event]:
        events = []
        for token in np.asarray(tokens).tolist():
            if token == self.vocab.eos_id and not allow_non_events:
                break
            try:
                event = self.vocab.decode(token)
            except (ValueError, IndexError):
                if allow_non_events:
                    events.append(Event(EventType.CONTROL, token))
                continue
            if event.type == EventType.TIME_SHIFT:
                # half-step (+5 ms) de-biasing of the truncating 10 ms grid
                # (reference: processor.py:1253-1264)
                half_step = MILLISECONDS_PER_STEP // 2 if event.value >= 0 else 0
                event.value = frame_time + event.value * MILLISECONDS_PER_STEP + half_step
            events.append(event)
        return events

    def add_predicted_tokens_to_context(
        self,
        context: dict,
        predicted_tokens,
        frame_time,
        trim_lookback: bool = False,
        trim_lookahead: bool = False,
    ) -> None:
        predicted_tokens = list(np.asarray(predicted_tokens).tolist())
        # strip trailing pads (engine right-pads finished rows)
        while predicted_tokens and predicted_tokens[-1] == self.vocab.pad_id:
            predicted_tokens.pop()
        while predicted_tokens and (
            predicted_tokens[-1] == self.vocab.eos_id
            or (
                context["context_type"] in self.vocab.context_eos
                and predicted_tokens[-1] == self.vocab.context_eos[context["context_type"]]
            )
        ):
            predicted_tokens.pop()

        if predicted_tokens and (
            (trim_lookahead and predicted_tokens[-1] in self.lookahead_time_range)
            or (trim_lookback and predicted_tokens[-1] in self.lookback_time_range)
        ):
            if self.types_first:
                predicted_tokens = predicted_tokens[:-2]
            else:
                predicted_tokens = predicted_tokens[:-1]

        result = self._decode(np.asarray(predicted_tokens), frame_time)
        context["events"] += result
        update_event_times(context["events"], context["event_times"], frame_time + self.eos_time, self.types_first)

        if trim_lookahead:
            lookahead_time = frame_time + self.lookahead_max_time
            self._trim_events_after_time(context["events"], context["event_times"], lookahead_time)

    def _rescale_positions(self, events: list[Event], event_times: list[int]):
        new_events, new_times = [], []
        default_offset = self.position_precision // 2 if self.position_precision > 1 else 0
        default_offset = np.array([default_offset, default_offset], np.int32)
        for i, event in enumerate(events):
            if event.type in (EventType.POS_X, EventType.POS_Y):
                new_events.append(Event(event.type, event.value * self.position_precision))
                new_times.append(event_times[i])
            elif event.type == EventType.POS:
                if i + 1 < len(events) and events[i + 1].type == EventType.POS_REFINE and self.position_refinement:
                    ref_range = self.position_precision // self.position_refinement
                    refinement = events[i + 1].value
                    offset = np.array([refinement % ref_range, refinement // ref_range], np.int32) * self.position_refinement
                else:
                    offset = default_offset
                p = np.array(
                    [event.value % self.x_count + self.x_min, event.value // self.x_count + self.y_min], np.int32
                )
                p = p * self.position_precision + offset
                new_events.append(Event(EventType.POS_X, int(p[0])))
                new_events.append(Event(EventType.POS_Y, int(p[1])))
                new_times.append(event_times[i])
                new_times.append(event_times[i])
            elif event.type == EventType.POS_REFINE:
                continue
            else:
                new_events.append(event)
                new_times.append(event_times[i])
        return new_events, new_times

    def _kiai_before_time(self, events, event_times, time) -> Event:
        for i in range(len(events) - 1, -1, -1):
            if events[i].type == EventType.KIAI and event_times[i] < time:
                return events[i]
        return self._default_special_event("last_kiai")

    def _sv_before_time(self, events, event_times, time) -> Event:
        for i in range(len(events) - 1, -1, -1):
            if events[i].type == EventType.SCROLL_SPEED and event_times[i] < time:
                return events[i]
        return self._default_special_event("last_sv")

    @staticmethod
    def _default_special_event(name: str) -> Event:
        if name == "last_kiai":
            return Event(EventType.KIAI, 0)
        if name == "last_sv":
            return Event(EventType.SCROLL_SPEED, 100)
        raise ValueError(f"Invalid special event name {name}.")

    @staticmethod
    def _convert_column_to_position(events, event_times, key_count):
        new_events, new_times = [], []
        for i, event in enumerate(events):
            if event.type == EventType.MANIA_COLUMN:
                x = int((event.value + 0.5) * 512 / key_count)
                new_events.append(Event(EventType.POS_X, x))
                new_events.append(Event(EventType.POS_Y, 192))
                new_times.append(event_times[i])
                new_times.append(event_times[i])
            else:
                new_events.append(event)
                new_times.append(event_times[i])
        return new_events, new_times

    # -- stats -----------------------------------------------------------------------

    def _reset_generation_stats(self) -> None:
        self.last_generation_stats = {"generated_tokens": 0, "elapsed_seconds": 0.0, "tokens_per_second": 0.0}

    def _record_generation_stats(self, stats) -> None:
        if not isinstance(stats, dict):
            return
        if self.last_generation_stats is None:
            self._reset_generation_stats()
        self.last_generation_stats["generated_tokens"] += int(stats.get("generated_tokens", 0) or 0)
        self.last_generation_stats["elapsed_seconds"] += float(stats.get("elapsed_seconds", 0.0) or 0.0)
        total_s = self.last_generation_stats["elapsed_seconds"]
        total_t = self.last_generation_stats["generated_tokens"]
        self.last_generation_stats["tokens_per_second"] = total_t / total_s if total_s > 0 else 0.0
