"""Beatmap generation on the PyTorch port: the entry points of the repo's
``inference.py`` (``load_model``, ``generate`` and the argument compilation
they need), without super-timing, DiT position refinement, LoRA, int8 or the
batching server.

    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch import inference

    args = load_config("v32")
    args.model_path, args.audio_path, args.output_path = ckpt_dir, "song.wav", "out/"
    engine, vocab = inference.load_model(args)
    inference.compile_args(args, vocab)
    generation_config, beatmap_config = inference.get_config(args)
    osu_text, osu_path = inference.generate(
        args, generation_config=generation_config, beatmap_config=beatmap_config,
        engine=engine, vocab=vocab)

An empty ``model_path`` builds the model from ``args.train`` with seeded
random weights (``args.seed``): the output is a valid but meaningless map.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import uuid
from functools import reduce
from pathlib import Path

import torch

from .config import select_device
from .decode import DecodeEngine
from .infer import GenerationConfig, Preprocessor, Processor, generation_config_from_beatmap
from .models.io import load_checkpoint
from .models.mapperatorinator import Mapperatorinator, build_config
from .models.params import init_params
from .osu import Beatmap, ContextType, build_vocabulary
from .osu.rendering import (
    BeatmapConfig,
    Renderer,
    background_line,
    beatmap_config_from_beatmap,
)
from .osu.streams import TIMING_TYPES, events_of_type, merge_events

DEFAULT_ARGS = {
    "gamemode": 0,
    "hitsounded": True,
    "keycount": 4,
    "hp_drain_rate": 5,
    "circle_size": 4,
    "overall_difficulty": 8,
    "approach_rate": 9,
    "slider_multiplier": 1.4,
    "slider_tick_rate": 1,
    "bpm": 120,
    "offset": 0,
    "title": "Unknown Title",
    "artist": "Unknown Artist",
    "creator": "Mapperatorinator",
    "version": "Mapperatorinator",
    "source": "",
    "preview_time": -1,
}

PRECISIONS = {"fp32": torch.float32, "float32": torch.float32, "bf16": torch.bfloat16,
              "bfloat16": torch.bfloat16, "fp16": torch.bfloat16, "float16": torch.bfloat16}


def get_default_logger():
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    return logging.getLogger("mapperatorinator")


# ---------------------------------------------------------------------------
# argument compilation (the JAX ``inference.py`` helpers of the same names)
# ---------------------------------------------------------------------------


def compile_seed(args, verbose=True) -> None:
    if args.seed is None:
        args.seed = random.randint(0, 2**16)
        if verbose:
            print(f"Random seed: {args.seed}")


def compile_paths(args) -> None:
    beatmap_path = Path(args.beatmap_path) if args.beatmap_path else None
    output_path = Path(args.output_path) if args.output_path else None
    audio_path = Path(args.audio_path) if args.audio_path else None

    if beatmap_path:
        if not beatmap_path.exists():
            raise ValueError(f"Beatmap file not found: {beatmap_path}")
        if beatmap_path.suffix.lower() != ".osu":
            raise ValueError(f"Beatmap file must have .osu extension: {beatmap_path}")
        beatmap = Beatmap.from_path(beatmap_path)
        if not audio_path and beatmap.audio_filename:
            audio_path = beatmap_path.parent / beatmap.audio_filename
        if not output_path:
            output_path = beatmap_path.parent
    elif audio_path and audio_path.exists() and not output_path:
        output_path = audio_path.parent

    if not audio_path:
        raise ValueError("Audio file path is required.")
    if not audio_path.exists():
        raise ValueError(f"Audio file not found: {audio_path}")
    if audio_path.suffix.lower() != ".wav":
        raise ValueError(f"The port reads WAV audio only: {audio_path}")

    args.audio_path = str(audio_path)
    args.output_path = str(output_path) if output_path else ""
    args.beatmap_path = str(beatmap_path) if beatmap_path else ""


def compile_args_from_beatmap(args, vocab, verbose=True) -> None:
    beatmap_path = Path(args.beatmap_path)
    beatmap = Beatmap.from_path(beatmap_path)
    if beatmap.mode not in args.train.data.gamemodes and (
        any(c in (ContextType.MAP, ContextType.GD, ContextType.NO_HS) for c in args.in_context)
        or args.add_to_beatmap
    ):
        raise ValueError(
            f"Reference beatmap mode {beatmap.mode} is not supported by the model. "
            f"Supported modes: {args.train.data.gamemodes}"
        )
    gen_cfg = generation_config_from_beatmap(beatmap, beatmap_path, vocab)
    bm_cfg = beatmap_config_from_beatmap(beatmap)
    autofill = {
        "gamemode": gen_cfg.gamemode,
        "beatmap_id": gen_cfg.beatmap_id,
        "difficulty": gen_cfg.difficulty,
        "mapper_id": gen_cfg.mapper_id,
        "descriptors": gen_cfg.descriptors,
        "hp_drain_rate": gen_cfg.hp_drain_rate,
        "circle_size": gen_cfg.circle_size,
        "overall_difficulty": gen_cfg.overall_difficulty,
        "approach_rate": gen_cfg.approach_rate,
        "slider_multiplier": gen_cfg.slider_multiplier,
        "slider_tick_rate": gen_cfg.slider_tick_rate,
        "hitsounded": gen_cfg.hitsounded,
        "keycount": gen_cfg.keycount,
        "hold_note_ratio": gen_cfg.hold_note_ratio,
        "scroll_speed_ratio": gen_cfg.scroll_speed_ratio,
        "bpm": bm_cfg.bpm,
        "offset": bm_cfg.offset,
        "title": bm_cfg.title,
        "title_unicode": bm_cfg.title_unicode,
        "artist": bm_cfg.artist,
        "artist_unicode": bm_cfg.artist_unicode,
        "creator": bm_cfg.creator,
        "version": bm_cfg.version,
        "source": bm_cfg.source,
        "background": str(beatmap_path.parent / beatmap.background) if beatmap.background else None,
        "preview_time": bm_cfg.preview_time,
    }
    for key, value in autofill.items():
        if getattr(args, key) is None and value is not None:
            setattr(args, key, value)
            if verbose:
                print(f"Using beatmap {key} {value}")


def compile_default_args(args, verbose=True) -> None:
    for key, value in DEFAULT_ARGS.items():
        if getattr(args, key) is None:
            setattr(args, key, value)
            if verbose:
                print(f"Using default {key} {value}")


def compile_derived_args(args) -> None:
    if args.title_unicode is None:
        args.title_unicode = args.title
    if args.artist_unicode is None:
        args.artist_unicode = args.artist
    if args.tags is None:
        args.tags = ""


def compile_args(args, vocab=None, verbose=True) -> None:
    compile_seed(args, verbose=verbose)
    compile_paths(args)
    if args.beatmap_path:
        compile_args_from_beatmap(args, vocab, verbose=verbose)
    else:
        compile_default_args(args, verbose=verbose)
    compile_derived_args(args)


def get_config(args):
    return GenerationConfig(
        gamemode=args.gamemode,
        beatmap_id=args.beatmap_id,
        difficulty=args.difficulty,
        mapper_id=args.mapper_id,
        year=args.year,
        hitsounded=args.hitsounded,
        hp_drain_rate=args.hp_drain_rate,
        circle_size=args.circle_size,
        overall_difficulty=args.overall_difficulty,
        approach_rate=args.approach_rate,
        slider_multiplier=args.slider_multiplier,
        slider_tick_rate=args.slider_tick_rate,
        keycount=args.keycount,
        hold_note_ratio=args.hold_note_ratio,
        scroll_speed_ratio=args.scroll_speed_ratio,
        descriptors=args.descriptors,
        negative_descriptors=args.negative_descriptors,
    ), BeatmapConfig(
        title=str(args.title),
        title_unicode=str(args.title_unicode),
        artist=str(args.artist),
        artist_unicode=str(args.artist_unicode),
        audio_filename=Path(args.audio_path).name,
        hp_drain_rate=args.hp_drain_rate,
        circle_size=(args.keycount if args.gamemode == 3 else args.circle_size) or 4,
        overall_difficulty=args.overall_difficulty,
        approach_rate=args.approach_rate,
        slider_multiplier=args.slider_multiplier,
        slider_tick_rate=args.slider_tick_rate,
        creator=str(args.creator),
        version=str(args.version),
        source=str(args.source or ""),
        tags=str(args.tags or ""),
        background_line=background_line(args.background),
        preview_time=args.preview_time,
        bpm=args.bpm,
        offset=args.offset,
        mode=args.gamemode,
    )


def should_generate_timing_context(args, output_type) -> bool:
    has_empty_or_none = len(args.in_context) == 0 or ContextType.NONE in args.in_context
    supports_timing = any(ContextType.TIMING in ct["out"] for ct in args.train.data.context_types)
    return (
        has_empty_or_none
        and supports_timing
        and any(ct in output_type for ct in (ContextType.TIMING, ContextType.MAP))
    )


# ---------------------------------------------------------------------------
# model loading and generation
# ---------------------------------------------------------------------------


def load_model(args):
    """(engine, vocab) for ``args.model_path`` (a native checkpoint directory),
    on the device ``args.device`` selects, at the compute dtype ``args.precision``
    selects. fp32 runs with TF32 off for matmuls and convolutions."""
    if getattr(args, "lora_path", None):
        raise NotImplementedError("lora_path: LoRA waits for ROADMAP queue 1, item 15")
    for name in ("quantized_weights", "quantized_kv"):
        if getattr(args, name, False):
            raise NotImplementedError(f"{name}: int8 options wait for ROADMAP queue 1, item 14")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = select_device(args)

    model = None
    if args.model_path:
        model, vocab = load_checkpoint(args.model_path)
        vocab = vocab or build_vocabulary(args.train)
        cfg = model.cfg
    else:
        vocab = build_vocabulary(args.train)
        cfg = build_config(args.train, vocab)

    dtype = PRECISIONS.get(str(getattr(args, "precision", "") or "").lower())
    if dtype is not None and dtype != cfg.backbone.dtype:
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(cfg.backbone, dtype=dtype))
    if model is None:
        model = Mapperatorinator(cfg).to(device)
        init_params(model, 0 if args.seed is None else args.seed)
        print(f"No model_path: random weights from seed {args.seed}")
    elif cfg != model.cfg:
        state = model.state_dict()
        model = Mapperatorinator(cfg)
        model.load_state_dict(state)
    # weights are stored at the compute dtype; the mel front end stays fp32
    model = model.to(device=device, dtype=model.cfg.backbone.dtype).eval()
    model.spectrogram.float()
    engine = DecodeEngine(model, max_length=args.train.data.tgt_seq_len, pad_token_id=vocab.pad_id,
                          device=device)
    return engine, vocab


def generate(
    args,
    *,
    generation_config,
    beatmap_config,
    engine,
    vocab,
    audio_path=None,
    beatmap_path=None,
    output_path=None,
    verbose=True,
    logger=None,
):
    """Windowed generation -> .osu text and the path it was written to."""
    if args.super_timing:
        raise NotImplementedError("super_timing: ROADMAP queue 1, item 9")
    if args.generate_positions:
        raise NotImplementedError("generate_positions (DiT refinement): ROADMAP queue 1, item 12")
    if args.use_server:
        raise NotImplementedError("use_server: ROADMAP queue 1, item 9")
    audio_path = args.audio_path if audio_path is None else audio_path
    beatmap_path = args.beatmap_path if beatmap_path is None else beatmap_path
    output_path = args.output_path if output_path is None else output_path
    logger = get_default_logger() if logger is None else logger

    if not Path(audio_path).is_file():
        raise FileNotFoundError(f"Provided audio file path does not exist: {audio_path}")
    if beatmap_path and not Path(beatmap_path).is_file():
        raise FileNotFoundError(f"Provided beatmap file path does not exist: {beatmap_path}")
    if (not output_path) and (not args.add_to_beatmap or not args.overwrite_reference_beatmap or args.export_osz):
        raise ValueError("Output path is required.")

    preprocessor = Preprocessor(args, parallel=args.parallel)
    processor = Processor(args, engine, vocab)
    renderer = Renderer(args, logger=logger)

    audio = preprocessor.load(audio_path)
    sequences = preprocessor.segment(audio)
    extra_in_context = {}
    output_type = list(args.output_type)

    timing_events, timing = None, None
    if should_generate_timing_context(args, output_type):
        timing_events, timing_times = Processor(args, engine, vocab).generate(
            sequences=sequences,
            generation_config=generation_config,
            in_context=[ContextType.NONE],
            out_context=[ContextType.TIMING],
            beatmap_path=beatmap_path,
            verbose=verbose,
        )[0]
        timing_events, timing_times = events_of_type(timing_events, timing_times, TIMING_TYPES)
        timing = renderer.generate_timing(timing_events) if timing_events else None
        if timing:
            extra_in_context[ContextType.TIMING] = timing
        else:
            timing = None
            if verbose:
                logger.warning("timing pass produced no usable timing; falling back to the fixed bpm/offset redline")
        if ContextType.TIMING in output_type:
            output_type.remove(ContextType.TIMING)
    elif ContextType.TIMING in args.in_context or (
        args.train.data.add_timing and any(t in args.in_context for t in (ContextType.GD, ContextType.NO_HS))
    ):
        timing = [tp for tp in Beatmap.from_path(Path(beatmap_path)).timing_points if tp.parent is None]

    if len(output_type) > 0:
        result = processor.generate(
            sequences=sequences,
            generation_config=generation_config,
            in_context=args.in_context,
            out_context=output_type,
            beatmap_path=beatmap_path,
            extra_in_context=extra_in_context,
            verbose=verbose,
        )
        events, _ = reduce(merge_events, result)
        if timing is None and (ContextType.TIMING in args.output_type or args.train.data.add_timing):
            if any(e.type in TIMING_TYPES for e in events):
                timing = renderer.generate_timing(events)
        if args.resnap_events and timing is not None:
            events = renderer.resnap_events(events, timing)
    else:
        events = timing_events

    result_str = renderer.generate(events=events, beatmap_config=beatmap_config, timing=timing)
    if args.add_to_beatmap:
        result_str = renderer.add_to_beatmap(result_str, beatmap_path)
        if verbose:
            logger.info("Merged generated content with reference beatmap")

    if args.add_to_beatmap and args.overwrite_reference_beatmap:
        output_osu_path = Path(beatmap_path)
    else:
        output_osu_path = Path(output_path) / f"beatmap{uuid.uuid4().hex}.osu"

    if args.export_osz:
        result_path = Path(output_path) / f"beatmap{uuid.uuid4().hex}.osz"
        renderer.export_osz(str(result_path), result_str, output_osu_path.name, audio_path, args.background)
        if verbose:
            logger.info(f"Generated .osz saved to {result_path}")
    else:
        result_path = output_osu_path
        renderer.write_result(str(result_path), result_str)
        if verbose:
            logger.info(f"Generated beatmap saved to {result_path}")
    return result_str, result_path
