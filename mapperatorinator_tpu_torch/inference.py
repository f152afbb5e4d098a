"""Beatmap generation on the PyTorch port: the entry points of the repo's
``inference.py`` (``main`` / ``run``, ``load_model``, ``generate`` and the
argument compilation they need), with int8 weights and KV cache, the
super-timing ensemble (``super_timing=true``), a separate timing model (the
base checkpoint beside an auto-selected ``gamemode=N`` fine-tune) and the
cross-process batching server (``use_server=true``), a LoRA adapter merged
at load (``lora_path``) and DiT position refinement (``generate_positions=true``
with ``diff_ckpt`` and, optionally, ``diff_refine_ckpt``: bundles of
``dit_config.json`` and ``params.msgpack``, see :func:`load_diffusion_model`).

From the command line, on the card unless ``device=cpu`` is given:

    python -m mapperatorinator_tpu_torch.inference -cn v32 model_path=ckpt/ \
        audio_path=song.wav output_path=out/ quantized_weights=true quantized_kv=true

From Python:

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

``model_path`` names a native checkpoint or a published (HF-format) one:
``config.json`` with ``model.safetensors`` or ``pytorch_model*.bin``, as
the presets' repositories hold them (``-cn v29`` and ``-cn v28`` serve the
stock whisper models). An empty ``model_path`` builds the model from
``args.train`` with seeded random weights (``args.seed``): the output is a
valid but meaningless map.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import sys
import uuid
from functools import reduce
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .config import load_config, parse_argv, select_device
from .decode import DecodeEngine
from .infer import GenerationConfig, Preprocessor, Processor, generation_config_from_beatmap
from .infer.diffusion_pipeline import DiffusionPipeline
from .infer.server import InferenceClient, InferenceServer, get_server_address, make_engine_generate_fn
from .infer.super_timing import SuperTimingGenerator
from .models.io import load_checkpoint, load_dit_bundle, quantize_model
from .models.lora import (get_model_checkpoint_subfolder, load_lora, merge_lora_into, resolve_compatible_lora_path,
                          resolve_model_checkpoint_path)
from .models.mapperatorinator import build_config, build_model
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

    valid_ext = {".mp3", ".wav", ".ogg", ".m4a", ".flac"}
    if not audio_path:
        raise ValueError("Audio file path is required.")
    if not audio_path.exists():
        raise ValueError(f"Audio file not found: {audio_path}")
    if audio_path.suffix.lower() not in valid_ext:
        raise ValueError(f"Audio file must have one of: {', '.join(sorted(valid_ext))}: {audio_path}")

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


def load_model(args, auto_select_gamemode_model: Optional[bool] = None):
    """(engine, vocab) for ``args.model_path`` (a native or a published
    HF-format checkpoint directory, :func:`.models.io.load_checkpoint`, or
    its ``gamemode=N`` fine-tune subfolder when one exists and
    ``auto_select_gamemode_model``, by default ``args.auto_select_gamemode_model``,
    allows it), on the device ``args.device`` selects, at the compute dtype
    ``args.precision`` selects, with int8 weights (``quantized_weights``) and
    an int8 KV cache (``quantized_kv``) when asked. A LoRA adapter at
    ``args.lora_path`` whose metadata admits the checkpoint's ``gamemode=N``
    subfolder is merged into the stored weights first, at its ``lora_alpha``,
    before any quantization or cast, as in the JAX ``load_model``; then
    :func:`serving_engine`."""
    if auto_select_gamemode_model is None:
        auto_select_gamemode_model = getattr(args, "auto_select_gamemode_model", True)
    device = select_device(args)

    if args.model_path:
        ckpt_path = resolve_model_checkpoint_path(args.model_path, gamemode=args.gamemode,
                                                  auto_select_gamemode_model=auto_select_gamemode_model)
        if str(ckpt_path) != str(args.model_path):
            print(f"Using gamemode-specific model checkpoint: {ckpt_path}")
        model, vocab = load_checkpoint(ckpt_path)
        vocab = vocab or build_vocabulary(args.train)
        model = model.to(device)
    else:
        vocab = build_vocabulary(args.train)
        model = build_model(build_config(args.train, vocab), device)
        init_params(model, 0 if args.seed is None else args.seed)
        print(f"No model_path: random weights from seed {args.seed}")
        ckpt_path = None

    lora_path, _ = resolve_compatible_lora_path(getattr(args, "lora_path", None),
                                                get_model_checkpoint_subfolder(ckpt_path))
    if lora_path is not None:
        adapter, lora_config = load_lora(lora_path, model)
        merge_lora_into(model, adapter, alpha=lora_config.get("lora_alpha", 128.0))
        print(f"Loaded LoRA weights from {lora_path}")
    return serving_engine(model, vocab, args, device)


def serving_engine(model, vocab, args, device: torch.device):
    """(engine, vocab) serving ``model`` on ``device`` as :func:`load_model`
    serves a checkpoint's: int8 weights (``quantized_weights``) and KV cache
    (``quantized_kv``) when ``args`` ask, the compute dtype of
    ``args.precision`` (default: the model's), the decode buffer of
    ``args.train.data.tgt_seq_len``. A model loaded another way (a legacy
    accelerate checkpoint, :func:`.models.legacy.load_legacy_checkpoint`)
    is served through it too. fp32 runs with TF32 off for matmuls and
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model.to(device)
    # int8 weights come from the stored ones, before any cast to the compute
    # dtype; the cast leaves the int8 kernels and their fp32 scales as they are
    if getattr(args, "quantized_weights", False):
        model = quantize_model(model)
        print("Quantized decode weights to int8 (weight-only, fused qmm kernel)")
    backbone = model.cfg.backbone
    dtype = PRECISIONS.get(str(getattr(args, "precision", "") or "").lower(), backbone.dtype)
    if getattr(args, "quantized_kv", False):
        backbone = dataclasses.replace(backbone, quantized_kv=True)
        print("Using int8 KV cache for decode")
    cfg = dataclasses.replace(model.cfg, backbone=dataclasses.replace(backbone, dtype=dtype))
    if cfg != model.cfg:
        state = model.state_dict()
        model = build_model(cfg, device)
        model.load_state_dict(state)
    # weights are held at the compute dtype; the mel front end and the
    # conditioning embedders stay fp32
    model = model.to_compute_dtype().eval()
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
    timing_engine=None,
    timing_vocab=None,
    verbose=True,
    logger=None,
    client=None,
    diff_model=None,
    refine_model=None,
):
    """Windowed generation -> .osu text and the path it was written to.
    Timing comes from the super-timing ensemble (``super_timing``), else from
    a TIMING pass, on ``timing_engine`` when one is given; ``client`` routes
    the decode calls (the separate timing model's excepted) to the batching
    server. With ``generate_positions``, a MAP output in gamemode 0 or 2 and
    a DiT ``diff_model`` (:func:`load_diffusion_model`), the hit objects'
    positions are then sampled anew by the diffusion pipeline (whose class
    vocabulary is that of ``args.diffusion``), refined by ``refine_model``
    where one is given."""
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
    processor = Processor(args, engine, vocab, client=client)
    renderer = Renderer(args, logger=logger)

    audio = preprocessor.load(audio_path)
    sequences = preprocessor.segment(audio)
    extra_in_context = {}
    output_type = list(args.output_type)
    timing_engine = engine if timing_engine is None else timing_engine
    timing_vocab = vocab if timing_vocab is None else timing_vocab

    timing_events, timing = None, None
    if args.super_timing and (len(args.in_context) == 0 or ContextType.NONE in args.in_context):
        stg = SuperTimingGenerator(args, timing_engine, timing_vocab)
        timing_events, _ = stg.generate(audio, generation_config, verbose=verbose)
        timing = renderer.generate_timing(timing_events) if timing_events else None
        if timing:
            extra_in_context[ContextType.TIMING] = timing
        else:
            timing = None
            if verbose:
                logger.warning("super-timing ensemble produced no usable timing; falling back to the fixed "
                               "bpm/offset redline")
        if ContextType.TIMING in output_type:
            output_type.remove(ContextType.TIMING)
    elif should_generate_timing_context(args, output_type):
        timing_processor = Processor(args, timing_engine, timing_vocab,
                                     client=client if timing_engine is engine else None)
        timing_events, timing_times = timing_processor.generate(
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

    if (args.generate_positions and args.gamemode in (0, 2) and ContextType.MAP in output_type
            and diff_model is not None):
        pipeline = DiffusionPipeline(args, diff_model, refine_model)
        events = pipeline.generate(events=events, generation_config=generation_config, timing=timing, verbose=verbose)

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


def load_diffusion_model(ckpt_path, device) -> Optional[torch.nn.Module]:
    """The DiT of a bundle that the JAX ``diffusion_train.py`` exports (or
    :func:`.models.io.save_dit_bundle` writes): ``dit_config.json`` and
    ``params.msgpack``, in fp32 on ``device``; None when ``ckpt_path`` is
    empty or holds no ``params.msgpack``, as in JAX."""
    path = Path(ckpt_path) if ckpt_path else None
    if path is None or not (path / "params.msgpack").exists():
        return None
    return load_dit_bundle(path).to(device).eval()


def main(argv=None):
    """``python -m mapperatorinator_tpu_torch.inference [-cn NAME] key=value ...``:
    the configuration ``configs/inference/NAME.yaml`` (default v32) with the overrides,
    then :func:`run`. Returns what :func:`generate` returns."""
    config_name, overrides, _ = parse_argv(sys.argv[1:] if argv is None else argv, "v32", {})
    return run(load_config(config_name, overrides))


def should_load_separate_timing_model(args, output_type=None) -> bool:
    """True when a gamemode fine-tune was auto-selected but timing must be
    generated: timing then comes from the base (all-gamemode) checkpoint."""
    output_type = args.output_type if output_type is None else output_type
    needs_generated_timing = (
        args.super_timing and (len(args.in_context) == 0 or ContextType.NONE in args.in_context)
    ) or should_generate_timing_context(args, output_type)
    if not needs_generated_timing:
        return False
    current = resolve_model_checkpoint_path(args.model_path, gamemode=args.gamemode,
                                            auto_select_gamemode_model=args.auto_select_gamemode_model)
    base = resolve_model_checkpoint_path(args.model_path, gamemode=args.gamemode, auto_select_gamemode_model=False)
    return str(current) != str(base)


# the conditions a warm-up encodes with: the Processor's defaults (difficulty
# 5, no mapper) over the whole song; a model uses those its config embeds
WARM_COND = {"difficulty": np.full(1, 5.0, np.float32), "mapper_idx": np.full(1, -1, np.int32),
             "song_position": np.array([[0.0, 1.0]], np.float32)}


def warm_engine(engine, train_args) -> None:
    """Allocate the engine's decode buffers and run its prompt-bucket prefill
    ladder for the serving batch shapes (B 1, the timing pass; B 2, the CFG
    pair) ahead of the first request (``precompile=true``). The JAX warm-up
    encodes with no condition, which a conditioned model (v30, v31) cannot;
    this one gives it ``WARM_COND``."""
    n = (train_args.data.src_seq_len - 1) * train_args.data.hop_length
    enc = engine.encode_with_cond(np.zeros((1, n), np.float32), WARM_COND)
    engine.precompile(enc)
    engine.precompile(torch.cat([enc, enc]))


def run(args):
    """Everything after the configuration: load the model (and the base
    checkpoint for timing when :func:`should_load_separate_timing_model`
    says so), compile the arguments, warm the engines when ``precompile`` is
    set, start or join the batching server when ``use_server`` is set, load
    the DiT bundles when ``generate_positions`` is set, generate."""
    engine, vocab = load_model(args)
    compile_args(args, vocab)

    timing_engine, timing_vocab = None, None
    if should_load_separate_timing_model(args):
        print("Using base model for timing generation.")
        timing_engine, timing_vocab = load_model(args, auto_select_gamemode_model=False)

    if getattr(args, "precompile", False):
        warm_engine(engine, args.train)
        if timing_engine is not None:
            warm_engine(timing_engine, args.train)

    client = None
    if args.use_server:
        # the first process serves its engine from a thread of its own;
        # further processes of the same model connect to it
        sock = get_server_address(args.model_path, getattr(args, "lora_path", None), args.gamemode)
        client = InferenceClient(
            server_factory=lambda: InferenceServer(make_engine_generate_fn(engine, vocab),
                                                   max_batch_size=args.max_batch_size, socket_path=sock),
            socket_path=sock,
        )

    diff_model, refine_model = None, None
    if args.generate_positions:
        device = select_device(args)
        diff_model = load_diffusion_model(args.diff_ckpt, device)
        refine_model = load_diffusion_model(args.diff_refine_ckpt, device)
        if diff_model is None:
            print(f"diffusion checkpoint {args.diff_ckpt!r} not found; positions stay as generated")

    generation_config, beatmap_config = get_config(args)
    return generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                    engine=engine, vocab=vocab, client=client, timing_engine=timing_engine,
                    timing_vocab=timing_vocab, diff_model=diff_model, refine_model=refine_model)


if __name__ == "__main__":
    main()
