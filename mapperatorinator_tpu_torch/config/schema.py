"""The structured configuration schema, the JAX package's
(``mapperatorinator_tpu/config/schema.py``) to the letter.

Dataclasses mirror the reference's Hydra config trees field for field, so
the YAML files under ``configs/`` compose into them unchanged (the loader:
:mod:`.loader`). ``tests/test_torch_nojax.py`` holds this file to its
source.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..osu.events import ContextType


@dataclass
class SpectrogramConfig:
    implementation: str = "nnAudio"
    log_scale: bool = False
    sample_rate: int = 16000
    hop_length: int = 128
    n_fft: int = 1024
    n_mels: int = 388
    f_min: int = 0
    f_max: int = 8000
    pad_mode: str = "constant"


@dataclass
class ModelConfig:
    name: str = "openai/whisper-base"
    config_base: str = ""
    input_features: bool = True
    input_raw_wave: bool = False
    project_encoder_input: bool = True
    embed_decoder_input: bool = True
    manual_norm_weights: bool = False
    do_style_embed: bool = False
    do_difficulty_embed: bool = False
    do_mapper_embed: bool = False
    do_song_position_embed: bool = False
    cond_dim: int = 128
    cond_size: int = 0
    rope_type: str = "dynamic"
    rope_encoder_scaling_factor: float = 1.0
    rope_decoder_scaling_factor: float = 1.0
    rope_scaling: dict = field(default_factory=lambda: {"factor": 1.0, "rope_type": "default"})
    deterministic_flash_attn: bool = False
    attention_bias: bool = False
    global_attn_every_n_layers: int = 1
    local_attention: int = 128
    local_rope_theta: int = 10000
    global_rope_theta: int = 10000
    spectrogram: SpectrogramConfig = field(default_factory=SpectrogramConfig)
    overwrite: dict = field(default_factory=dict)
    add_config: dict = field(default_factory=dict)


@dataclass
class DataConfig:
    dataset_type: str = "mmrs"
    train_dataset_path: str = "/workspace/datasets/MMRS39389"
    train_dataset_start: int = 0
    train_dataset_end: int = 38689
    test_dataset_path: str = "/workspace/datasets/MMRS39389"
    test_dataset_start: int = 38689
    test_dataset_end: int = 39389
    src_seq_len: int = 1024
    tgt_seq_len: int = 2048
    sample_rate: int = 16000
    hop_length: int = 128
    cycle_length: int = 16
    per_track: bool = True
    only_last_beatmap: bool = False
    center_pad_decoder: bool = False
    num_classes: int = 152680
    num_diff_classes: int = 24
    max_diff: int = 12
    num_cs_classes: int = 21
    class_dropout_prob: float = 0.2
    diff_dropout_prob: float = 0.2
    mapper_dropout_prob: float = 0.2
    cs_dropout_prob: float = 0.2
    year_dropout_prob: float = 0.2
    hold_note_ratio_dropout_prob: float = 0.2
    scroll_speed_ratio_dropout_prob: float = 0.2
    descriptor_dropout_prob: float = 0.2
    add_out_context_types: bool = True
    add_gamemode_token: bool = True
    add_style_token: bool = False
    add_diff_token: bool = True
    add_mapper_token: bool = True
    add_year_token: bool = True
    add_hitsounded_token: bool = True
    add_song_length_token: bool = True
    add_global_sv_token: bool = True
    add_cs_token: bool = True
    add_keycount_token: bool = True
    add_hold_note_ratio_token: bool = True
    add_scroll_speed_ratio_token: bool = True
    add_descriptors: bool = True
    add_sv_special_token: bool = True
    add_kiai_special_token: bool = True
    add_song_position_token: bool = True
    add_empty_sequences: bool = True
    add_empty_sequences_at_step: int = -1
    add_pre_tokens: bool = False
    add_pre_tokens_at_step: int = -1
    max_pre_token_len: int = -1
    timing_random_offset: int = 2
    timing_random_offset_2: int = 0
    timing_random_offset_prob: float = 1.0
    add_gd_context: bool = False
    min_difficulty: float = 0
    max_difficulty: float = 100
    sample_weights_path: str = ""
    rhythm_weight: float = 3.0
    label_smoothing: float = 0.0
    lookback: float = 0
    lookahead: float = 0
    lookback_prob: float = 0.0
    context_types: list = field(
        default_factory=lambda: [
            {"in": [ContextType.NONE], "out": [ContextType.TIMING, ContextType.KIAI, ContextType.MAP, ContextType.SV]},
            {"in": [ContextType.NO_HS], "out": [ContextType.TIMING, ContextType.KIAI, ContextType.MAP, ContextType.SV]},
            {"in": [ContextType.GD], "out": [ContextType.TIMING, ContextType.KIAI, ContextType.MAP, ContextType.SV]},
        ]
    )
    context_weights: list = field(default_factory=lambda: [4, 1, 1])
    descriptors_path: str = ""
    mappers_path: str = ""
    add_timing: bool = False
    add_snapping: bool = True
    add_timing_points: bool = True
    add_hitsounds: bool = True
    add_distances: bool = True
    add_positions: bool = True
    position_precision: int = 32
    position_split_axes: bool = False
    position_range: list = field(default_factory=lambda: [-256, 768, -256, 640])
    dt_augment_prob: float = 0.5
    dt_augment_range: list = field(default_factory=lambda: [1.25, 1.5])
    dt_augment_sqrt: bool = False
    flip_horizontal_prob: float = 0.0
    augment_flip: bool = False  # classifier-style 50/50 flip augmentation
    flip_vertical_prob: float = 0.0
    types_first: bool = True
    add_kiai: bool = True
    gamemodes: list = field(default_factory=lambda: [0, 1, 2, 3])
    mania_bpm_normalized_scroll_speed: bool = True
    add_sv: bool = True
    add_mania_sv: bool = False
    min_year: Optional[int] = None
    max_year: Optional[int] = None
    frame_offset_augment_prob: float = 1.0
    normalize_audio: bool = True
    slider_version: int = 1
    snapping_random_prob: float = 0.0
    sustain_interval: Optional[int] = None
    position_refinement: Optional[int] = None
    descriptor_source: str = "omdb"
    min_top_tag_count: int = 2
    tags_metadata_path: str = ""
    ranked_statuses: list = field(default_factory=lambda: [1, 2])
    dataset_subset: Optional[str] = None
    train_dataset_streaming: bool = True
    test_dataset_streaming: bool = False


@dataclass
class DataloaderConfig:
    num_workers: int = 8
    pin_memory: bool = True
    drop_last: bool = False
    balancer_buffer_size: int = 0
    balancer_prefetch_factor: float = 0.5


@dataclass
class OptimizerConfig:
    name: str = "adamwscale"
    base_lr: float = 1e-2
    base_lr_2: float = 3e-4
    batch_size: int = 128
    total_steps: int = 65536
    warmup_steps: int = 10000
    sustain_steps: int = 0
    lr_scheduler: str = "cosine"
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    grad_acc: int = 8
    final_cosine: float = 1e-5


@dataclass
class EvalConfig:
    every_steps: int = 1000
    steps: int = 500


@dataclass
class CheckpointConfig:
    every_steps: int = 5000
    local_total_limit: int = 2
    cleanup_wandb_cache_before_save: bool = True
    wandb_cache_cleanup_size: str = "1GB"


@dataclass
class LoggingConfig:
    log_with: str = "tensorboard"
    every_steps: int = 10
    grad_l2: bool = True
    weights_l2: bool = True
    mode: str = "online"
    run_name: Optional[str] = None


@dataclass
class ProfileConfig:
    do_profile: bool = False
    early_stop: bool = False
    wait: int = 8
    warmup: int = 8
    active: int = 8
    repeat: int = 1


@dataclass
class LoraMetadataConfig:
    ckpt_subfolders: Optional[list] = None


@dataclass
class ParallelConfig:
    """TPU mesh layout — new in this framework (no reference equivalent;
    the reference only has DDP, SURVEY.md §2.7)."""

    mesh_shape: Optional[list] = None  # e.g. [8] or [2, 4]; None = all devices on "data"
    axis_names: list = field(default_factory=lambda: ["data"])
    # Name of the mesh axis each parallelism form maps to (None = unused).
    data_axis: Optional[str] = "data"
    tensor_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    remat: bool = False  # jax.checkpoint the encoder/decoder blocks
    # "full" recomputes everything; "dots" keeps matmul outputs resident
    # (checkpoint_dots_with_no_batch_dims_saveable) — faster backward for a
    # modest memory bump
    remat_policy: str = "full"
    # Multi-host coordinates (torchrun multi-node equivalent, SURVEY §2.7
    # item 1): set coordinator_address=host:port num_processes=N process_id=i
    # on every process and train.py spans one mesh over all of them, with the
    # process (DCN) boundary on the leading data axis. All None = single host.
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # cross-process collectives for the CPU backend (virtual-device dryruns)
    cpu_collectives: str = "gloo"


@dataclass
class TrainConfig:
    compile: bool = True
    device: str = "tpu"
    mixed_precision: Optional[str] = "bf16"
    precision: Optional[str] = None
    attn_implementation: str = "sdpa"
    seed: int = 42
    checkpoint_path: str = ""
    pretrained_path: str = ""
    pretrained_gamemode: Optional[int] = None
    pretrained_t5_compat: bool = False
    enable_lora: bool = False
    lora: dict = field(default_factory=dict)
    lora_metadata: LoraMetadataConfig = field(default_factory=LoraMetadataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    hydra: Any = None
    mode: str = "train"


# ---------------------------------------------------------------------------
# Diffusion configs (reference: osu_diffusion/config.py:12-99)
# ---------------------------------------------------------------------------


@dataclass
class DiffusionModelConfig:
    model: str = "DiT-B"
    noise_schedule: str = "squaredcos_cap_v2"
    l1_loss: bool = False
    diffusion_steps: int = 1000
    max_diffusion_step: int = 100
    context_size: int = 272
    # timestep draw: "uniform" (reference train.py:192 behavior) or
    # "loss-second-moment" importance resampling (timestep_sampler.py:120)
    schedule_sampler: str = "uniform"


@dataclass
class DiffusionDataConfig:
    train_dataset_path: str = "/workspace/datasets/ORS16291/"
    start: int = 0
    end: int = 16291
    shuffle: bool = True
    seq_len: int = 128
    stride: int = 16
    cycle_length: int = 64
    beatmap_class: bool = False
    difficulty_class: bool = True
    mapper_class: bool = True
    descriptor_class: bool = True
    circle_size_class: bool = True
    class_dropout_prob: float = 0.2
    diff_dropout_prob: float = 0.2
    mapper_dropout_prob: float = 0.2
    descriptor_dropout_prob: float = 0.2
    cs_dropout_prob: float = 0.2
    descriptors_path: str = "../../../datasets/beatmap_descriptors.csv"
    mappers_path: str = "../../../datasets/beatmap_users.json"
    num_diff_classes: int = 26
    max_diff: int = 12
    num_cs_classes: int = 22
    double_time_prob: float = 0.5
    distance_std: float = 0.1


@dataclass
class DiffusionDataloaderConfig:
    num_workers: int = 4


@dataclass
class DiffusionOptimizerConfig:
    name: str = "adamw"
    base_lr: float = 2e-4
    batch_size: int = 256
    total_steps: int = 400000
    warmup_steps: int = 10000
    sustain_steps: int = 0
    lr_scheduler: str = "cosine"
    weight_decay: float = 0.0
    grad_acc: int = 2
    grad_clip: float = 1.0
    final_cosine: float = 1e-5


@dataclass
class DiffusionCheckpointConfig:
    every_steps: int = 5000


@dataclass
class DiffusionLoggingConfig:
    log_with: str = "tensorboard"
    every_steps: int = 10
    mode: str = "online"


@dataclass
class DiffusionTrainConfig:
    compile: bool = True
    device: str = "tpu"
    precision: str = "bf16"
    seed: int = 0
    checkpoint_path: str = ""
    model: DiffusionModelConfig = field(default_factory=DiffusionModelConfig)
    data: DiffusionDataConfig = field(default_factory=DiffusionDataConfig)
    dataloader: DiffusionDataloaderConfig = field(default_factory=DiffusionDataloaderConfig)
    optim: DiffusionOptimizerConfig = field(default_factory=DiffusionOptimizerConfig)
    checkpoint: DiffusionCheckpointConfig = field(default_factory=DiffusionCheckpointConfig)
    logging: DiffusionLoggingConfig = field(default_factory=DiffusionLoggingConfig)
    hydra: Any = None


# ---------------------------------------------------------------------------
# Classifier config (reference: classifier/configs/train.yaml)
# ---------------------------------------------------------------------------


@dataclass
class ClassifierModelConfig:
    name: str = "whisper_base"
    d_model: int = 512
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_heads: int = 8
    decoder_heads: int = 8
    encoder_ffn: int = 2048
    decoder_ffn: int = 2048
    classifier_proj_size: int = 256
    input_features: bool = False
    # backbone scheme — set to the pretrained checkpoint's family when
    # transfer-learning (e.g. rope/rms for a v32 osuT5 checkpoint)
    position_scheme: str = "whisper_abs"
    norm: str = "layer"
    # vocab-construction flags (the classifier labels need the mapper tables)
    do_mapper_embed: bool = True
    do_style_embed: bool = False
    spectrogram: SpectrogramConfig = field(default_factory=SpectrogramConfig)


@dataclass
class ClassifierConfig:
    compile: bool = True
    device: str = "tpu"
    precision: str = "bf16"
    seed: int = 42
    checkpoint_path: str = ""
    pretrained_path: str = ""
    model_path: str = ""  # classify entry: trained model to load
    beatmap_path: str = ""  # classify entry: beatmap to classify
    audio_path: str = ""  # classify entry: audio (defaults to beatmap's)
    mappers_path: str = ""  # classify entry: beatmap_users.json for usernames
    data: DataConfig = field(default_factory=DataConfig)
    model: ClassifierModelConfig = field(default_factory=ClassifierModelConfig)
    dataloader: DataloaderConfig = field(default_factory=DataloaderConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    hydra: Any = None


# ---------------------------------------------------------------------------
# Rhythm-complexion config (reference: rcomplexion/configs/train.yaml)
# ---------------------------------------------------------------------------


@dataclass
class RcomplexionDataConfig:
    train_dataset_path: str = "/root/ORS16291"
    train_dataset_start: int = 0
    train_dataset_end: int = 16200
    test_dataset_path: str = "/root/ORS16291"
    test_dataset_start: int = 16200
    test_dataset_end: int = 16291
    src_seq_len: int = 32
    cycle_length: int = 32
    min_difficulty: float = 0
    time_resolution: float = 0.1  # steps per millisecond
    min_time: float = 0
    max_time: float = 1000
    sample_weights: str = ""


@dataclass
class RcomplexionModelConfig:
    hidden_size: int = 128


@dataclass
class RcomplexionConfig:
    compile: bool = True
    device: str = "tpu"
    precision: str = "bf16"
    seed: int = 42
    checkpoint_path: str = ""
    model_path: str = ""  # inference: trained model to load
    data: RcomplexionDataConfig = field(default_factory=RcomplexionDataConfig)
    model: RcomplexionModelConfig = field(default_factory=RcomplexionModelConfig)
    dataloader: DiffusionDataloaderConfig = field(default_factory=DiffusionDataloaderConfig)
    optim: DiffusionOptimizerConfig = field(default_factory=DiffusionOptimizerConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    checkpoint: DiffusionCheckpointConfig = field(default_factory=DiffusionCheckpointConfig)
    logging: DiffusionLoggingConfig = field(default_factory=DiffusionLoggingConfig)
    hydra: Any = None


# ---------------------------------------------------------------------------
# Inference config (reference: config.py:15-113)
# ---------------------------------------------------------------------------


@dataclass
class InferenceConfig:
    model_path: str = ""
    audio_path: Optional[str] = None
    output_path: Optional[str] = None
    beatmap_path: Optional[str] = None
    lora_path: Optional[str] = None
    auto_select_gamemode_model: bool = True

    gamemode: Optional[int] = None
    beatmap_id: Optional[int] = None
    difficulty: Optional[float] = None
    mapper_id: Optional[int] = None
    year: Optional[int] = None
    hitsounded: Optional[bool] = None
    keycount: Optional[int] = None
    hold_note_ratio: Optional[float] = None
    scroll_speed_ratio: Optional[float] = None
    descriptors: Optional[list] = None
    negative_descriptors: Optional[list] = None

    hp_drain_rate: Optional[float] = None
    circle_size: Optional[float] = None
    overall_difficulty: Optional[float] = None
    approach_rate: Optional[float] = None
    slider_multiplier: Optional[float] = None
    slider_tick_rate: Optional[float] = None

    seed: Optional[int] = None
    device: str = "auto"
    precision: str = "fp32"
    # TPU extension (no reference equivalent): int8 weight-only decode via the
    # fused Pallas qmm kernel — halves weight HBM at bf16-parity speed (PERF.md)
    quantized_weights: bool = False
    # TPU extension: int8 KV cache — halves the cache HBM reads that bound
    # long batched decodes (+22% on the attention step at batch 8, PERF.md);
    # ~1% attention error, so generated tokens may diverge from bf16
    quantized_kv: bool = False
    attn_implementation: str = "auto"
    add_to_beatmap: bool = False
    overwrite_reference_beatmap: bool = False
    export_osz: bool = False
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    lookback: float = 0.5
    lookahead: float = 0.4
    timing_leniency: int = 20
    in_context: list = field(default_factory=lambda: [ContextType.NONE])
    output_type: list = field(default_factory=lambda: [ContextType.MAP])
    cfg_scale: float = 1.0
    temperature: float = 1.0
    timing_temperature: float = 0.1
    mania_column_temperature: float = 0.5
    taiko_hit_temperature: float = 0.5
    timeshift_bias: float = 0.0
    top_p: float = 0.95
    top_k: int = 0
    parallel: bool = False
    do_sample: bool = True
    num_beams: int = 1
    super_timing: bool = False
    timer_num_beams: int = 1
    timer_bpm_threshold: float = 0.7
    timer_cfg_scale: float = 1.0
    timer_iterations: int = 20
    use_server: bool = True
    max_batch_size: int = 16
    # compile the engine's prompt-bucket prefill ladder at startup (serving
    # warmup; decode loops still compile on the first request per pipeline)
    precompile: bool = False
    resnap_events: bool = True
    snap_near_perfect_overlaps: bool = True

    bpm: Optional[int] = None
    offset: Optional[int] = None
    title: Optional[str] = None
    title_unicode: Optional[str] = None
    artist: Optional[str] = None
    artist_unicode: Optional[str] = None
    creator: Optional[str] = None
    version: Optional[str] = None
    source: Optional[str] = None
    tags: Optional[str] = None
    background: Optional[str] = None
    preview_time: Optional[int] = None

    generate_positions: bool = True
    diff_cfg_scale: float = 1.0
    compile: bool = False
    pad_sequence: bool = False
    diff_ckpt: str = ""
    diff_refine_ckpt: str = ""
    beatmap_idx: str = "osu_diffusion/beatmap_idx.pickle"
    refine_iters: int = 10
    random_init: bool = False
    timesteps: list = field(default_factory=lambda: [100, 0, 0, 0, 0, 0, 0, 0, 0, 0])
    max_seq_len: int = 1024
    overlap_buffer: int = 128

    train: TrainConfig = field(default_factory=TrainConfig)
    diffusion: DiffusionTrainConfig = field(default_factory=DiffusionTrainConfig)
    hydra: Any = None


@dataclass
class FidConfig:
    """Evaluation-harness config (reference: config.py:115-146)."""

    num_processes: int = 3
    device: str = "auto"
    compile: bool = False

    skip_generation: bool = False
    fid: bool = True
    fid_cm3p: bool = True
    rhythm_stats: bool = True
    extra_stats: bool = True

    dataset_type: str = "ors"
    dataset_path: str = "/workspace/datasets/ORS16291"
    dataset_start: int = 16200
    dataset_end: int = 16291
    gamemodes: list = field(default_factory=lambda: [0])
    min_year: Optional[int] = None
    max_year: Optional[int] = None
    min_difficulty: Optional[float] = None
    max_difficulty: Optional[float] = None

    classifier_ckpt: str = "OliBomby/osu-classifier"
    classifier_batch_size: int = 16

    cm3p_ckpt: str = "OliBomby/CM3P"
    cm3p_batch_size: int = 16

    training_set_ids_path: Optional[str] = None

    inference: InferenceConfig = field(default_factory=InferenceConfig)
    hydra: Any = None


@dataclass
class MaiModConfig:
    """AI-modding config (reference: config.py:149-155)."""

    beatmap_path: str = ""
    audio_path: str = ""
    raw_output: bool = False
    precision: str = "fp32"
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    hydra: Any = None
