#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

1. Exits non-zero when no CUDA device is visible; there is no CPU path.
2. Builds the port's kernels from ``mapperatorinator_tpu_torch/csrc`` (one
   compiler per source, in parallel): the flash-attention forward and
   backward on two routes (fp32 as split-TF32 tensor-core products,
   ``flash_attention.cu``; bf16 tensor cores, ``flash_attention_sm90.cu``),
   the fused mel, the int8
   matrix product, and the host star-rating library.
3. Holds each kernel against its plain PyTorch version on the card at the
   v32 shapes, printing the largest absolute error beside its tolerance and
   the median times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call. Each attention pair is held
   against both the plain versions that round where it rounds and the fp32
   ones, and timed beside SDPA: the fp32 pair at the serving call and the
   three calls of an fp32 training micro-step, beside two bounds (fp32 FMAs,
   and three TF32 products for each fp32 one), the bf16 pair at the three
   calls of a bf16 training micro-step. Each attention bound counts the
   (query, key) pairs that the masks leave, not the whole T x S that the
   kernels compute. Kernel D is held on both its paths (a GEMV up to 4
   rows, the tensor cores above, the latter also against the plain version
   that rounds as it does), each with its own entry in the kernels line;
   the GEMV is timed with a cold L2 at a decode step's five shapes, as a
   step finds it, beside the host cost of each piece of its call and the
   device time of each column tile. Kernel A (the fused mel, split-TF32
   tensor-core products) is held against both its plain versions (the one
   that rounds as it does, and fp32) at 1e-4 and at the reference's bar, with
   a float64 reference beside them and two calls bit-equal, at one v32 window,
   at two (CFG), at 32 (a LoRA micro-step) and at one v31 window (4 096
   frames, 80 mels), each timed beside its plain version and its bounds. B
   is also held and timed at a v31 encoder window (B 1, T = S = 2 048), and
   held at v31 MaiMod's decoder shapes (causal self-attention at T 1 010
   with a key mask, cross-attention at T 1 010 over S 2 048); D's tensor
   cores at its 2 048-row products. A
   device time is the sum of the profiler's device kernels only
   (``device_kernels``), so a kernel launched through an op counts once.
   Then the config layer (``config_phase``): the 24 files of ``configs/``
   that the scripts compose and the port's three backbone presets, through
   the port's own YAML reader and loader (``yaml`` is not imported), timed;
   ``-cn v32 model.spectrogram.hop_length=256`` must give
   ``data.hop_length`` 256, and the model's mel front end built from that
   config runs kernel A once on one window at hop 256 (a main-path launch),
   which is then held against both its plain versions and timed.
4. Serving: three requests through ``mapperatorinator_tpu_torch.inference``
   (``load_model`` / ``generate``) on the full-width v32 model (d_model 768,
   12 + 12 layers, 12 heads, ffn 3072, 2048 source / 2560 target tokens) with
   seeded random weights on a synthesized ~20 s WAV: the v32 defaults
   (sampled, TIMING + MAP + SV), then greedy decode with the fused mel
   kernel, then greedy decode from a checkpoint the script writes with the
   port's ``save_checkpoint``, loaded with int8 weights (kernel D) and an
   int8 KV cache. Each must write a .osu that the repo's parser reads; on
   request 1's first window the encoder states through the flash kernel must
   match the plain attention path; on request 3's, the teacher-forced logits
   through kernel D must match its plain version, and the int8 model must
   stay within the reference's bars of the fp model loaded from the same
   checkpoint. ``DecodeEngine.generate`` replays a CUDA graph of its decode
   step a token (one graph a bucket of cached slots, captured when first
   reached); each request prints the graphs captured and the seconds spent
   capturing. On request 3's first window, the "decode graphs" phase holds
   ``generate`` replaying graphs against the same engine stepping eagerly
   (``use_graphs`` cleared), with int8 weights and KV and with the fp32
   model from the same checkpoint, at B 1 and as a CFG pair, greedy and
   sampled: tokens and the returned position must be equal. It prints the
   graphs captured, the seconds spent capturing and each engine's graph
   pool bytes. The decode steps are then profiled in both modes (host and
   device ms a step, the device's idle share, kernel D's GEMV found by name
   inside the replays). Request 3's engine then runs ``forward_stats``,
   ``generate_forced`` and ``generate_beams`` against ``forward`` and
   ``generate``. Three more phases on the full-width v32 model follow:
   MaiMod (``mai_mod.ai_mod``, as ``run_analysis`` runs it) on request 2's
   .osu, or on a dense map where that one has no timing point, whose
   teacher-forced decoder must launch kernel B (36 launches a batch), its
   first batch's ``forward_stats`` held against plain attention;
   ``generate`` with ``super_timing=true`` at 10 ensemble members (v32 has 20),
   every pooled window decoded on the graphed step at up to 32 rows; and the
   batching server (``infer/server.py``) in this process, two greedy
   requests from two client threads batched together on its batch thread,
   whose first batch of more than one row must decode to the same tokens
   when the engine glue is called on it directly. Then v31 at full width
   (``v31_phase``: RoPEWhisper-small with the difficulty, mapper and
   song-position embedders, 4 096 source frames, an 8 192-slot decode
   buffer, seeded random weights): its defaults (sampled, TIMING + KIAI +
   MAP + SV) at a set difficulty and mapper, then greedy from a checkpoint
   of those weights whose config picks the fused mel, with int8 weights
   and KV (A, B, D) and then ``precompile=true``'s warm-up at the 8 192
   slots, each request's first window encoded with its conditions through
   the kernels and held against the plain path (another difficulty must
   move the states); and MaiMod under the v30 preset on a taiko map, which
   must fall back to v31 at that checkpoint, through the same checks as
   v32's MaiMod (``maimod_run``: 36 B launches a batch, the first batch
   held against plain attention at T up to 1 010 over 2 048 source
   positions). Then DiT position refinement at full width (``dit_phase``:
   DiT-B of ``configs/diffusion/v1.yaml``, 48 classes, every tensor drawn
   from a seeded N(0, 0.02), written as a diffusion and a refine bundle and
   loaded with ``load_diffusion_model``): kernel B at the DiT's calls (a
   1 024-row bucket with the band |q - k| <= 128 and a key mask over its
   padding, and a refine chunk's unbucketed length) against both plain
   versions and timed beside SDPA with the same mask; a DiT forward and a
   ``p_sample`` step through the kernel against the plain path; the
   pipeline on a synthesized song of 1 500 hit objects with sliders of
   four curve types, parsed as v31 writes positions (DISTANCE, POS_X,
   POS_Y) and sampled under v32's schedule (two chunks, the slider ends
   in-painted on the host each step, 100 DDPM and 10 refine steps a
   chunk), 12 forward launches a DiT forward and nothing else of B, C or
   D, its positions finite and written into the events, then again through
   the plain path, the difference printed; one sampling step profiled for
   its device time, idle share and host geometry; and a v32 request
   through ``inference.run`` with ``generate_positions=true``. Then the
   whisper_abs family from published (HF-format) checkpoints that the
   script writes with seeded random weights (``whisper_phase``): kernel B
   at a whisper encoder window (B 1, T = S = 512, D 64, H 12 and H 8)
   against both plain versions and timed beside SDPA, kernel D at v28's
   shapes against its plain versions, each with its own kernels-line
   entry; v29 (whisper-small at full width) from a fp32
   ``model.safetensors`` written by the script's own writer, one request
   at the v29 preset with ``super_timing=false`` (its first window's
   encoder states through B held against the plain path); v28
   (whisper-base) from ``pytorch_model.bin``, one greedy request with int8
   weights and KV (its first window's teacher-forced logits through D held
   against the plain version); each writes a readable .osu, B launches in
   both and D's two paths in v28's. Then T5 v1.1-base (``t5_phase``,
   ``t5_relpos``: relative-position bias, unscaled attention, gated GELU,
   no conv stem) from one set of seeded weights, drawn as HF initialises
   T5, written as a published checkpoint (``model.safetensors``) and as a
   legacy accelerate one (``pytorch_model.bin`` and a tokenizer pickled
   under a reference module path), whose two loads must give equal
   parameters: a ``-cn v32`` request from the published one (its first
   window's encoder states and teacher-forced logits through B, unscaled
   at the cross attention, held against the plain path), MaiMod on its
   .osu or a dense map (T5's cross attention takes B there, 12 launches a
   batch), and a greedy request from the legacy one with
   the port's ``t5_base`` preset and the fused mel, int8 weights and KV
   (A and D; its teacher-forced logits through D held); B unscaled at the
   cross attention's own q, k and v on both routes against both plain
   versions and float64, A at 388 mels and D at T5-base's products, each
   with its own kernels-line entry. Then the last two families, each
   written by the script as a published ``model.safetensors`` whose load
   must equal the converter's map, served under ``-cn v32`` on the 4 s
   song: NWhisper-base (``ngpt_phase``, nGPT: normalised weights, slerp
   residuals, every attention call on B at ``sm_scale`` 1.0), (a) its
   defaults (sampled), the first window's encoder states and teacher-forced
   logits through B held against the plain path, one graphed decode step
   profiled, (b) greedy with int8 weights and KV asked, which must leave no
   ``QDense`` (every nGPT site stays a ``NormDense``) and an int8 cache; B
   unscaled at the model's own normalised q, k, v of its encoder window on
   both routes as T5's (its own kernels-line entry). Moonshine-tiny
   (``moonshine_phase``: raw samples into a conv stem, 681 encoder
   positions a window, heads of 36), (a) greedy fp32, its first window's
   encoder states through B held, (b) greedy with int8 weights and KV, D's
   tensor cores at the encoder's fc1, the first window encoded and
   teacher-forced through D held against ``qmm_plain``; then B at D 36 and
   52 and C at D 36 (a key mask, and causal with a key mask), which the
   kernels take zero-padded (to 40 / 56 on the fp32 route, 64 on the sm90
   one), held on the unpadded inputs against both plain versions of each
   route and timed through ``flash_attention`` (the copies included) beside
   the kernel on inputs padded beforehand, the copies alone, the plain
   version, SDPA and the bound on the real D: B's rows in its own
   kernels-line entry, C's in the C entries' ``shapes`` (the backbone
   training phase trains moonshine on the bf16 route). Then the evaluation tools (``eval_phase``)
   at full width from seeded random weights: the mapper classifier of
   ``configs/classifier/train_v1.yaml`` (whisper-base, 1 024 frames and
   tokens, 388 mels, the mapper classes of ``datasets/beatmap_users.json``),
   CM3P at ``Cm3pConfig()``'s widths (written native and as
   ``pytorch_model.bin``, whose two loads must be equal) and OsuR, each
   written as the bundle its loader reads; ``classifier_classify`` on
   request 1's .osu, ``calc_fid`` with ``skip_generation`` and every metric
   on request 1's map against request 2's as its generation (or the next
   request's on the same song, or a dense map, where request 2's has no
   timing point, which the classifier's parser needs, or request 1's hit
   objects) (classifier at
   batch 32, CM3P at 16; every number finite), ``classifier_test`` at batch
   32 and ``rcomplexion_inference`` / ``rcomplexion_test`` on synthesized
   tracks, each through its ``python -m`` entry's ``main``; B must launch in
   the first three and nothing else of B or C anywhere; then B at the
   classifier's calls (B 32, T = S = 1 024, H 8: unmasked, and causal with
   a key mask whose batch row 0 is a window of pads, which must average v
   over all keys) and CM3P's beatmap tower (B 16, T = S = 512, the same
   mask) against both plain versions and timed beside SDPA; these join B's
   kernels-line entry and its launches.
5. Training: first the port's parquet reader reads the committed
   fixtures (``tests/fixtures/parquet/``, written by pandas: SNAPPY,
   dictionary pages), whose rows must equal the JSON beside each. Then
   ``mapperatorinator_tpu_torch.train.main -cn v32`` on the same
   full-width model with Muon, bf16 mixed precision, batch 32 and grad_acc 2
   for 6 micro-steps (3 updates) from its own ``web`` dataset (a shard of 8
   synthesized sets under ``compressed/``, written by the script's plain
   parquet writer, ``write_parquet``), then a checkpoint. The same sets
   are written as ``ors`` track folders, for the checks, and as an MMRS
   root (the committed ``metadata.parquet`` and the folders it names).
   First, on the first batch in fp32 at batch 2, the loss and every
   gradient through the kernels must match the plain attention path;
   afterwards, every step's loss must be finite, both attention kernels
   must have launched, and restoring the checkpoint must give the same step
   and parameters. One more micro-step is profiled by kernel.
   The bf16 micro-steps must run the tensor-core pair only (36 forward and
   36 backward launches each, no fp32 launch), and on the first batch in
   bf16 at batch 2 the loss and every gradient through them must be no
   further from the fp32 gradients than twice plain bf16 attention's.
   Before them, ``train.main`` trains in fp32 (``mixed_precision=no``, batch
   2, 2 micro-steps), the fp32 pair's training path, which must launch the
   fp32 pair only.
   Fine-tuning: a base checkpoint of the bf16 v32 training model with
   seeded random weights, the fused mel in its config, is written under
   ``base/gamemode=0``, and ``train.main -cn lora_v32`` (rank-64 LoRA on
   wq/wkv/wqkv/wo, Muon, bf16, batch 32) runs 6 micro-steps at grad_acc 2
   from it on its own ``mmrs`` dataset, with a profiler window over
   micro-steps 2 and 3. Each micro-step must launch the tensor-core pair
   36 times each, nothing else of B or C, and A once; the losses must be
   finite, the base stay bit-equal to the checkpoint, B leave zero at the first update, the
   trainable count be the sum of r (in + out) over the targets, the Chrome
   trace name both sm90 kernels and the adapter's config carry
   ``ckpt_subfolders: ["gamemode=0"]``. Two greedy requests are then
   served with the adapter (``lora_path``): fp32, and with int8 weights and
   KV cache; the served weights must be the base with the adapter merged
   (and then quantized), and the requests must launch the kernels of
   request 2 (A, B) and of request 3 (B, D) with A. The resolver must skip
   the adapter at ``gamemode=1``.
   Then the auxiliary trainers (``aux_train_phase``), each through its
   entry point's ``main`` on the same synthesized set, from weights seeded
   as flax draws them: ``diffusion_train -cn v1`` (DiT-B at v1's batch 256,
   3 steps, the uniform sampler; its EMA bundle read back equal; then one
   step with the ``loss-second-moment`` sampler from a warm history),
   ``classifier_train -cn train_v1`` (train_v1's widths, micro-batch 128
   and grad_acc 2: two updates and one eval batch; its
   bundle read back equal) and ``rcomplexion_train -cn train_v1`` (OsuR at
   batch 1 024, 3 steps and an eval; its export read back equal). Every
   attention call of the DiT and the classifier must run B forward and C
   backward on the fp32 route (12 of each a DiT step, 18 a classifier
   micro-step), OsuR none; one fp32 gradient check each for the DiT and
   the classifier through B + C against plain attention; then B and C at
   the trainers' calls (DiT-B's B 256, T = S = 128, H 12, unmasked; the
   classifier's B 64, T = S = 1 024, H 8, unmasked and causal with a key
   mask whose row 0 is a window of pads, where C's dq and dk must be
   exactly 0) against both plain versions and timed beside SDPA and the
   bound; these join B's and C's kernels-line entries and their launches.
   Last, every other backbone family trains (``backbone_train_phase``)
   through ``train.main`` on the same sets, at full width, its recipe's bf16,
   ``adamwscale`` and ``dataset_type``, from seeded random weights: ``-cn
   v29`` (whisper-small) and ``v28`` (whisper-base), both whisper_abs,
   from the MMRS root, ``t5_base`` (T5
   v1.1-base), ``nwhisper_base`` (nGPT) and ``moonshine_tiny``; 4
   micro-steps at grad_acc 2 each, at the recipe's micro-batch 128 where
   the peak reckoned from two memory probes fits 85% of the card, else the
   largest power of two that does. First, on the first batch at batch 2,
   the bf16 loss and every gradient through B and C must be no further
   from the fp32 plain gradients than twice plain bf16 attention's; then
   every loss finite, the step count, two updates, the published widths in
   bf16, one B and one C a covered call and nothing else (whisper_abs:
   every call; T5: the cross calls, its self-attention carrying the
   position bias; nGPT at ``sm_scale`` 1.0 and moonshine at D 36 padded to
   64: every call), and the final checkpoint restored equal; then B and C
   at each family's calls, on the check's own inputs, against both bf16
   plain versions and timed beside SDPA and the bound; these join the bf16
   pair's kernels-line entries and their launches.
   Then multi-process training (``parallel_phase``): v32 at full width and
   bf16 through ``train.main`` with the ``parallel.*`` keys. One update of
   4 rows through plain attention under DDP on one NCCL rank equals the
   update without a process group bit for bit; (a) one NCCL rank, DDP, 2
   micro-steps at the recipe's micro-batch 32; (c) the same under FSDP
   (``parallel.fsdp_axis=data``), its gathered parameters within 2e-2 of
   (a)'s in norm, its checkpoint restored unsharded; (b) two ranks sharing
   the card over gloo, spawned (``parallel_rank``), 8 rows a rank at
   grad_acc 2, 4 micro-steps: parameters bit-equal across ranks after every
   update, the first loss that of one process on the same 16 rows, rank
   0's checkpoint restored; (c) again on two gloo ranks beside (b)'s, 4
   rows a rank and 2 micro-steps (cut to fit the card beside (b) and the
   whole run inside its limit), after a probe that gloo takes CUDA
   tensors. Every rank launches one sm90
   B and C a covered call; these join the bf16 pair's launches. On the
   tensor axis (``parallel.tensor_axis``): (e) one NCCL rank with a tensor
   axis of 1, 128 graphed greedy steps of request 3's first window (fp32,
   from its checkpoint), the graphs capturing the regions' 36 all-reduces
   a step, tokens equal to the whole engine's; (d), in (c)'s two processes
   after it, two gloo ranks at tensor 2, 4 rows (the same on both), 2
   micro-steps at grad_acc 2 (cut from 8 rows at grad_acc 1 to keep the
   run in its limit): B and C on every covered call at 6 heads, the
   replicated leaves bit-equal across ranks after the update, the first
   loss that of one process, the gathered parameters after the update
   within 2e-2 of one process's, rank 0's checkpoint restored unsharded;
   (f), in (b)'s two processes after it, the same 128 steps at tensor 2
   over gloo, eager by the engine's rule: tokens against (e)'s, the first
   8 steps' scores within 2e-4 of the whole engine's; (g)
   ``optim.name=adafactor``, 2 micro-steps at batch 32 on one card, peak
   GiB beside Muon's; then B and C at a rank's 6 heads of (c)'s 8-row
   calls (bf16, B 8: 1 024², 2 560² causal, 2 560 × 1 024) beside SDPA.
   Then the single-card tools (``tools_phase``), each through its entry
   point on what earlier phases wrote: the held-out eval harness
   (``test.main``) on request 3's v32 weights under a config that picks the
   fused mel, at batch 32, both passes of 2 batches (36 B and one A a batch;
   the first batch's loss and logits through the kernels held against
   plain attention); ``dataloading`` (``stats``, ``audition``);
   ``push_to_hub --stage-dir`` on that checkpoint with a ``gamemode=1``
   subfolder and one removed mapper (every staged tensor read back equal to
   its source but the mapper's token rows, which are 0); ``print_ckpt``;
   the DiT tools on the auxiliary trainers' DiT-B (``dit_test_toy`` at 16
   predictions, 12 B a sampling step; ``plot_embeddings``,
   ``find_similar_beatmaps``, ``distance_distance``); ``plot_self_similarity``
   with CM3P (B); ``plot_difficulties``; and the web UI served from a
   thread, a v32 generation job on a 4 s song and a MaiMod job on its map,
   each in a spawned worker on the card whose launches it writes beside its
   log; then B at the harness's calls (B 32, H 12: 1 024², 2 560² causal
   with a key mask, 2 560 × 1 024), which join B's kernels-line entry.
   Super-timing runs 10 members, cut from v32's 20; super-timing, request
   v31-2 and v31's MaiMod fallback decode with 6 of the 12 decoder layers
   (v31-2's checkpoint holds v31-1's first 6), and each "decode graphs"
   case starts from a 240-token prompt (window 0's first prompt decoded on
   greedily, no EOS) and runs to slot 272 (it was 300 steps from the
   13-token prompt), to keep the whole run inside its limit.
6. Prints per-phase figures, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and as its last line
   ``{"ok": true, "device": {...}}``. Any failed check raises; the run fails
   if jax, flax, yaml, optax, msgpack, safetensors, transformers, pandas,
   pyarrow, datasets, huggingface_hub or the JAX package was imported.

Details (compiler logs, all numbers) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import datetime
import functools
import gc
import io
import itertools
import json
import math
import os
import random
import statistics
import sys
import tempfile
import threading
import time
import types
import wave
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out"
AUDIO_SECONDS = 20.0

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # fp32: test_attention_kernel.py's bar
MEL_TOL = 5e-3  # rtol = atol, test_audio.py:80
# the mel kernel against its plain versions (the split-TF32 one and fp32),
# rtol = atol: fp32 accuracy, the sums taken in another order
MEL_TC_TOL = 1e-4
ENC_TOL = 2e-4  # model-level bar, test_model.py:77
# qmm: the reference's 1e-5 (test_qmm_kernel.py:30) in fp32, 2e-2 in bf16, each
# times the largest |reference output|, at least 1
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
QMM_SHAPES = [  # (rows, K, N): decode steps; a v32 encoder window's fc1, qkv and out; init_cache; a prefill;
    # ragged; a v31 encoder window's fc1, qkv and out (2 048 rows, which the JAX gate qmm_supported sends to
    # the plain expression, in the port too: held here, not on a main path)
    (1, 768, 2304), (1, 768, 768), (1, 768, 3072), (1, 3072, 768), (2, 768, 768), (4, 768, 3072), (3, 200, 128),
    (1024, 768, 3072), (1024, 768, 2304), (1024, 768, 768), (1024, 768, 1536), (256, 3072, 768),
    (2048, 768, 3072), (2048, 768, 2304), (2048, 768, 768),
    # v28 (whisper-base, d 512): a decode step's qkv, out / cross q, fc1, fc2 and out with CFG; an encoder
    # window's (512 rows) qkv, out, fc1, fc2 and cross k/v; a prefill's qkv
    (1, 512, 1536), (1, 512, 512), (1, 512, 2048), (1, 2048, 512), (2, 512, 512),
    (512, 512, 1536), (512, 512, 512), (512, 512, 2048), (512, 2048, 512), (512, 512, 1024), (64, 512, 1536),
    # T5 v1.1-base (d 768, 12 heads of 64, gated ffn 2 048): a decode step's fc1 / fc1_gate and fc2 (its qkv,
    # out / cross q and CFG out are v32's above); a 512-frame encoder window's qkv, out, fc1 / fc1_gate and fc2,
    # and init_cache's cross k/v
    (1, 768, 2048), (1, 2048, 768), (512, 768, 2304), (512, 768, 768), (512, 768, 2048), (512, 2048, 768),
    (512, 768, 1536)]
# a decode step's products on the GEMV path (rows <= 4): self-attention qkv,
# the 768-wide ones (self out, cross q and out), fc1, fc2; and out with CFG
QMM_DECODE = [(1, 768, 2304), (1, 768, 768), (1, 768, 3072), (1, 3072, 768), (2, 768, 768),
              (1, 512, 2048),  # and v28's fc1
              (1, 768, 2048), (1, 2048, 768)]  # and T5-base's fc1 / fc1_gate and fc2
QMM_TIMED = {"qmm": (1, 768, 3072),  # the GEMV path at a decode step's fc1, cold L2
             "qmm_tc": (1024, 768, 3072)}  # the tensor-core path at an encoder window's fc1
QMM_TIMED_V28 = {"qmm": (1, 512, 2048), "qmm_tc": (512, 512, 2048)}  # the same at v28's widths
QMM_TIMED_T5 = {"qmm": (1, 768, 2048), "qmm_tc": (512, 768, 2048)}  # and at T5-base's fc1
# T5-base's products: a decode step's (with CFG's out), a 512-frame window's and its cross k/v
T5_QMM = {(1, 768, 2304), (1, 768, 768), (2, 768, 768), (1, 768, 2048), (1, 2048, 768), (512, 768, 2304),
          (512, 768, 768), (512, 768, 2048), (512, 2048, 768), (512, 768, 1536)}
# cold L2: a decode step streams every decoder layer's weights (about 99 MB of
# int8), twice the 50 MB L2, so each timed GEMV call reads the next of enough
# weight copies to hold together at least this many bytes
COLD_BYTES = 2**26
# the profiler's names of kernel D's kernels (csrc/qmm.cu), by path
QMM_KERNELS = {"qmm_gemv": "qmm_gemv_cluster_kernel", "qmm_tc": "qmm_tc_kernel"}
INT8_BARS = (0.06, 0.8)  # int8 vs fp logits: relative max error, argmax agreement (test_quantize_checkpoint.py:58-59)
ENGINE_STEPS = 64
# the decode steps profile_decode traces with the profiler, of the 48 it times (cut from 48 for the run's limit:
# request 3's four decode profiles took 123.2 s at 48 traced steps, most of the profiler's post-processing)
PROFILED_DECODE_STEPS = {"graphs": 16, "eager": 8}
# each "decode graphs" case: a 240-token prompt (window 0's first prompt decoded on, greedy, with no EOS), decoded to
# slot 272, 16 slots into the second 256-slot bucket (it was the 13-token prompt and 300 steps: cut for the run's limit)
DECODE_GRAPH_PROMPT, DECODE_GRAPH_END = 240, 272
STATS_TOL = 1e-4  # forward_stats vs the host reduction, test_decode.py:424
GRAD_TOL = 2e-4  # the model bar, times each gradient tensor's largest entry
# bf16 gradients through the tensor-core kernels, held against the fp32 plain
# gradients on the same batch and weights: their largest error relative to the
# tensor's largest entry may be at most this many times plain bf16 attention's
# own (the two round at different points: the kernels keep the logits in fp32,
# plain attention rounds them to bf16; near-uniform attention at init makes the
# q and k gradients small, so both bf16 errors are large there)
GRAD_TOL_BF16 = 2.0
ATTN_PER_STEP = 36  # attention calls a micro-step: 12 encoder self, 12 decoder self, 12 cross

# the card's published rates (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 outside the tensor cores; bf16
PEAK_TF32 = 495e12  # TF32 on the tensor cores
PEAK_BYTES = 3.35e12

# training: v32's batch and accumulation; a cut would be printed here
TRAIN_BATCH, TRAIN_GRAD_ACC, TRAIN_MICRO_STEPS = 32, 2, 6
# fp32 training (the fp32 pair's training path): cut to batch 2 and 2
# micro-steps, as the fp32 gradient check's batch
FP32_TRAIN_BATCH, FP32_TRAIN_STEPS = 2, 2
# the LoRA fine-tune (lora_v32: batch 32, grad_acc 16, 1000 steps): cut to
# grad_acc 2 and 6 micro-steps (3 updates); printed with the phase. The
# synthesized set holds 3 batches of 32, so micro-steps 1 and 4 each load an
# epoch, the trace covers 2-3, and 5-6 (an accumulation and an update) are
# the steady, untraced pair whose mean is the phase's s per micro-step
LORA_GRAD_ACC, LORA_MICRO_STEPS = 2, 6
LORA_TRACED, LORA_STEADY = (2, 3), (5, 6)
# the LoRA requests' audio: seeded random merged weights never emit EOS, so
# every window decodes to tgt_seq_len; a short song keeps to a few windows
LORA_AUDIO_SECONDS = 4.0
ORS_TRACKS, ORS_MAPS, ORS_SECONDS = 8, 4, 60.0
# the committed parquet fixtures (tests/fixtures/parquet_fixtures.py writes them with pandas), and the folder of
# each MMRS set that write_mmrs makes for the rows of mmrs_metadata.parquet
PARQUET_FIXTURES = REPO / "tests" / "fixtures" / "parquet"
MMRS_FOLDER = "{:05d} Artist - Title"
# super-timing's ensemble, cut from v32's 20 members to keep the whole run inside its limit (printed with the
# phase)
TIMER_ITERATIONS, TIMER_ITERATIONS_V32 = 10, 20
SERVER_JOIN_S = 600  # the server phase's two requests must return within this
# the v31 phase's conditions: a set difficulty and a mapper (a user id that
# datasets/beatmap_users.json holds, so the mapper table's own row)
V31_DIFFICULTY, V31_MAPPER = 6.5, 101602
# the DiT phase: DiT-B (configs/diffusion/v1.yaml) under v32's diffusion
# settings (100 respaced steps of 1 000, band 128, 1 024-row chunks with
# 128-row overlaps, refine_iters 10; v31 shares all but the steps, and
# writes positions as DISTANCE and POS_X / POS_Y events, which the pipeline
# replaces, where v32's POS tokens stay as generated) on a synthesized song of DIT_OBJECTS hit
# objects, a slider every DIT_SLIDER_EVERY-th (curve types in turn), which
# the pipeline cuts into two chunks; every DiT tensor is drawn from
# N(0, DIT_WEIGHT_STD) (flax's zero adaLN would make every block the identity)
DIT_OBJECTS, DIT_SLIDER_EVERY, DIT_WEIGHT_STD = 1500, 50, 0.02
# the whisper phase (v29: whisper-small, v28: whisper-base, both whisper_abs):
# a 4 s song, one window a pass (1 024 mel frames span 8.2 s), so a request
# decodes a window a pass (TIMING, KIAI, MAP) of up to 2 048 tokens on
# seeded random weights
WHISPER_AUDIO_SECONDS = 4.0
DIT_TOL = 1e-4  # a DiT forward and a p_sample step through kernel B against the plain path
# the T5 phase (T5 v1.1-base, t5_relpos): the same 4 s song. Request (a) serves the published checkpoint under
# -cn v32 (2 048-frame windows, 2 560 target slots); request (b) the legacy checkpoint under its training
# config's windows (the port's t5_base preset: 512 frames, 384 target slots), with the fused mel that config
# then asks for. The legacy tokenizer is pickled under this reference module path.
T5_AUDIO_SECONDS = 4.0
T5_LEGACY_TRAIN = ("model.spectrogram.implementation=pallas",)
T5_LEGACY_SERVE = ("train.data.src_seq_len=512", "train.data.tgt_seq_len=384")
# the last two backbone families, served under -cn v32 from published checkpoints the script writes, on the same
# 4 s song: NWhisper-base (nGPT) and moonshine-tiny, each with its model preset's settings
# (configs/model/nwhisper_base.yaml, moonshine_tiny.yaml: a tied head)
FAMILY_AUDIO_SECONDS = 4.0
FAMILY_MODELS = {
    "nwhisper": ("train.model.name=OliBomby/nwhisper-base", "train.model.embed_decoder_input=false",
                 "train.model.project_encoder_input=true"),
    "moonshine": ("train.model.name=UsefulSensors/moonshine-tiny", "train.model.input_raw_wave=true",
                  "train.model.project_encoder_input=false", "train.model.overwrite.tie_word_embeddings=true"),
}
# moonshine's head dims (tiny, base), which the kernels take padded; the encoder window of a v32 window
MOONSHINE_HEAD_DIMS = (36, 52)
MOONSHINE_WINDOW = 681
REFERENCE_EVENTS = "osuT5.osuT5.event"
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "optax", "msgpack", "safetensors", "transformers",
           "mapperatorinator_tpu", "pandas", "pyarrow", "datasets", "huggingface_hub")


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(fns: dict, reps: int = 10) -> dict:
    """Median ms of each function, timed in order and then in reverse (a, b,
    c, c, b, a), the median of the two rounds."""
    first = {name: median_ms(fn, reps) for name, fn in fns.items()}
    second = {name: median_ms(fns[name], reps) for name in reversed(list(fns))}
    return {name: statistics.median([first[name], second[name]]) for name in fns}


def paired_ms(kernel, plain, library=None, reps: int = 20) -> tuple[float, float, float | None]:
    """(kernel, plain, library) median ms, timed in turns (plain, kernel,
    library, library, kernel, plain)."""
    times = in_turns({"plain": plain, "kernel": kernel, **({"library": library} if library else {})}, reps)
    return times["kernel"], times["plain"], times.get("library")


def device_kernels(events) -> list:
    """The device kernels among a profiler's events (``key_averages()``):
    those whose device type is CUDA and that are not user annotations. A CPU
    op's device time includes the kernels it launched, so a sum over every
    event counts a kernel launched through an ``aten::`` op twice, once as the
    op and once as itself; torch's own table sums device events only."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]


def device_ms(fn, reps: int = 20) -> float | None:
    """Device time of one call of ``fn``, from the profiler: the summed time
    of the kernels it launches over ``reps`` calls, divided by ``reps``. At
    a decode shape the CUDA-event time of one call is mostly the host's
    enqueue time; this is the card's share. A profile that caught no device
    kernel (seen on the H100 for ``F.linear`` at 1 024 rows) is taken again;
    None if the second catches none either."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in device_kernels(prof.key_averages()))
        if total > 0:
            return total / 1e3 / reps
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations over
    the peak rate for the inputs' type and the bytes over the memory rate."""
    by_ops, by_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def attended_pairs(B: int, T: int, S: int, causal: bool, mask, window: int = 0) -> float:
    """The (query, key) pairs of one head that the function needs: those the
    causal mask, the band |q - k| <= window // 2 and the key mask leave, in
    each row with a live key; a row with none averages v over all S keys.
    The masked pairs that a kernel computes anyway are wasted work, not
    throughput."""
    q, k = torch.arange(T, device="cuda")[:, None], torch.arange(S, device="cuda")[None]
    live = torch.ones((T, S), dtype=torch.bool, device="cuda")
    if causal:
        live = live & (k <= q)
    if window:
        live = live & ((q - k).abs() <= window // 2)
    live = live[None].expand(B, T, S) if mask is None else live[None] & mask[:, None, :].bool()
    per_row = live.sum(-1)
    return float(torch.where(per_row > 0, per_row, S).sum().item())


def sdpa_layout(*xs):
    """(B, T, H, D) -> contiguous (B, H, T, D), the layout SDPA takes."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def attention_launches() -> dict:
    """The four attention kernels' launch counts, by kernels-line name."""
    from mapperatorinator_tpu_torch.ops import attention_kernel as ak

    return {"flash_attention_fwd": ak.flash_fwd_fp32.launches, "flash_attention_bwd": ak.flash_bwd_fp32.launches,
            "flash_attention_fwd_sm90": ak.flash_fwd_sm90.launches,
            "flash_attention_bwd_sm90": ak.flash_bwd_sm90.launches}


def reset_attention_launches() -> None:
    from mapperatorinator_tpu_torch.ops import attention_kernel as ak

    ak.flash_fwd_fp32.launches = ak.flash_bwd_fp32.launches = 0
    ak.flash_fwd_sm90.launches = ak.flash_bwd_sm90.launches = 0


def fp32_bounds(flops: float, nbytes: float) -> dict:
    """The fp32 kernels' two bounds on operations, fp32 FMAs at 67 TFLOP/s
    and three TF32 tensor-core products for each fp32 one at 495 TFLOP/s;
    the least time the card could take is the smaller of the two, or the
    bytes over the memory rate where that is larger."""
    fma_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    tf32x3_ms = 3 * flops / PEAK_TF32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    least = min(fma_ms, tf32x3_ms)
    return {"flops": flops, "fma_ms": fma_ms, "tf32x3_ms": tf32x3_ms, "bytes_ms": bytes_ms, "bound_ms": max(least, bytes_ms),
            "bound_by": "operations" if least >= bytes_ms else "bytes"}


# the fp32 route's timed calls: (label, B, T, S, causal + key mask, backward
# too); serving (a v32 and a v31 encoder window) is B's only, the three
# training calls of the fp32 micro-steps both kernels'
FP32_SHAPES = [("serving encoder", 1, 1024, 1024, False, False),
               ("v31 serving encoder", 1, 2048, 2048, False, False),
               ("training encoder", FP32_TRAIN_BATCH, 1024, 1024, False, True),
               ("training decoder self", FP32_TRAIN_BATCH, 2560, 2560, True, True),
               ("training cross", FP32_TRAIN_BATCH, 2560, 1024, False, True)]


def attention_cases(gen, B: int):
    """(label, T, S, causal, window, key mask) of the checks: the training
    calls, a ragged cross call, and a batch row whose keys are all masked."""
    key_mask = torch.rand((B, 2560), generator=gen, device="cuda") > 0.1
    all_masked = torch.ones((B, 1024), dtype=torch.bool, device="cuda")
    all_masked[0] = False  # every query row of batch 0 sees no key
    return [
        ("encoder self T1024", 1024, 1024, False, 0, None),
        ("v31 encoder self T2048", 2048, 2048, False, 0, None),
        ("v31 decoder self T1010 causal keymask", 1010, 1010, True, 0, key_mask[:, :1010]),  # MaiMod's v31 batch
        ("v31 cross T1010 S2048", 1010, 2048, False, 0, None),
        ("causal T1024", 1024, 1024, True, 0, None),
        ("encoder self T1024 window128 keymask", 1024, 1024, False, 128, key_mask[:, :1024]),
        ("decoder self local T2560 causal window128 keymask", 2560, 2560, True, 128, key_mask),
        ("decoder self global T2560 causal keymask", 2560, 2560, True, 0, key_mask),
        ("cross T2560 S1024", 2560, 1024, False, 0, None),
        ("cross T300 S1024 keymask", 300, 1024, False, 0, key_mask[:, :1024]),
        ("all-keys-masked row T1024", 1024, 1024, False, 0, all_masked),
    ]


def check_attention(report: dict) -> None:
    """Kernels B and C on the fp32 route (split-TF32) against both their plain
    versions, the one that splits as they do and the fp32 one, at batch 1
    and 2: forward within 2e-5, backward within 2e-5 times the largest
    reference gradient (at least 1), and dq = dk = 0 exactly in a row with
    no live key."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain,
        attention_backward_plain_fp32_tc,
        attention_plain,
        attention_plain_fp32_tc,
        flash_bwd_fp32,
        flash_fwd_fp32,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    H, D, tol = 12, 64, ATTN_TOL[torch.float32]
    scale = D**-0.5
    worst = {"fwd": 0.0, "bwd": 0.0}
    for B in (1, 2):
        for label, T, S, causal, window, mask in attention_cases(gen, B):
            q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(2))
            k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda") for _ in range(2))
            out, lse = flash_fwd_fp32(q, k, v, mask, causal, window, scale, True)
            grads = flash_bwd_fp32(q, k, v, mask, out, lse, do, causal, window, scale)
            kw = {"causal": causal, "window": window}
            fwd_err, bwd_err, bwd_tol = {}, {}, {}
            for name, fwd, bwd in (("tc", attention_plain_fp32_tc, attention_backward_plain_fp32_tc),
                                   ("fp32", attention_plain, attention_backward_plain)):
                fwd_err[name] = (out - fwd(q, k, v, mask, **kw)).abs().max().item()
                want = bwd(q, k, v, mask, do, **kw)
                bwd_err[name] = max((g - w).abs().max().item() for g, w in zip(grads, want))
                # the reference's bar, scaled by the largest reference gradient:
                # gradients grow with the length, and dq is summed with atomics
                bwd_tol[name] = tol * max(1.0, max(w.abs().max().item() for w in want))
                del want
            dead = mask is not None and not mask[0].any() and bool(grads[0][0].any() or grads[1][0].any())
            print(f"flash_attention fp32 B{B} {label}: forward max_abs_err {fwd_err['tc']:.3e} against the plain "
                  f"version that splits as the kernel does, {fwd_err['fp32']:.3e} against the fp32 one (tol {tol:g}); "
                  f"backward {bwd_err['tc']:.3e} / {bwd_err['fp32']:.3e} (tol {bwd_tol['tc']:.3e} / "
                  f"{bwd_tol['fp32']:.3e})" + ("; dq and dk of the rows with no live key exactly 0"
                                               if mask is not None and not mask[0].any() and not dead else ""))
            report["attention_cases"].append({"B": B, "T": T, "S": S, "case": label, "fwd_max_abs_err": fwd_err,
                                              "fwd_tol": tol, "bwd_max_abs_err": bwd_err, "bwd_tol": bwd_tol})
            if not (all(e <= tol for e in fwd_err.values()) and all(bwd_err[n] <= bwd_tol[n] for n in bwd_err)) \
                    or dead:
                raise AssertionError(f"flash_attention fp32 {label} B{B}: forward {fwd_err}, backward {bwd_err} above "
                                     f"{tol} / {bwd_tol}, or a row with no live key gave dq or dk a gradient")
            worst["fwd"] = max(worst["fwd"], *fwd_err.values())
            worst["bwd"] = max(worst["bwd"], *bwd_err.values())
            del q, k, v, do, out, lse, grads
    report["attention_fp32_worst"] = worst
    torch.cuda.empty_cache()


def time_attention_fp32(report: dict) -> list[dict]:
    """Kernels B and C on the fp32 route timed at the calls of their main
    paths (``FP32_SHAPES``: B at all five, C at the three of training)
    beside the plain version, SDPA in fp32 (TF32 off) and the two bounds,
    which count the (query, key) pairs the masks leave. Returns the two
    kernels-line entries, each at its first shape, with every shape's
    figures under ``shapes``."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain,
        attention_plain,
        flash_bwd_fp32,
        flash_fwd_fp32,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    H, D = 12, 64
    scale = D**-0.5
    shapes = {"fwd": [], "bwd": []}
    for label, B, T, S, causal, backward in FP32_SHAPES:
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda") for _ in range(2))
        mask = sdpa_mask = None
        if causal:  # the decoder's key mask pads each row's end, as decoder_attention_mask does
            lengths = torch.randint(int(0.75 * S), S + 1, (B, 1), generator=gen, device="cuda")
            mask = torch.arange(S, device="cuda")[None] < lengths
            sdpa_mask = torch.ones((T, S), dtype=torch.bool, device="cuda").tril()[None, None] & mask[:, None, None, :]
        out, lse = flash_fwd_fp32(q, k, v, mask, causal, 0, scale, True)
        qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)
        do_s = do.transpose(1, 2).contiguous()
        el_q, el_k = B * T * H * D, B * S * H * D
        pairs = H * attended_pairs(B, T, S, causal, mask)
        kinds = {"fwd": ({"plain": lambda: attention_plain(q, k, v, mask, causal=causal),
                          "kernel": lambda: flash_fwd_fp32(q, k, v, mask, causal, 0, scale, True),
                          "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                              qs, ks, vs, attn_mask=sdpa_mask)},
                         # q, k, v in; out and lse out
                         fp32_bounds(4.0 * pairs * D, 4 * (2 * el_q + 2 * el_k) + 4 * B * H * T))}
        if backward:
            # q, k, v, O, dO and lse in; dq, dk, dv out
            kinds["bwd"] = ({"plain": lambda: attention_backward_plain(q, k, v, mask, do, causal=causal),
                             "kernel": lambda: flash_bwd_fp32(q, k, v, mask, out, lse, do, causal, 0, scale),
                             "library": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True)},
                            fp32_bounds(10.0 * pairs * D, 4 * (3 * el_q + 2 * el_k) + 4 * (el_q + 2 * el_k)
                                        + 4 * B * H * T))
        for kind, (fns, bounds) in kinds.items():
            t_ = in_turns(fns)
            row = {"label": label, "shape": f"B{B} T{T} S{S} H{H} D{D} fp32" + (" causal + key mask" if causal else ""),
                   "ms": t_["kernel"], "plain_ms": t_["plain"], "library_ms": t_["library"], **bounds,
                   "pairs_share": pairs / (B * H * T * S), "useful_tflops": bounds["flops"] / t_["kernel"] / 1e9}
            shapes[kind].append(row)
            print(f"flash_attention_{kind} fp32 {label} {row['shape']}: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, scaled_dot_product_attention {row['library_ms']:.4f} ms "
                  f"({row['ms'] / row['library_ms']:.2f}x); bounds: fp32 FMAs {row['fma_ms']:.4f} ms, three TF32 "
                  f"products {row['tf32x3_ms']:.4f} ms, bytes {row['bytes_ms']:.4f} ms; the masks leave "
                  f"{row['pairs_share']:.4f} of T x S: {row['useful_tflops']:.1f} useful TFLOP/s")
        del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, sdpa_mask
        torch.cuda.empty_cache()
    report["attention_fp32_timing"] = shapes
    worst = report["attention_fp32_worst"]
    source = "mapperatorinator_tpu_torch/csrc/flash_attention.cu"
    return [{"name": f"flash_attention_{kind}", "route": "cuda", "source": source, "replaces": replaces,
             "max_abs_err": worst[kind],
             "tol": "2e-5" if kind == "fwd" else "2e-5 x max(1, max |reference gradient|)",
             "ms": shapes[kind][0]["ms"], "plain_ms": shapes[kind][0]["plain_ms"],
             "bound_ms": shapes[kind][0]["bound_ms"], "bound_by": shapes[kind][0]["bound_by"],
             "library_ms": shapes[kind][0]["library_ms"], "timed_shape": shapes[kind][0]["shape"],
             "shapes": shapes[kind]}
            for kind, replaces in (("fwd", "mapperatorinator_tpu/ops/attention_kernel.py:88"),
                                   ("bwd", "mapperatorinator_tpu/ops/attention_kernel.py:197"))]


def check_attention_sm90(report: dict) -> list[dict]:
    """Kernels B and C on the tensor-core route (bf16, D 64) against both
    plain versions over the training cases, batch 2, then timed at the
    three attention calls of a training micro-step (batch 32) beside their
    bound and ``scaled_dot_product_attention``; at the encoder call also
    beside the plain version (at the others its fp32 (B, H, T, S) tensors
    would not leave room)."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain,
        attention_backward_plain_bf16_tc,
        attention_plain,
        attention_plain_bf16_tc,
        flash_bwd_sm90,
        flash_fwd_sm90,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    H, D, B, dtype, tol = 12, 64, 2, torch.bfloat16, ATTN_TOL[torch.bfloat16]
    scale = D**-0.5
    cases = [  # (label, T, S, causal, window, key mask)
        ("encoder self T1024", 1024, 1024, False, 0, None),
        ("decoder self local T2560 causal window128 keymask", 2560, 2560, True, 128, "random"),
        ("decoder self global T2560 causal keymask", 2560, 2560, True, 0, "random"),
        ("cross T2560 S1024", 2560, 1024, False, 0, None),
        ("cross T300 S1024 keymask", 300, 1024, False, 0, "random"),
        ("all-keys-masked row T1024", 1024, 1024, False, 0, "dead"),
    ]
    worst = {"fwd": 0.0, "bwd": 0.0}
    for label, T, S, causal, window, kind in cases:
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
        do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
        mask = None if kind is None else torch.rand((B, S), generator=gen, device="cuda") > 0.1
        if kind == "dead":
            mask[0] = False  # every query row of batch 0 sees no key
        out, lse = flash_fwd_sm90(q, k, v, mask, causal, window, scale, True)
        grads = flash_bwd_sm90(q, k, v, mask, out, lse, do, causal, window, scale)
        kw = {"causal": causal, "window": window}
        fwd_err, fwd_tol = {}, {}
        for name, ref in (("tc", attention_plain_bf16_tc), ("fp32", attention_plain)):
            want = ref(q, k, v, mask, **kw).float()
            fwd_err[name] = (out.float() - want).abs().max().item()
            # one bf16 ulp grows with the value: the bar scales as the backward's
            fwd_tol[name] = tol * max(1.0, want.abs().max().item())
        bwd_err, bwd_tol = {}, {}
        for name, ref in (("tc", attention_backward_plain_bf16_tc), ("fp32", attention_backward_plain)):
            want = ref(q, k, v, mask, do, **kw)
            bwd_err[name] = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want))
            bwd_tol[name] = tol * max(1.0, max(w.float().abs().max().item() for w in want))
        dead = kind == "dead" and (grads[0][0].abs().max().item() != 0 or grads[1][0].abs().max().item() != 0)
        print(f"flash_attention sm90 bf16 B{B} {label}: forward max_abs_err {fwd_err['tc']:.3e} against the "
              f"rounding-faithful plain version, {fwd_err['fp32']:.3e} against the fp32 one (tol {fwd_tol['tc']:.3e} / "
              f"{fwd_tol['fp32']:.3e}); backward "
              f"{bwd_err['tc']:.3e} / {bwd_err['fp32']:.3e} (tol {bwd_tol['tc']:.3e} / {bwd_tol['fp32']:.3e})"
              + ("; dq and dk of the rows with no live key exactly 0" if kind == "dead" and not dead else ""))
        report["attention_sm90_cases"].append({"B": B, "T": T, "S": S, "case": label, "fwd_max_abs_err": fwd_err,
                                               "fwd_tol": fwd_tol, "bwd_max_abs_err": bwd_err, "bwd_tol": bwd_tol})
        if not (all(fwd_err[n] <= fwd_tol[n] for n in fwd_err) and all(bwd_err[n] <= bwd_tol[n] for n in bwd_err)) \
                or dead:
            raise AssertionError(f"flash_attention sm90 {label}: forward {fwd_err}, backward {bwd_err} above "
                                 f"{fwd_tol} / {bwd_tol}, or a row with no live key gave dq or dk a gradient")
        worst["fwd"] = max(worst["fwd"], fwd_err["tc"])
        worst["bwd"] = max(worst["bwd"], bwd_err["tc"])
        del q, k, v, do, out, lse, grads

    # the three calls of a training micro-step, batch 32; the decoder's key
    # mask pads each row's end, as the model's decoder_attention_mask does
    Bt = TRAIN_BATCH
    timings = {}
    for label, T, S, causal in (("encoder self", 1024, 1024, False), ("decoder self", 2560, 2560, True),
                                ("cross", 2560, 1024, False)):
        q, do = (torch.randn((Bt, T, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
        k, v = (torch.randn((Bt, S, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
        mask = None
        if causal:
            lengths = torch.randint(int(0.75 * S), S + 1, (Bt, 1), generator=gen, device="cuda")
            mask = torch.arange(S, device="cuda")[None] < lengths
        out, lse = flash_fwd_sm90(q, k, v, mask, causal, 0, scale, True)
        qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
        sdpa_mask = None
        if mask is not None:  # the same function: causal and the key mask as one boolean mask
            sdpa_mask = (torch.ones((T, S), dtype=torch.bool, device="cuda").tril()[None, None]
                         & mask[:, None, None, :])
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)
        do_s = do.transpose(1, 2).contiguous()
        fwd = {"kernel": lambda: flash_fwd_sm90(q, k, v, mask, causal, 0, scale, True),
               "library": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)}
        bwd = {"kernel": lambda: flash_bwd_sm90(q, k, v, mask, out, lse, do, causal, 0, scale),
               "library": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True)}
        if label == "encoder self":
            fwd["plain"] = lambda: attention_plain_bf16_tc(q, k, v, mask, causal=causal)
            bwd["plain"] = lambda: attention_backward_plain_bf16_tc(q, k, v, mask, do, causal=causal)
        el_q, el_k = Bt * T * H * D, Bt * S * H * D
        # the bound counts the pairs the masks leave; the kernels compute all
        # T x S (no tile is skipped), so the rest is wasted work
        pairs = H * attended_pairs(Bt, T, S, causal, mask)
        f_flops, f_computed = 4.0 * pairs * D, 4.0 * Bt * H * T * S * D
        f_bound = bound(f_flops, 2 * (2 * el_q + 2 * el_k) + 4 * Bt * H * T, dtype)  # q, k, v in; out, lse out
        # q, k, v, O, dO and lse in; dq, dk, dv out
        b_bound = bound(2.5 * f_flops, 2 * (3 * el_q + 2 * el_k) + 2 * (el_q + 2 * el_k) + 4 * Bt * H * T, dtype)
        times = {"fwd": in_turns(fwd), "bwd": in_turns(bwd)}
        for kind, bnd, flops in (("fwd", f_bound, f_flops), ("bwd", b_bound, 2.5 * f_flops)):
            t_ = times[kind]
            t_["bound"], t_["bound_by"] = bnd
            t_["useful_flops"], t_["computed_flops"] = flops, flops * f_computed / f_flops
            t_["useful_tflops"] = flops / t_["kernel"] / 1e9
            plain = f", plain {t_['plain']:.3f} ms" if "plain" in t_ else ", plain not measured (memory)"
            print(f"flash_attention sm90 {kind} bf16 {label} B{Bt} T{T} S{S} H12 D64"
                  f"{' causal + key mask' if causal else ''}: kernel {t_['kernel']:.3f} ms{plain}, "
                  f"scaled_dot_product_attention {t_['library']:.3f} ms ({t_['kernel'] / t_['library']:.2f}x), "
                  f"bound {t_['bound']:.4f} ms ({t_['bound_by']}); the masks leave {f_flops / f_computed:.4f} of "
                  f"the T x S pairs the kernel computes: {t_['useful_tflops']:.1f} useful TFLOP/s")
        timings[label] = times
        del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, sdpa_mask
        torch.cuda.empty_cache()
    report["attention_sm90_timing"] = timings
    enc = timings["encoder self"]
    source = "mapperatorinator_tpu_torch/csrc/flash_attention_sm90.cu"
    shape = f"B{Bt} T1024 S1024 H12 D64 bf16 (an encoder call of training)"
    return [{"name": f"flash_attention_{kind}_sm90", "route": "cuda", "source": source, "replaces": replaces,
             "max_abs_err": worst[kind],
             "tol": f"2e-2 x max(1, max |reference {'output' if kind == 'fwd' else 'gradient'}|)",
             "ms": enc[kind]["kernel"], "plain_ms": enc[kind]["plain"], "bound_ms": enc[kind]["bound"],
             "bound_by": enc[kind]["bound_by"], "library_ms": enc[kind]["library"], "timed_shape": shape}
            for kind, replaces in (("fwd", "mapperatorinator_tpu/ops/attention_kernel.py:88"),
                                   ("bwd", "mapperatorinator_tpu/ops/attention_kernel.py:197"))]


def mel_work(batch: int, n_frames: int, n_fft: int, n_bins: int, n_mels: int, signal: int) -> tuple[float, float]:
    """(operations, bytes) of one fused-mel call: the two DFT products and the
    projection; the padded signal (``signal`` floats: the frames overlap in
    it), the two DFT matrices and the filterbank read once, the mels written
    once."""
    rows = batch * n_frames
    flops = 2.0 * rows * n_fft * n_bins * 2 + 2.0 * rows * n_bins * n_mels
    return flops, 4.0 * (signal + 2 * n_fft * n_bins + n_bins * n_mels + rows * n_mels)


def mel_frames(batch: int, n_frames: int):
    """``batch`` items of one window of ``n_frames`` frames (v32 2 048, v31
    4 096) of seeded audio (a 440 Hz tone and noise, ``n_frames - 1`` hops of
    128 samples) on the card, reflect-padded and framed as
    ``MelSpectrogram`` frames them: (frames, padded signal)."""
    n = (n_frames - 1) * 128
    t = np.arange(n) / 16000
    rng = np.random.default_rng(0)
    audio = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    x = torch.from_numpy(audio).cuda()
    padded = torch.nn.functional.pad(x[:, None], (512, 512), mode="reflect")[:, 0]
    return padded.unfold(1, 1024, 128)[:, :n_frames], padded


# kernel A's checks: (batch, frames, mels): one v32 window (request 2's call),
# two (CFG), 32 (a LoRA micro-step: lora_v32's batch), one v31 window (80 mels)
MEL_CASES = [(1, 2048, 128), (2, 2048, 128), (32, 2048, 128), (1, 4096, 80)]


def mel_case(mel, batch: int, n_frames: int) -> dict:
    """Kernel A at one shape, with ``mel``'s (a ``MelSpectrogram`` on the
    card) DFT tables, filterbank and log scale: against both its plain
    versions at ``MEL_TC_TOL`` and ``MEL_TOL``, a float64 reference beside
    them, two calls bit-equal; timed beside its plain version by CUDA events
    and the profiler, and set against ``fp32_bounds``."""
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain, mel_plain_tf32x3

    log_scale = mel.log_scale
    args = (mel.w_re, mel.w_im, mel.fbanks, log_scale)
    n_fft, n_bins = mel.w_re.shape
    n_mels = mel.fbanks.shape[1]
    frames, padded = mel_frames(batch, n_frames)
    got = fused_mel(frames, *args)
    want, want3 = mel_plain(frames, *args), mel_plain_tf32x3(frames, *args)
    fd = frames.double()
    re, im = fd @ mel.w_re.double(), fd @ mel.w_im.double()
    truth = (re * re + im * im) @ mel.fbanks.double()
    truth = torch.log1p(truth) if log_scale else truth
    torch.cuda.synchronize()

    def excess(ref, tol):  # the largest |got - ref| - tol |ref|: at most tol passes rtol = atol = tol
        return ((got - ref).abs() - tol * ref.abs()).max().item()

    case = {"batch": batch, "frames": n_frames, "mels": n_mels, "log_scale": log_scale, "shape": list(got.shape),
            "max_abs_err": (got - want).abs().max().item(),
            "max_abs_err_tf32x3": (got - want3).abs().max().item(),
            "max_abs_err_fp64": {"kernel": (got.double() - truth).abs().max().item(),
                                 "plain": (want.double() - truth).abs().max().item(),
                                 "plain_tf32x3": (want3.double() - truth).abs().max().item()},
            "repeat_bit_equal": torch.equal(got, fused_mel(frames, *args)),
            "finite": bool(torch.isfinite(got).all())}
    label = f"fused_mel batch {batch} x {n_frames} frames, 1024 -> {n_bins} -> {n_mels}{', log1p' if log_scale else ''}"
    print(f"{label}: max_abs_err {case['max_abs_err']:.3e} against mel_plain, {case['max_abs_err_tf32x3']:.3e} "
          f"against mel_plain_tf32x3 (rtol = atol = {MEL_TC_TOL:g}; the reference's {MEL_TOL:g}); against "
          f"float64: kernel {case['max_abs_err_fp64']['kernel']:.3e}, mel_plain "
          f"{case['max_abs_err_fp64']['plain']:.3e}, mel_plain_tf32x3 {case['max_abs_err_fp64']['plain_tf32x3']:.3e}; "
          f"a second call bit-equal {case['repeat_bit_equal']}")
    if (got.shape != (batch, n_frames, n_mels) or not case["finite"] or not case["repeat_bit_equal"]
            or not excess(want, MEL_TOL) <= MEL_TOL or not excess(want, MEL_TC_TOL) <= MEL_TC_TOL
            or not excess(want3, MEL_TC_TOL) <= MEL_TC_TOL):
        raise AssertionError(f"{label} disagrees with its plain versions: {case}")
    ms, plain_ms, _ = paired_ms(lambda: fused_mel(frames, *args), lambda: mel_plain(frames, *args))
    case.update(ms=ms, plain_ms=plain_ms,
                device_ms={"kernel": device_ms(lambda: fused_mel(frames, *args)),
                           "plain": device_ms(lambda: mel_plain(frames, *args))},
                **fp32_bounds(*mel_work(batch, n_frames, n_fft, n_bins, n_mels, padded.numel())))
    print(f"{label}: kernel {ms:.4f} ms (device {fmt_ms(case['device_ms']['kernel'])}), plain {plain_ms:.4f} ms "
          f"(device {fmt_ms(case['device_ms']['plain'])}); bound {case['bound_ms']:.4f} ms ({case['bound_by']}: "
          f"fp32 FMAs {case['fma_ms']:.4f}, three TF32 products {case['tf32x3_ms']:.4f}, bytes "
          f"{case['bytes_ms']:.4f}); no single PyTorch call computes the mel")
    return case


def check_mel(report: dict) -> dict:
    """Kernel A against both its plain versions (``mel_plain_tf32x3``, which
    rounds as it does, and ``mel_plain``) at ``MEL_TC_TOL`` and at the
    reference's ``MEL_TOL``, with a float64 reference beside them, two calls
    bit-equal, at ``MEL_CASES``: one v32 window (request 2's call), two
    (CFG, batch 2), 32 (a LoRA micro-step's call: lora_v32's batch of 32
    windows), and one v31 window (4 096 frames, 80 mels: request v31-2's
    call); each timed beside its plain version, by CUDA events and by the
    profiler's device kernels, and set against ``fp32_bounds``. Returns the
    kernels-line entry at one v32 window."""
    from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram

    cases = [mel_case(MelSpectrogram("pallas", True, 16000, 1024, n_mels, 128, 20, 8000, "reflect").cuda(), batch,
                      n_frames) for batch, n_frames, n_mels in MEL_CASES]
    report["mel_cases"] = cases
    one = cases[0]
    return {"name": "fused_mel", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/fused_mel.cu",
            "replaces": "mapperatorinator_tpu/ops/mel_kernel.py:72", "max_abs_err": one["max_abs_err"],
            "max_abs_err_tf32x3": one["max_abs_err_tf32x3"], "tol": MEL_TC_TOL, "ms": one["ms"],
            "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
            "bound_fma_ms": one["fma_ms"], "bound_tf32x3_ms": one["tf32x3_ms"], "library_ms": None,
            "device_ms": one["device_ms"], "timed_shape": "N2048 1024->513->128 log1p fp32",
            **{key: {k: case[k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "bound_by", "max_abs_err",
                                          "max_abs_err_tf32x3")}
               for key, case in (("cfg_batch2", cases[1]), ("lora_batch32", cases[2]), ("v31_4096x80", cases[3]))}}


# the config phase: -cn v32 with this hop (a multiple of 16, which kernel A takes), which data.hop_length derives
CONFIG_HOP = 256
CONFIG_SCHEMAS = {"train": "TrainConfig", "inference": "InferenceConfig", "diffusion": "DiffusionTrainConfig",
                  "classifier": "ClassifierConfig", "rcomplexion": "RcomplexionConfig"}


def config_phase(report: dict) -> tuple[dict, dict]:
    """The port's config layer on the machine without ``yaml``: every file
    of ``configs/`` that a script composes (all but the model fragments),
    each with the schema its JAX script uses, and the port's three backbone
    presets, timed; then ``-cn v32 model.spectrogram.hop_length=CONFIG_HOP``
    (and the fused mel), whose ``data.hop_length`` must follow, and the
    model's mel front end, built from that config, on one window of
    ``(src_seq_len - 1) * data.hop_length`` seeded samples: kernel A at that
    hop, its launches counted, then held against both its plain versions on
    the same frames and timed beside them. Returns (the launches, A's row)."""
    from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
    from mapperatorinator_tpu_torch.config import CONFIGS, PORT_CONFIGS, compose_config, load_train_config, schema
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain, mel_plain_tf32x3

    started = time.perf_counter()
    names = []
    for path in sorted(CONFIGS.rglob("*.yaml")):
        group = path.parent.relative_to(CONFIGS).as_posix()
        if group == "model":
            continue
        group = "" if group == "." else group
        cls = CONFIG_SCHEMAS.get(group) or ("FidConfig" if "fid" in path.stem else "MaiModConfig")
        compose_config(group, path.stem, (), getattr(schema, cls))
        names.append(f"{group}/{path.stem}".lstrip("/"))
    for path in sorted((PORT_CONFIGS / "train").glob("*.yaml")):
        compose_config("train", path.stem, (), schema.TrainConfig)
        names.append(f"train/{path.stem} (the port's preset)")
    composed_s = time.perf_counter() - started
    if len(names) != 27 or "yaml" in sys.modules:
        raise AssertionError(f"the config layer composed {names} (yaml imported: {'yaml' in sys.modules})")
    print(f"config layer: composed {len(names)} configs (the 24 of configs/ that the scripts compose, the port's "
          f"3 backbone presets) without yaml in {composed_s:.3f} s ({composed_s / len(names) * 1e3:.2f} ms each)")

    t0 = time.perf_counter()
    args = load_train_config("v32", [f"model.spectrogram.hop_length={CONFIG_HOP}",
                                     "model.spectrogram.implementation=pallas"])
    v32_s = time.perf_counter() - t0
    sp, data = args.model.spectrogram, args.data
    if (data.hop_length, sp.hop_length, data.sample_rate) != (CONFIG_HOP, CONFIG_HOP, sp.sample_rate):
        raise AssertionError(f"-cn v32 model.spectrogram.hop_length={CONFIG_HOP}: data.hop_length "
                             f"{data.hop_length}, model.spectrogram.hop_length {sp.hop_length}")
    mel = MelSpectrogram(sp.implementation, sp.log_scale, sp.sample_rate, sp.n_fft, sp.n_mels, sp.hop_length, sp.f_min,
                         sp.f_max, sp.pad_mode).cuda()
    n = (data.src_seq_len - 1) * data.hop_length
    t = np.arange(n) / sp.sample_rate
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32))
    audio = audio[None].cuda()
    fused_mel.launches = 0
    got = mel(audio)
    torch.cuda.synchronize()
    launches = {"fused_mel": fused_mel.launches}
    if launches["fused_mel"] != 1 or got.shape != (1, data.src_seq_len, sp.n_mels):
        raise AssertionError(f"the mel front end at hop {CONFIG_HOP}: {launches} launches, shape {tuple(got.shape)}")

    padded = torch.nn.functional.pad(audio[:, None], (sp.n_fft // 2, sp.n_fft // 2), mode=sp.pad_mode)[:, 0]
    frames = padded.unfold(1, sp.n_fft, sp.hop_length)[:, :data.src_seq_len]
    tables = (mel.w_re, mel.w_im, mel.fbanks, mel.log_scale)
    kernel = fused_mel(frames, *tables)
    want, want3 = mel_plain(frames, *tables), mel_plain_tf32x3(frames, *tables)

    def excess(ref, tol):  # the largest |got - ref| - tol |ref|: at most tol passes rtol = atol = tol
        return ((kernel - ref).abs() - tol * ref.abs()).max().item()

    err, err3 = (kernel - want).abs().max().item(), (kernel - want3).abs().max().item()
    if (not torch.equal(kernel, got) or not bool(torch.isfinite(kernel).all()) or excess(want, MEL_TOL) > MEL_TOL
            or excess(want, MEL_TC_TOL) > MEL_TC_TOL or excess(want3, MEL_TC_TOL) > MEL_TC_TOL):
        raise AssertionError(f"kernel A at hop {CONFIG_HOP} disagrees with its plain versions: {err:.3e}, {err3:.3e}")
    ms, plain_ms, _ = paired_ms(lambda: fused_mel(frames, *tables), lambda: mel_plain(frames, *tables))
    n_bins = mel.w_re.shape[1]
    bounds = fp32_bounds(*mel_work(1, data.src_seq_len, sp.n_fft, n_bins, sp.n_mels, padded.numel()))
    seconds = time.perf_counter() - started
    print(f"config layer: -cn v32 model.spectrogram.hop_length={CONFIG_HOP} composed in {v32_s * 1e3:.2f} ms, "
          f"data.hop_length {data.hop_length}; fused_mel at hop {CONFIG_HOP}, {data.src_seq_len} frames, "
          f"{sp.n_fft} -> {n_bins} -> {sp.n_mels}: {launches['fused_mel']} launch from the front end, max_abs_err "
          f"{err:.3e} against mel_plain, {err3:.3e} against mel_plain_tf32x3 (rtol = atol = {MEL_TC_TOL:g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']}); "
          f"the phase {seconds:.1f} s")
    row = {"shape": f"hop {CONFIG_HOP}: {data.src_seq_len} frames, {sp.n_fft}->{n_bins}->{sp.n_mels} log1p fp32",
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bounds["bound_ms"], "bound_by": bounds["bound_by"],
           "max_abs_err": err, "max_abs_err_tf32x3": err3}
    report["config_phase"] = {"configs": names, "composed_s": composed_s, "v32_hop_s": v32_s, "seconds": seconds,
                              "launches": launches, "fused_mel": row}
    return launches, row


def qmm_bound(rows: int, k: int, n: int, dtype) -> tuple[float, str]:
    """Kernel D's least time: the int8 weight, x and the scale read once and
    the output written once, against the operations at the peak rate for
    x's type (:func:`bound`), except that the tensor-core path (more than 4
    rows) takes an fp32 x as two TF32 products for each fp32 one."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = k * n + rows * k * esize + rows * n * esize + 4 * n
    flops = 2.0 * rows * k * n
    if rows > 4 and dtype == torch.float32:
        by_ops, by_bytes = 2 * flops / PEAK_TF32 * 1e3, nbytes / PEAK_BYTES * 1e3
        return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return bound(flops, nbytes, dtype)


def check_qmm(report: dict) -> dict:
    """Kernel D against its plain version at the v32 shapes, a v31 encoder
    window's and v28's (``QMM_SHAPES``) in fp32 and bf16;
    on the GEMV path (up to 4 rows) two calls on the same inputs must be
    bit-equal, and the tensor-core path (more rows) is also held against
    ``qmm_plain_tf32x2``, which rounds as it does, and timed beside
    ``F.linear`` on the weight dequantized in advance. Returns the
    tensor-core path's kernels-line entry, at its ``QMM_TIMED`` shape in
    fp32, with its device times (profiler) beside the CUDA-event ones; the
    GEMV path is timed by :func:`time_qmm_cold`."""
    from mapperatorinator_tpu_torch.models.transformer import quantize_weight
    from mapperatorinator_tpu_torch.ops.qmm_kernel import GEMV_ROWS, qmm, qmm_plain, qmm_plain_tf32x2

    gen = torch.Generator(device="cuda").manual_seed(2)
    timed = None
    for dtype in (torch.float32, torch.bfloat16):
        for rows, k, n in QMM_SHAPES:
            wq, scale = quantize_weight(torch.randn((k, n), generator=gen, device="cuda") * 0.05)
            x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
            got, want = qmm(x, wq, scale), qmm_plain(x, wq, scale)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = QMM_TOL[dtype] * max(1.0, want.float().abs().max().item())
            gemv = rows <= GEMV_ROWS
            label = f"qmm {str(dtype)[6:]} rows{rows} K{k} N{n} ({'GEMV' if gemv else 'tensor cores'})"
            case = {"dtype": str(dtype), "rows": rows, "K": k, "N": n, "path": "qmm" if gemv else "qmm_tc",
                    "max_abs_err": err, "tol": tol}
            if gemv:
                case["repeat_bit_equal"] = torch.equal(got, qmm(x, wq, scale))
                print(f"{label}: max_abs_err {err:.3e} against qmm_plain (tol {tol:.3e}); a second call bit-equal "
                      f"{case['repeat_bit_equal']}")
            else:
                case["max_abs_err_tf32x2"] = (got.float() - qmm_plain_tf32x2(x, wq, scale).float()).abs().max().item()
                w_lin = (wq.float() * scale).T.contiguous().to(dtype)  # (N, K), what F.linear takes
                ms, plain_ms, library_ms = paired_ms(lambda: qmm(x, wq, scale), lambda: qmm_plain(x, wq, scale),
                                                     lambda: torch.nn.functional.linear(x, w_lin))
                bound_ms, bound_by = qmm_bound(rows, k, n, dtype)
                case.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
                print(f"{label}: max_abs_err {err:.3e} against qmm_plain (tol {tol:.3e}), "
                      f"{case['max_abs_err_tf32x2']:.3e} against qmm_plain_tf32x2; kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, F.linear {library_ms:.4f} ms ({ms / library_ms:.2f}x), bound "
                      f"{bound_ms:.5f} ms ({bound_by})")
                if dtype == torch.float32 and (rows, k, n) == QMM_TIMED["qmm_tc"]:
                    case["device_ms"] = {"kernel": device_ms(lambda: qmm(x, wq, scale)),
                                         "plain": device_ms(lambda: qmm_plain(x, wq, scale)),
                                         "library": device_ms(lambda: torch.nn.functional.linear(x, w_lin))}
                    print(f"{label}, device time per call (profiler, device kernels only): kernel "
                          f"{fmt_ms(case['device_ms']['kernel'])}, plain {fmt_ms(case['device_ms']['plain'])}, "
                          f"F.linear {fmt_ms(case['device_ms']['library'])}")
                    timed = case
            report["qmm_cases"].append(case)
            if got.shape != (rows, n) or got.dtype != dtype or not err <= tol or not case.get("repeat_bit_equal", True):
                raise AssertionError(f"{label}: error {err} above {tol}, shape {tuple(got.shape)} {got.dtype}, or "
                                     "two calls differ")
    v31 = {f"N{c['N']}": {k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
           for c in report["qmm_cases"] if c["rows"] == 2048 and c["dtype"] == str(torch.float32)}
    return {"name": "qmm_tc", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
            "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80", "v31_rows2048_K768_fp32": v31,
            "max_abs_err": timed["max_abs_err"],
            "tol": timed["tol"], "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": timed["library_ms"], "device_ms": timed["device_ms"],
            "timed_shape": "rows1024 K768 N3072 fp32 (an encoder window's fc1, the tensor-core path)"}


def cycled(calls: list):
    """One function that makes the given calls in turn."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


def host_us(fn, reps: int = 200) -> float:
    """Microseconds a call takes to return on the host clock (the enqueue:
    no synchronize inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def qmm_host_pieces(x, wq, scale) -> dict:
    """Host microseconds of each piece of a ``qmm`` call on the GEMV path
    (:func:`host_us`), the whole call and ``F.linear`` on the same inputs
    last. Of the two stream lookups the wrapper makes the first; the second,
    the public one, is timed beside it."""
    from mapperatorinator_tpu_torch.ops import _build
    from mapperatorinator_tpu_torch.ops import qmm_kernel as qk

    (rows, k), n, device = x.shape, wq.shape[1], x.get_device()
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    fn = _build.function("qmm", "qmm_gemv", qk._GEMV_ARGTYPES)
    args = (x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, k, n,
            int(x.dtype == torch.bfloat16), *qk.gemv_plan(rows, k, n), torch._C._cuda_getCurrentRawStream(device))
    w_lin = (wq.float() * scale).T.contiguous().to(x.dtype)

    def counters():
        qk.qmm.launches_gemv += 1
        qk.qmm.launches += 1

    pieces = {
        "checks (_check)": lambda: qk._check(x, wq, scale),
        "gemv_plan (cached)": lambda: qk.gemv_plan(rows, k, n),
        "binding (_build.function, cached)": lambda: _build.function("qmm", "qmm_gemv", qk._GEMV_ARGTYPES),
        "the output (x.new_empty)": lambda: x.new_empty((rows, n)),
        "stream: torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(device),
        "stream: torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "data_ptr x 4": lambda: (x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr()),
        "the ctypes call (the launch)": lambda: fn(*args),
        "error check": lambda: _build.check(fn.lib, 0, "qmm"),
        "counters": counters,
        "qmm_kernel, whole": lambda: qk.qmm_kernel(x, wq, scale),
        "qmm, whole": lambda: qk.qmm(x, wq, scale),
        "F.linear": lambda: torch.nn.functional.linear(x, w_lin),
    }
    return {name: host_us(fn_, reps=500) for name, fn_ in pieces.items()}


def gemv_tiles_ms(x, copies) -> dict:
    """Device ms (profiler, cold L2 as in :func:`time_qmm_cold`) of the GEMV
    path at each column tile of ``GEMV_TILES`` with the plan's K split, the
    plan's own tile among them: the trade-off ``gemv_plan`` makes between
    longer runs of a weight row and more blocks in flight."""
    from mapperatorinator_tpu_torch.ops import _build
    from mapperatorinator_tpu_torch.ops import qmm_kernel as qk

    (rows, k), n = x.shape, copies[0][0].shape[1]
    out = x.new_empty((rows, n))
    fn = _build.function("qmm", "qmm_gemv", qk._GEMV_ARGTYPES)
    plan = qk.gemv_plan(rows, k, n)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())

    def launch(w, s, bn):
        err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), rows, k, n,
                 int(x.dtype == torch.bfloat16), bn, plan.cluster, plan.k_slice, stream)
        _build.check(fn.lib, err, "qmm (GEMV)")

    return {f"bn{bn} x {plan.cluster} ({plan._replace(bn=bn).blocks(n)} blocks)":
            device_ms(cycled([lambda w=w, s=s, bn=bn: launch(w, s, bn) for w, s in copies]))
            for bn in qk.GEMV_TILES}


def time_qmm_cold(report: dict) -> dict:
    """Kernel D's GEMV path at a decode step's shapes (``QMM_DECODE``) in fp32
    and bf16, with a cold L2 as a decode step finds it: each call of the
    kernel, of its plain version and of ``F.linear`` (on the weight
    dequantized in advance) reads the next of enough weight copies of its own
    to hold ``COLD_BYTES``. CUDA events per call (at these shapes mostly the
    host's enqueue) and the profiler's device time, beside the bound of
    bytes; at fc1 in fp32 also the host time a call takes to return. Returns
    the GEMV path's kernels-line entry, at fc1 in fp32."""
    from mapperatorinator_tpu_torch.models.transformer import quantize_weight
    from mapperatorinator_tpu_torch.ops.qmm_kernel import gemv_plan, qmm, qmm_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    linear = torch.nn.functional.linear
    entry = None
    for dtype in (torch.float32, torch.bfloat16):
        for rows, k, n in QMM_DECODE:
            wq, scale = quantize_weight(torch.randn((k, n), generator=gen, device="cuda") * 0.05)
            x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
            w_lin = (wq.float() * scale).T.contiguous().to(dtype)
            copies = [(wq.clone(), scale.clone()) for _ in range(math.ceil(COLD_BYTES / wq.numel()))]
            lin_copies = [w_lin.clone() for _ in range(math.ceil(COLD_BYTES / (w_lin.numel() * w_lin.element_size())))]
            fns = {"plain": cycled([lambda w=w, s=s: qmm_plain(x, w, s) for w, s in copies]),
                   "kernel": cycled([lambda w=w, s=s: qmm(x, w, s) for w, s in copies]),
                   "library": cycled([lambda w=w: linear(x, w) for w in lin_copies])}
            times = in_turns(fns)
            fc1 = dtype == torch.float32 and (rows, k, n) == QMM_TIMED["qmm"]
            dev = {name: device_ms(fn) for name, fn in fns.items() if fc1 or name != "plain"}
            bound_ms, bound_by = qmm_bound(rows, k, n, dtype)
            plan = gemv_plan(rows, k, n)
            case = {"dtype": str(dtype), "rows": rows, "K": k, "N": n, "plan": plan._asdict(),
                    "blocks": plan.blocks(n), "weight_copies": len(copies),
                    "library_weight_copies": len(lin_copies), "ms": times["kernel"], "plain_ms": times["plain"],
                    "library_ms": times["library"], "device_ms": dev, "bound_ms": bound_ms, "bound_by": bound_by}
            label = f"qmm {str(dtype)[6:]} rows{rows} K{k} N{n} (GEMV, cold L2)"
            print(f"{label}: CUDA events kernel {times['kernel']:.4f} ms, F.linear {times['library']:.4f} ms "
                  f"({times['kernel'] / times['library']:.2f}x), plain {times['plain']:.4f} ms; device kernel "
                  f"{fmt_ms(dev['kernel'])}, F.linear {fmt_ms(dev['library'])}; bound {bound_ms:.5f} ms ({bound_by}); "
                  f"plan bn{plan.bn} x {plan.cluster} ({case['blocks']} blocks); {len(copies)} weight copies, "
                  f"{len(lin_copies)} of F.linear's")
            if dtype == torch.float32:
                case["tiles_device_ms"] = gemv_tiles_ms(x, copies)
                print(f"{label}: device time by column tile, " + ", ".join(
                    f"{tile} {fmt_ms(ms)}" for tile, ms in case["tiles_device_ms"].items()))
            if fc1:
                case["host_us"] = qmm_host_pieces(x, wq, scale)
                print(f"{label}: host microseconds a call takes to return, by piece: "
                      + ", ".join(f"{name} {us:.2f}" for name, us in case["host_us"].items())
                      + f"; plain device {fmt_ms(dev['plain'])}")
                got, want = qmm(x, wq, scale), qmm_plain(x, wq, scale)
                err = (got.float() - want.float()).abs().max().item()
                entry = {"name": "qmm", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
                         "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80", "max_abs_err": err,
                         "tol": QMM_TOL[dtype] * max(1.0, want.float().abs().max().item()), "ms": times["kernel"],
                         "plain_ms": times["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": times["library"], "device_ms": dev, "host_us": case["host_us"],
                         "timed_shape": "rows1 K768 N3072 fp32 (a decode step's fc1, the GEMV path, cold L2)"}
            report["qmm_cold_cases"].append(case)
            del copies, lin_copies
    torch.cuda.empty_cache()
    return entry


def write_wav(path: Path, seconds: float, sr: int = 16000, seed: int = 0, freq: float = 440.0) -> Path:
    """A beat-gated tone with a little noise, made from a seed."""
    t = np.arange(int(sr * seconds)) / sr
    beat = (np.sin(2 * np.pi * 2.0 * t) > 0).astype(np.float32)
    noise = 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    x = np.sin(2 * np.pi * freq * t) * (0.15 + 0.15 * beat) + noise
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return path


def set_flash(model, on: bool) -> None:
    from mapperatorinator_tpu_torch.models.dit import DiTBlock
    from mapperatorinator_tpu_torch.models.transformer import Attention

    for m in model.modules():
        if isinstance(m, (Attention, DiTBlock)):
            m.use_flash = on


def set_qmm(model, on: bool) -> None:
    from mapperatorinator_tpu_torch.models.transformer import QDense

    for m in model.modules():
        if isinstance(m, QDense):
            m.use_kernel = on


def fmt_bytes(n: int | None) -> str:
    return "not measured" if n is None else f"{n / 2**20:.1f} MiB"


# (d_model, encoder layers, decoder layers, heads, ffn) of the whisper sizes, and of T5 v1.1-base
WHISPER_SMALL, WHISPER_BASE = (768, 12, 12, 12, 3072), (512, 6, 6, 8, 2048)
# super-timing, request v31-2 and v31's MaiMod fallback decode with 6 of the decoder's 12 layers, cut to keep the run
# inside its limit (their windows run to the decode buffer's end, whatever the song's length or the members)
CUT_DECODER_LAYERS = 6
WHISPER_SMALL_CUT = (768, 12, CUT_DECODER_LAYERS, 12, 3072)
T5_BASE = (768, 12, 12, 12, 2048)
NWHISPER_BASE, MOONSHINE_TINY = (512, 6, 6, 8, 2048), (288, 6, 6, 8, 1152)


def check_full_width(model, widths=WHISPER_SMALL) -> None:
    """v32's VarWhisper-small, v31's RoPEWhisper-small and v29's whisper-small
    share these widths; v28's whisper-base and T5 v1.1-base have their own."""
    b = model.cfg.backbone
    if (b.d_model, b.encoder_layers, b.decoder_layers, b.decoder_heads, b.encoder_ffn) != widths:
        raise AssertionError(f"not a full-width {widths} backbone: {b}")


def window0(args):
    from mapperatorinator_tpu_torch.infer import Preprocessor

    pre = Preprocessor(args, parallel=args.parallel)
    return pre.segment(pre.load(args.audio_path))[0][:1]


def check_encoder_states(label: str, engine, frames, cond: dict, positions: int) -> dict:
    """The request's first window, encoded with its conditions through the
    kernels (flash attention, and the fused mel where the model's config
    picks it) against the plain path (plain attention and the FFT mel)
    within ENC_TOL; with a difficulty among the conditions, another
    difficulty must move the states (a dead embedder cannot pass)."""
    model = engine.model
    with_kernel = engine.encode_with_cond(frames, cond)
    set_flash(model, False)
    implementation, model.spectrogram.implementation = model.spectrogram.implementation, "xla"
    plain = engine.encode_with_cond(frames, cond)
    set_flash(model, True)
    model.spectrogram.implementation = implementation
    torch.cuda.synchronize()
    err = (with_kernel - plain).abs().max().item()
    finite = bool(torch.isfinite(with_kernel).all())
    check = {"shape": list(with_kernel.shape), "conditions": {k: v.tolist() for k, v in cond.items()},
             "mel": implementation, "max_abs_err": err, "tol": ENC_TOL}
    moved = None
    if "difficulty" in cond:
        other = engine.encode_with_cond(frames, {**cond, "difficulty": cond["difficulty"] + 3.0})
        moved = check["difficulty_moves_states_by"] = (other - with_kernel).abs().max().item()
    print(f"request {label}, window 0: encoder states {tuple(with_kernel.shape)} with conditions "
          f"{check['conditions']} through the kernels ({implementation} mel) vs the plain path: max_abs_err "
          f"{err:.3e} (tol {ENC_TOL:g})" + ("" if moved is None else
                                            f"; difficulty + 3 moves the states by up to {moved:.3e}"))
    d_model = model.cfg.backbone.d_model
    if with_kernel.shape != (1, positions, d_model) or not finite or not err <= ENC_TOL \
            or (moved is not None and not moved > 10 * ENC_TOL):
        raise AssertionError(f"encoder states disagree or ignore the difficulty: {check}")
    return check


def serve(label: str, tmp: Path, wav: Path, overrides: list[str], report: dict, check_encoder: bool,
          after=None, config: str = "v32", widths=WHISPER_SMALL, load=None) -> dict:
    """One request under ``configs/inference/<config>.yaml`` on a full-width model of
    ``widths``; ``after(engine, args, vocab, first)`` runs more checks on the
    engine before it is freed, ``first`` holding the first decode call's
    prompt, tokens and end and the first encode call's windows and
    conditions. The model's load time (``load(args)``, by default
    ``load_model``) is recorded."""
    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap

    (tmp / label).mkdir()
    # no model_path: seeded random weights at the config's shapes
    args = load_config(config, ["model_path=", "seed=0", f"audio_path={wav}", f"output_path={tmp / label}",
                                 "gamemode=0", *overrides])

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold: the peak below is the request's own
    t0 = time.perf_counter()
    engine, vocab = (load or inference.load_model)(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    inference.compile_args(args, vocab, verbose=False)
    check_full_width(engine.model, widths)
    generation_config, beatmap_config = inference.get_config(args)

    stats = {"tokens": 0, "decode_s": 0.0, "windows": 0}
    by_rows = collections.defaultdict(lambda: {"calls": 0, "steps": 0, "s": 0.0})  # decode calls by batch rows
    first = {}
    inner = engine.generate

    def counted(encoder_states, ids, *a, **kw):
        t0 = time.perf_counter()
        tokens, end = inner(encoder_states, ids, *a, **kw)
        if "tokens" not in first:
            first.update(ids=ids, tokens=tokens, end=end)
        seconds = time.perf_counter() - t0
        stats["decode_s"] += seconds
        stats["tokens"] += int((tokens != vocab.pad_id).sum() - (ids != vocab.pad_id).sum())
        stats["windows"] += 1
        call = by_rows[int(ids.shape[0])]
        call["calls"] += 1
        call["steps"] += int(end) - ids.shape[1]
        call["s"] += seconds
        return tokens, end

    encode = engine.encode_with_cond

    def encoded(frames, cond=None):
        if "frames" not in first:
            first.update(frames=np.asarray(frames)[:1], cond={k: np.asarray(v)[:1] for k, v in (cond or {}).items()})
        return encode(frames, cond)

    engine.generate, engine.encode_with_cond = counted, encoded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    fused_mel.launches = qmm.launches = qmm.launches_gemv = qmm.launches_tc = 0
    t0 = time.perf_counter()
    text, path = inference.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                    engine=engine, vocab=vocab, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**attention_launches(), "fused_mel": fused_mel.launches, "qmm": qmm.launches_gemv,
                "qmm_tc": qmm.launches_tc}
    engine.generate, engine.encode_with_cond = inner, encode
    peak = torch.cuda.max_memory_allocated() - held
    graphs = {"captures": engine.captures, "capture_s": engine.capture_seconds, "pool_bytes": pool_bytes(engine)}

    beatmap = Beatmap.from_path(path)
    if beatmap.mode != args.gamemode or beatmap.title != args.title or "[HitObjects]" not in text:
        raise AssertionError(f"{label}: {path} does not read back as the requested beatmap")
    result = {
        "label": label, "load_s": load_s, "wall_s": wall, "decode_s": stats["decode_s"], "windows": stats["windows"],
        "tokens": stats["tokens"], "tok_per_s": stats["tokens"] / wall, "decode_tok_per_s":
        stats["tokens"] / stats["decode_s"] if stats["decode_s"] else 0.0, "peak_mem_gb": peak / 2**30,
        "held_before_gb": held / 2**30,
        "launches": launches, "hit_objects": len(beatmap.hit_objects()), "timing_points": len(beatmap.timing_points),
        "osu_bytes": len(text.encode()), "osu_path": str(path), "graphs": graphs,
        "decode_rows": {rows: {**c, "ms_per_step": 1e3 * c["s"] / max(c["steps"], 1)} for rows, c in by_rows.items()},
    }
    print(f"request {label}: model loaded in {load_s:.2f} s; wall {wall:.2f} s, {stats['windows']} windows, "
          f"{stats['tokens']} tokens generated, "
          f"{result['tok_per_s']:.1f} tok/s ({result['decode_tok_per_s']:.1f} tok/s in decode), "
          f"peak memory {result['peak_mem_gb']:.2f} GiB over the {result['held_before_gb']:.2f} GiB held before, "
          f"{result['hit_objects']} hit objects, "
          f"{result['timing_points']} timing points, {graphs['captures']} decode graphs captured in "
          f"{graphs['capture_s']:.2f} s (pool {fmt_bytes(graphs['pool_bytes'])} at {engine.max_length} slots), "
          f"launches {launches}")

    if check_encoder:  # a whisper stem halves the frames; moonshine's takes the window's samples
        from mapperatorinator_tpu_torch.models.transformer import moonshine_stem_length

        stride = 2 if engine.model.cfg.backbone.conv_stem else 1
        positions = (moonshine_stem_length(first["frames"].shape[1]) if engine.model.cfg.input_raw_wave
                     else args.train.data.src_seq_len // stride)
        result["encoder_check"] = check_encoder_states(label, engine, first["frames"], first["cond"], positions)
    if after is not None:
        result.update(after(engine, args, vocab, first))
    report["requests"].append(result)
    del engine
    torch.cuda.empty_cache()
    return launches


def nbytes(tree) -> int:
    """Bytes of the tensors in a state dict or a KV cache (lists of dicts)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(nbytes(v) for v in (tree.values() if isinstance(tree, dict) else tree))


def profile_decode(engine, enc, ids, pipeline, eos, int8: bool, steps: int = 48,
                   modes: tuple = ("graphs", "eager")) -> dict:
    """Greedy decode steps on ``engine``, replaying its CUDA graphs and, for
    comparison, stepping eagerly (``use_graphs`` cleared): for each of
    ``modes``, host ms a step without the profiler (the call's wall time
    over ``steps`` steps up to its stop, after warm-up calls that capture
    the graphs), then, profiled over ``PROFILED_DECODE_STEPS[mode]`` steps
    (fewer: the profiler's own cost grows with the events it traces), device
    ms and kernel launches a step, the device's idle share of the host time,
    the kernels with the most device time a step, and the device time of
    kernel D's launches (the GEMV path's, found by name inside the replays,
    and the tensor-core path's in the prefill), all from device kernels
    only, found by the names in ``QMM_KERNELS``. An ``int8`` engine's
    profile that holds no GEMV kernel raises: a renamed kernel would
    otherwise read 0."""
    from torch.profiler import ProfilerActivity, profile

    P = ids.shape[1]
    out = {}
    for mode, graphs in (("graphs", True), ("eager", False)):
        if mode not in modes:
            continue
        engine.use_graphs = graphs
        traced = min(steps, PROFILED_DECODE_STEPS[mode])
        for length in (steps, traced):
            engine.generate(enc, ids, pipeline, eos, max_length=P + length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, end = engine.generate(enc, ids, pipeline, eos, max_length=P + steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / (end - P)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, end = engine.generate(enc, ids, pipeline, eos, max_length=P + traced)
            torch.cuda.synchronize()
        n = end - P
        kernels = device_kernels(prof.key_averages())
        device = sum(e.self_device_time_total for e in kernels) / 1e3
        paths = {path: [e for e in kernels if name in e.key] for path, name in QMM_KERNELS.items()}
        if int8 and not paths["qmm_gemv"]:
            raise AssertionError(f"the int8 decode steps' profile ({mode}) holds no {QMM_KERNELS['qmm_gemv']}: "
                                 f"{sorted(e.key[:60] for e in kernels)}")
        step = {"steps": n, "timed_steps": steps, "host_ms_per_step": wall, "device_ms_per_step": device / n,
                "idle_share": 1 - device / n / wall, "kernels_per_step": sum(e.count for e in kernels) / n,
                "qmm_device_ms_per_step": sum(e.self_device_time_total for es in paths.values() for e in es) / 1e3 / n,
                "top_kernels": [{"name": e.key[:90], "calls_per_step": e.count / n,
                                 "device_us_per_step": e.self_device_time_total / n}
                                for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]]}
        for path, events in paths.items():
            calls = sum(e.count for e in events)
            step[f"{path}_calls"] = calls
            step[f"{path}_device_us_per_call"] = sum(e.self_device_time_total for e in events) / max(calls, 1)
        out[mode] = step
    engine.use_graphs = True
    return out


def pool_bytes(engine) -> int | None:
    """Bytes of the segments in ``engine``'s CUDA-graph memory pool, from the
    caching allocator's snapshot; None where the snapshot names no pools."""
    if engine._pool is None:
        return 0
    segments = torch.cuda.memory_snapshot()
    if not all("segment_pool_id" in seg for seg in segments):
        return None
    return sum(seg["total_size"] for seg in segments if tuple(seg["segment_pool_id"]) == tuple(engine._pool))


def decode_graphs(engines: dict, encs: dict, ids, args, vocab) -> dict:
    """The "decode graphs" phase, on one prompt: each engine's ``generate``
    replaying CUDA graphs against the same engine stepping eagerly, with the
    same prompt and seed, at B 1 and as a CFG pair (B 2, ``cfg_scale`` 2),
    greedy and with the v32 sampling chain. Tokens and the returned position
    must be equal. Each decode runs to slot ``DECODE_GRAPH_END`` at most,
    which takes it past the prompt's bucket of cached slots into the next."""
    from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline, get_eos_token_ids

    eos = get_eos_token_ids(vocab)
    P = ids.shape[1]
    out = {"cases": [], "engines": {}}
    for name, engine in engines.items():
        max_length = min(DECODE_GRAPH_END, engine.max_length)
        captures, capture_s = engine.captures, engine.capture_seconds
        for rows, cfg_scale in ((1, 1.0), (2, 2.0)):
            enc = torch.cat([encs[name]] * rows)
            prompt = np.concatenate([ids] * rows)
            for sampled in (False, True):
                pipeline = build_logits_pipeline(
                    vocab, cfg_scale=cfg_scale, do_sample=sampled, temperature=args.temperature,
                    timing_temperature=args.timing_temperature, mania_column_temperature=args.mania_column_temperature,
                    taiko_hit_temperature=args.taiko_hit_temperature, types_first=args.train.data.types_first,
                    top_k=args.top_k, top_p=args.top_p)
                runs = {}
                for graphs in (True, False):
                    engine.use_graphs = graphs
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tokens, end = engine.generate(enc, prompt, pipeline, eos, seed=11, cfg_scale=cfg_scale,
                                                  max_length=max_length)
                    torch.cuda.synchronize()
                    runs[graphs] = (tokens, end, time.perf_counter() - t0)
                engine.use_graphs = True
                (g_tokens, g_end, g_s), (e_tokens, e_end, e_s) = runs[True], runs[False]
                case = {"weights_and_kv": name, "rows": rows, "cfg_scale": cfg_scale, "sampled": sampled,
                        "prompt": P, "max_length": max_length, "end_graphs": g_end, "end_eager": e_end,
                        "tokens_equal": bool(np.array_equal(g_tokens, e_tokens)), "graphs_s": g_s, "eager_s": e_s}
                out["cases"].append(case)
                print(f"decode graphs, {name}, B {rows}, cfg {cfg_scale:g}, {'sampled' if sampled else 'greedy'}: "
                      f"graphs end {g_end} in {g_s:.2f} s (captures included), eager end {e_end} in {e_s:.2f} s, "
                      f"tokens {'equal' if case['tokens_equal'] else 'DIFFERENT'}")
                if not (case["tokens_equal"] and g_end == e_end):
                    raise AssertionError(f"graphed and eager decode disagree: {case}")
        stats = {"captures": engine.captures - captures, "capture_s": engine.capture_seconds - capture_s,
                 "pool_bytes": pool_bytes(engine)}
        out["engines"][name] = stats
        print(f"decode graphs, {name}: {stats['captures']} graphs captured in {stats['capture_s']:.2f} s; the "
              f"engine's graph pool holds {fmt_bytes(stats['pool_bytes'])}")
    return out


def check_qmm_logits(label: str, engine, enc, seq) -> tuple[dict, np.ndarray]:
    """Teacher-forced logits of ``seq`` on an int8 engine through kernel D
    against ``qmm_plain``, within ENC_TOL times the largest |logit|. Returns
    the check and the logits through the kernel."""
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm

    before = qmm.launches
    with_kernel = engine.forward(enc, seq)
    if qmm.launches == before:
        raise AssertionError(f"request {label}: the teacher-forced check did not run kernel D")
    set_qmm(engine.model, False)
    plain = engine.forward(enc, seq)
    set_qmm(engine.model, True)
    err, tol = float(np.abs(with_kernel - plain).max()), ENC_TOL * float(np.abs(plain).max())
    print(f"request {label}, window 0: teacher-forced logits {with_kernel.shape} through kernel D vs qmm_plain: "
          f"max_abs_err {err:.3e} (tol {tol:.3e} = {ENC_TOL:g} x the largest |logit|)")
    if not (np.isfinite(with_kernel).all() and err <= tol):
        raise AssertionError(f"request {label}: logits through kernel D disagree with qmm_plain: {err} above {tol}")
    return {"shape": list(with_kernel.shape), "max_abs_err": err, "tol": tol}, with_kernel


def int8_checks(ckpt: Path):
    """Request 3's checks on its int8 engine, window 0."""

    def checks(engine, args, vocab, first) -> dict:
        from mapperatorinator_tpu_torch import inference
        from mapperatorinator_tpu_torch.config import load_config
        from mapperatorinator_tpu_torch.decode.engine import _bucket
        from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline, get_eos_token_ids
        from mapperatorinator_tpu_torch.models.transformer import QDense

        model, out = engine.model, {}
        seconds, last = {}, [time.perf_counter()]

        def lap(name: str) -> None:  # each check's seconds, for the run's breakdown by phase
            now = time.perf_counter()
            seconds[name], last[0] = now - last[0], now

        n_qdense = sum(isinstance(m, QDense) for m in model.modules())
        if n_qdense != 133 or not model.cfg.backbone.quantized_kv:
            raise AssertionError(f"the int8 model has {n_qdense} QDense modules (want 133), "
                                 f"quantized_kv {model.cfg.backbone.quantized_kv}")
        frames = window0(args)
        enc = engine.encode_with_cond(frames)
        # the first prompt with the tokens it generated, teacher-forced: 512 rows
        # keep every decoder QDense but fc2 under the qmm gate
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        out["qmm_logits_check"], with_kernel = check_qmm_logits("3", engine, enc, seq)
        lap("qmm logits")

        # the fp model from the same checkpoint
        fp_engine, _ = inference.load_model(load_config("v32", ["seed=0", "gamemode=0", f"model_path={ckpt}"]))
        fp_enc = fp_engine.encode_with_cond(frames)
        fp_logits = fp_engine.forward(fp_enc, seq)
        rel = float(np.abs(fp_logits - with_kernel).max() / (np.abs(fp_logits).max() + 1e-9))
        agree = float((fp_logits.argmax(-1) == with_kernel.argmax(-1)).mean())
        with torch.inference_mode():
            sizes = {"weights_fp32": nbytes(fp_engine.model.state_dict()),
                     "weights_int8": nbytes(model.state_dict()),
                     "kv_cache_fp32": nbytes(fp_engine.model.init_cache(1, engine.max_length, enc)),
                     "kv_cache_int8": nbytes(model.init_cache(1, engine.max_length, enc))}
        # the prompt: the fp32 engine's greedy tokens from window 0's first prompt, no EOS, to DECODE_GRAPH_PROMPT
        lap("fp32 engine and sizes")
        long, _ = fp_engine.generate(fp_enc, first["ids"][:1], build_logits_pipeline(vocab, do_sample=False), [],
                                     max_length=DECODE_GRAPH_PROMPT)
        out["decode_graphs"] = decode_graphs({"fp32": fp_engine, "int8": engine}, {"fp32": fp_enc, "int8": enc},
                                             long[:, :DECODE_GRAPH_PROMPT], args, vocab)
        # the window and prompt of the parallel phase's tensor-parallel decodes
        np.savez(ckpt.parent / "tensor_decode.npz", frames=frames, ids=first["ids"][:1])
        lap("decode graphs")
        greedy_chain = (build_logits_pipeline(vocab, do_sample=False), get_eos_token_ids(vocab))
        steps = {"int8": profile_decode(engine, enc, first["ids"][:1], *greedy_chain, int8=True),
                 "fp32": profile_decode(fp_engine, fp_enc, first["ids"][:1], *greedy_chain, int8=False)}
        lap("decode step profiles")
        for name, modes in steps.items():
            for mode, st in modes.items():
                print(f"request 3 decode steps, {name} weights and KV, {mode}: {st['host_ms_per_step']:.3f} ms a "
                      f"step on the host clock; profiled, {st['device_ms_per_step']:.3f} ms of device kernels "
                      f"(idle share {st['idle_share']:.3f}) and {st['kernels_per_step']:.0f} launches a step, kernel "
                      f"D {st['qmm_device_ms_per_step']:.3f} ms (GEMV {st['qmm_gemv_calls']} calls, "
                      f"{st['qmm_gemv_device_us_per_call']:.2f} us a call; tensor cores {st['qmm_tc_calls']} calls, "
                      f"{st['qmm_tc_device_us_per_call']:.2f} us a call); most device time a step: "
                      + "; ".join(f"{k['name'][:48]} {k['device_us_per_step']:.1f} us in {k['calls_per_step']:.0f}"
                                  for k in st["top_kernels"]))
        out["decode_steps"] = steps
        del fp_engine
        torch.cuda.empty_cache()
        print(f"request 3: int8 vs fp32 logits from the same checkpoint: relative max error {rel:.4f} (bar "
              f"{INT8_BARS[0]}), argmax agreement {agree:.4f} (bar {INT8_BARS[1]}); weights on the card "
              f"{sizes['weights_fp32'] / 2**20:.1f} MiB fp32, {sizes['weights_int8'] / 2**20:.1f} MiB int8; "
              f"KV cache (batch 1, {engine.max_length} slots) {sizes['kv_cache_fp32'] / 2**20:.1f} MiB fp32, "
              f"{sizes['kv_cache_int8'] / 2**20:.1f} MiB int8")
        out.update(int8_vs_fp={"relative_max_error": rel, "argmax_agreement": agree}, bytes=sizes)
        if not (rel < INT8_BARS[0] and agree > INT8_BARS[1]):
            raise AssertionError(f"the int8 model misses the reference's bars: rel {rel}, agreement {agree}")

        # the engine's other entry points, on window 0's first prompt
        pad = vocab.pad_id
        surprisal, entropy, argmax = engine.forward_stats(enc, seq)
        x = with_kernel - with_kernel.max(-1, keepdims=True)
        probs = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
        want_ent = -np.sum(probs * np.log2(probs + 1e-10), axis=-1)
        targets = np.concatenate([seq[:, 1:], np.full((1, 1), pad)], axis=1)
        scored = targets < probs.shape[-1]  # a context token has no output probability: NaN, as in JAX
        want_sur = -np.log2(np.take_along_axis(probs, np.where(scored, targets, 0)[..., None], -1)[..., 0] + 1e-10)
        stats_err = max(float(np.abs(entropy - want_ent).max()),
                        float(np.abs(surprisal - want_sur)[:, :-1][scored[:, :-1]].max()))
        if not (stats_err <= STATS_TOL and np.isnan(surprisal[~scored]).all()
                and np.array_equal(argmax, with_kernel.argmax(-1))):
            raise AssertionError(f"forward_stats differs from the host reduction of forward: {stats_err}")

        ids = first["ids"][:1]
        P, valid = ids.shape[1], int((ids[0] != pad).sum())
        max_length = min(P + ENGINE_STEPS, engine.max_length)
        pipeline = build_logits_pipeline(vocab, do_sample=False)
        eos = get_eos_token_ids(vocab)
        tokens, end = engine.generate(enc, ids, pipeline, eos, max_length=max_length)
        forced = tokens[:, P:end]
        scores = engine.generate_forced(enc, ids, pipeline, forced)
        if scores.shape != (1, forced.shape[1], pipeline.vocab_size) or not np.array_equal(scores.argmax(-1), forced):
            raise AssertionError("generate_forced's scores do not pick the greedy tokens")
        # one beam takes the greedy token at every step; it may end earlier, on
        # an EOS candidate it retired (HF beam search scores finished
        # hypotheses by length-normalized log-probability)
        beams, lengths = engine.generate_beams(enc, ids, pipeline, eos, num_beams=1, max_length=max_length)
        n = int(lengths[0]) - valid
        hyp = beams[0, _bucket(P):_bucket(P) + n]
        greedy = n == forced.shape[1] and np.array_equal(hyp, forced[0])
        if not (greedy or (0 < n < forced.shape[1] and np.array_equal(hyp[:-1], forced[0, :n - 1])
                           and int(hyp[-1]) in eos)):
            raise AssertionError(f"one beam is not greedy decode: {hyp.tolist()} vs {forced[0].tolist()}")
        beams2, lengths2 = engine.generate_beams(enc, ids, pipeline, eos, num_beams=2, max_length=max_length)
        if not (np.isfinite(lengths2).all() and valid < int(lengths2[0]) <= valid + ENGINE_STEPS):
            raise AssertionError(f"two beams gave length {lengths2}")
        print(f"request 3 engine: forward_stats vs the host reduction of forward max error {stats_err:.2e} (tol "
              f"{STATS_TOL:g}), argmax equal; generate_forced on {forced.shape[1]} greedy tokens picks each; "
              f"generate_beams with 1 beam follows greedy decode ({n} tokens, "
              f"{'the same' if greedy else 'ending on a retired EOS'}), with 2 beams length {int(lengths2[0])}")
        out["engine_checks"] = {"stats_max_err": stats_err, "forced_tokens": int(forced.shape[1]),
                                "beam1_tokens": n, "beam1_is_greedy": greedy, "beams2_length": int(lengths2[0])}
        lap("engine entry points")
        out["check_s"] = seconds
        print("request 3 checks, seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
        return out

    return checks


def int8_request(tmp: Path, wav: Path, report: dict) -> dict:
    """Request 3: seeded random full-width v32 weights written as a native
    checkpoint, then served from it with int8 weights and KV cache."""
    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.models.io import save_checkpoint

    t0 = time.perf_counter()
    engine, vocab = inference.load_model(load_config("v32", ["model_path=", "seed=0", "gamemode=0"]))
    ckpt = tmp / "v32-checkpoint"
    save_checkpoint(ckpt, engine.model.cfg, engine.model.state_dict(), vocab)
    del engine
    torch.cuda.empty_cache()
    size = (ckpt / "params.msgpack").stat().st_size
    print(f"checkpoint: seeded random full-width v32 weights saved with save_checkpoint ({size / 2**20:.1f} MiB "
          f"params.msgpack) in {time.perf_counter() - t0:.1f} s")
    report["int8_checkpoint_bytes"] = size
    return serve("3-int8-checkpoint", tmp, wav, [f"model_path={ckpt}", "quantized_weights=true",
                                                 "quantized_kv=true", "do_sample=false"],
                 report, check_encoder=False, after=int8_checks(ckpt))


def maimod_phase(tmp: Path, wav: Path, osu: str, report: dict) -> dict:
    """MaiMod on request 2's .osu and WAV, with request 2's overrides (the
    fused mel). Random weights may write a map with no timing point, which
    MaiMod cannot read (its parser asserts one, as the JAX one does); the
    phase then analyses a dense map instead, a circle every 50 ms over the
    song (the ``ors`` maps' layout, ``OSU_TEMPLATE``), and prints which."""
    from mapperatorinator_tpu_torch import mai_mod
    from mapperatorinator_tpu_torch.config import load_config

    osu, source = maimod_map(tmp, osu, "request 2", AUDIO_SECONDS)
    args = load_config("v32", ["model_path=", "seed=0", f"audio_path={wav}", f"beatmap_path={osu}", "gamemode=0",
                               "do_sample=false", "train.model.spectrogram.implementation=pallas"])
    launches, report["maimod"] = maimod_run("maimod", mai_mod.select_config_for_gamemode(args), source)
    return launches


def maimod_map(tmp: Path, osu: str, request: str, seconds: float) -> tuple[str, str]:
    """(the map MaiMod analyses, what it is): ``osu``, the .osu a request
    wrote, where it has a timing point and hit objects, else a dense map of
    a circle every 50 ms over a song of ``seconds``."""
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap

    written = Beatmap.from_path(osu)
    if written.timing_points and written.hit_objects():
        return osu, f"{request}'s .osu"
    rng = np.random.default_rng(0)
    objects = "\n".join(f"{int(rng.integers(50, 450))},{int(rng.integers(50, 330))},{500 + k * 50},"
                        f"{5 if k % 8 == 0 else 1},0,0:0:0:0:" for k in range(int((seconds - 1) * 20)))
    dense = tmp / f"dense-{request.replace(' ', '-')}.osu"
    dense.write_text(OSU_TEMPLATE.format(i=0, bid=1, objects=objects))
    return str(dense), (f"a dense map ({request}'s has {len(written.timing_points)} timing points and "
                        f"{len(written.hit_objects())} hit objects)")


def maimod_run(label: str, args, source: str, widths=WHISPER_SMALL) -> tuple[dict, dict]:
    """``mai_mod.run_analysis``'s steps on resolved ``args`` (a full-width
    model of ``widths``), the engine kept for the checks; returns the
    launches and the record. Every batch's encoder and teacher-forced decoder
    (``forward_stats``: 12 self-attention calls, causal with the key mask,
    and 12 cross) must launch kernel B, 36 launches a batch (a T5 model's
    self-attention carries its position bias and runs plain: its 12 cross
    calls a batch), and the fused mel must run where the model's config picks
    it. On the first batch,
    ``forward_stats`` through the kernel is held against the same call on
    plain attention: surprisal and entropy within ENC_TOL, argmax ids equal
    except at near-ties (where the plain logits of the two ids differ by at
    most twice the largest logit error between the two paths), which are
    counted."""
    from mapperatorinator_tpu_torch import inference, mai_mod
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold: the peak below is the run's own
    engine, vocab = inference.load_model(args)
    check_full_width(engine.model, widths)
    inference.compile_args(args, vocab, verbose=False)
    generation_config, _ = inference.get_config(args)

    calls, first = [], {}
    forward_stats = engine.forward_stats

    def recorded(encoder_states, ids, *a, **kw):
        out = forward_stats(encoder_states, ids, *a, **kw)
        calls.append([int(x) for x in ids.shape])
        if not first:
            first.update(enc=encoder_states, ids=ids, out=out)
        return out

    engine.forward_stats = recorded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    fused_mel.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        records = mai_mod.ai_mod(args, generation_config=generation_config, engine=engine, vocab=vocab,
                                 beatmap_path=args.beatmap_path, raw_output=True, structured=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**attention_launches(), "fused_mel": fused_mel.launches}
    peak = torch.cuda.max_memory_allocated() - held
    engine.forward_stats = forward_stats
    windows = sum(c[0] for c in calls)
    print(f"{label} ({args.version}, gamemode {args.gamemode}) on {source}: {windows} windows in {len(calls)} "
          f"forward_stats calls (B, T) {calls}, {wall:.2f} s, {len(records)} suggestions, peak memory "
          f"{peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB held before, launches {launches}")
    b = engine.model.cfg.backbone
    want = {name: 0 for name in attention_launches()}
    per_call = b.decoder_layers if b.position_scheme == "t5_relpos" else b.encoder_layers + 2 * b.decoder_layers
    want["flash_attention_fwd"] = per_call * len(calls)
    fused = engine.model.spectrogram.implementation == "pallas"
    if not calls or {k: launches[k] for k in want} != want or (launches["fused_mel"] > 0) != fused:
        raise AssertionError(f"{label} launched {launches}, not {want} and the fused mel ({fused})")

    enc, ids, (sur, ent, arg) = first["enc"], first["ids"], first["out"]
    set_flash(engine.model, False)
    p_sur, p_ent, p_arg = forward_stats(enc, ids)
    plain_logits = engine.forward(enc, ids)
    set_flash(engine.model, True)
    flash_logits = engine.forward(enc, ids)
    logit_err = float(np.abs(flash_logits - plain_logits).max())
    scored = ~np.isnan(p_sur)
    sur_err = float(np.abs(sur - p_sur)[scored].max()) if scored.any() else 0.0
    ent_err = float(np.abs(ent - p_ent).max())
    differ = np.argwhere(arg != p_arg)
    gaps = [float(plain_logits[b, t, p_arg[b, t]] - plain_logits[b, t, arg[b, t]]) for b, t in differ]
    ties = sum(g <= 2 * logit_err for g in gaps)
    check = {"shape": [int(x) for x in ids.shape], "source_positions": int(enc.shape[1]),
             "surprisal_max_err": sur_err, "entropy_max_err": ent_err, "logits_max_err": logit_err,
             "argmax_differ": len(gaps), "near_ties": ties, "tol": ENC_TOL}
    print(f"{label}, first batch {tuple(ids.shape)} over {enc.shape[1]} source positions: forward_stats through "
          f"kernel B vs plain attention: surprisal max_abs_err {sur_err:.3e}, entropy {ent_err:.3e} (tol "
          f"{ENC_TOL:g}); argmax ids differ at {len(gaps)} of {arg.size} positions, {ties} of them near-ties "
          f"(logits max_abs_err {logit_err:.3e})")
    if not (np.array_equal(np.isnan(sur), ~scored) and sur_err <= ENC_TOL and ent_err <= ENC_TOL
            and ties == len(gaps) and np.isfinite(ent).all()):
        raise AssertionError(f"{label}'s forward_stats through kernel B disagrees with plain attention: {check}")
    record = {"map": source, "version": args.version, "gamemode": args.gamemode, "wall_s": wall,
              "windows": windows, "calls": calls, "suggestions": len(records), "peak_mem_gb": peak / 2**30,
              "held_before_gb": held / 2**30, "launches": launches, "check": check,
              "report_head": printed.getvalue().splitlines()[:12]}
    del engine, enc, first
    torch.cuda.empty_cache()
    return launches, record


def v31_phase(tmp: Path, wav: Path, report: dict) -> dict:
    """v31 at full width (RoPEWhisper-small: 80 mels + 384 condition channels
    into the stem, 4 096 source frames, an 8 192-slot decode buffer), with
    the difficulty, mapper and song-position embedders, on the song of the
    v32 requests (one v31 window):

    * request v31-1: v31's defaults (sampled, temperature 0.9, top-p 0.9,
      TIMING + KIAI + MAP + SV, fp32, the FFT mel) with seeded random weights,
      which are then written as a native checkpoint whose config picks the
      fused mel;
    * request v31-2: greedy from that checkpoint (v31-1's first
      ``CUT_DECODER_LAYERS`` decoder layers) with int8 weights and KV
      (kernels A and B at v31's shapes; D's GEMV, and its tiles on the
      prefills: the JAX gate sends the encoder's 2 048-row products to the
      plain expression), then ``precompile=true``'s warm-up on its engine;
    * MaiMod under the v30 preset (gamemodes [0]) on a taiko map, which falls
      back to v31 with ``inference.model_path`` at the checkpoint.

    Each request's first window is encoded with its conditions through the
    kernels and held against the plain path (``check_encoder_states``), and
    another difficulty must move the states; MaiMod's first batch is held
    against plain attention as in ``maimod_run``."""
    from mapperatorinator_tpu_torch import inference, mai_mod
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.models.io import save_checkpoint

    cond = [f"difficulty={V31_DIFFICULTY}", f"mapper_id={V31_MAPPER}"]
    ckpt = tmp / "v31-checkpoint"

    def write_checkpoint(engine, args, vocab, first) -> dict:
        if vocab.get_mapper_idx(V31_MAPPER) == vocab.num_mapper_classes:
            raise AssertionError(f"mapper {V31_MAPPER} is not in the v31 vocabulary")
        t0 = time.perf_counter()
        # the first CUT_DECODER_LAYERS decoder layers of v31-1's model
        cfg = dataclasses.replace(engine.model.cfg, spectrogram_implementation="pallas", backbone=dataclasses.replace(
            engine.model.cfg.backbone, decoder_layers=CUT_DECODER_LAYERS))
        cut = [f".decoder.layers.{i}." for i in range(CUT_DECODER_LAYERS, engine.model.cfg.backbone.decoder_layers)]
        state = {k: v for k, v in engine.model.state_dict().items() if not any(c in k for c in cut)}
        save_checkpoint(ckpt, cfg, state, vocab)
        return {"checkpoint_s": time.perf_counter() - t0,
                "checkpoint_bytes": (ckpt / "params.msgpack").stat().st_size}

    def precompile(engine, args, vocab, first) -> dict:
        t0 = time.perf_counter()
        inference.warm_engine(engine, args.train)
        seconds = time.perf_counter() - t0
        print(f"request v31-2: precompile=true's warm-up (a conditioned encode, then the prefill of every prompt "
              f"bucket at B 1 and B 2 into {engine.max_length} slots) in {seconds:.2f} s")
        return {"precompile_s": seconds}

    first = serve("v31-1-defaults", tmp, wav, cond, report, check_encoder=True, after=write_checkpoint, config="v31")
    second = serve("v31-2-int8-fused-mel", tmp, wav,
                   [f"model_path={ckpt}", "quantized_weights=true", "quantized_kv=true", "do_sample=false", *cond],
                   report, check_encoder=True, after=precompile, config="v31", widths=WHISPER_SMALL_CUT)
    if first["flash_attention_fwd"] == 0 or first["fused_mel"] != 0 or second["flash_attention_fwd"] == 0 \
            or second["fused_mel"] == 0 or second["qmm"] == 0:
        raise AssertionError(f"v31's requests launched {first} and {second}: B on both, A on v31-2 only, D on "
                             "v31-2's decode steps")

    taiko = tmp / "taiko.osu"
    rng = np.random.default_rng(1)
    objects = "\n".join(f"256,192,{500 + k * 125},1,{int(rng.choice([0, 2, 8]))},0:0:0:0:"
                        for k in range(int((AUDIO_SECONDS - 1) * 8)))
    taiko.write_text(OSU_TEMPLATE.format(i=1, bid=2, objects=objects).replace("Mode: 0", "Mode: 1"))
    args = load_config("v30", ["seed=0", f"audio_path={wav}", f"beatmap_path={taiko}", "do_sample=false"])
    fallback = mai_mod.select_config_for_gamemode(args, overrides=[f"inference.model_path={ckpt}"])
    if (fallback.version, fallback.gamemode, fallback.model_path) != ("Mapperatorinator V31", 1, str(ckpt)):
        raise AssertionError(f"MaiMod did not fall back to v31 at the checkpoint: {fallback.version}, "
                             f"gamemode {fallback.gamemode}, {fallback.model_path}")
    maimod, record = maimod_run("v31 MaiMod", fallback, "a taiko map under the v30 preset (gamemodes [0])",
                                widths=WHISPER_SMALL_CUT)
    report["v31"] = {"maimod": record}
    return {k: first.get(k, 0) + second.get(k, 0) + maimod.get(k, 0) for k in first}


def whisper_kernels(report: dict) -> list[dict]:
    """Kernels B and D at the whisper_abs shapes, each with its own
    kernels-line entry (its launches filled in from the requests): B (fp32
    route) at a whisper encoder window, B 1, T = S = 512, D 64, no mask,
    with H 12 (v29) and H 8 (v28), against both plain versions within 2e-5
    and timed beside SDPA and its bound; D's two paths at v28's fc1
    (``QMM_TIMED_V28``), as ``check_qmm`` held them (every v28 shape of
    ``QMM_SHAPES``) and ``check_qmm`` / ``time_qmm_cold`` timed them."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import attention_plain, attention_plain_fp32_tc, flash_fwd_fp32

    gen = torch.Generator(device="cuda").manual_seed(6)
    entries, tol = [], ATTN_TOL[torch.float32]
    for size, H in (("small", 12), ("base", 8)):
        B, T, D = 1, 512, 64
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(3))
        out = flash_fwd_fp32(q, k, v, None, False, 0, D**-0.5, False)[0]
        err = {name: (out - fn(q, k, v, None)).abs().max().item()
               for name, fn in (("tc", attention_plain_fp32_tc), ("fp32", attention_plain))}
        qs, ks, vs = sdpa_layout(q, k, v)
        bounds = fp32_bounds(4.0 * H * T * T * D * B, 4 * 4 * B * T * H * D)  # q, k, v in; out
        t_ = in_turns({"plain": lambda: attention_plain(q, k, v, None),
                       "kernel": lambda: flash_fwd_fp32(q, k, v, None, False, 0, D**-0.5, False),
                       "library": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
        shape = f"B{B} T{T} S{T} H{H} D{D} fp32"
        print(f"flash_attention_fwd fp32 whisper-{size} encoder {shape}: max_abs_err {err['tc']:.3e} against the "
              f"plain version that splits as the kernel does, {err['fp32']:.3e} against the fp32 one (tol {tol:g}); "
              f"kernel {t_['kernel']:.4f} ms, plain {t_['plain']:.4f} ms, scaled_dot_product_attention "
              f"{t_['library']:.4f} ms ({t_['kernel'] / t_['library']:.2f}x); bound {bounds['bound_ms']:.4f} ms "
              f"(three TF32 products {bounds['tf32x3_ms']:.4f}, fp32 FMAs {bounds['fma_ms']:.4f}, bytes "
              f"{bounds['bytes_ms']:.4f})")
        if not all(e <= tol for e in err.values()):
            raise AssertionError(f"flash_attention fp32 whisper-{size} {shape}: {err} above {tol}")
        entries.append({"name": f"flash_attention_fwd_whisper_{size}", "route": "cuda",
                        "source": "mapperatorinator_tpu_torch/csrc/flash_attention.cu",
                        "replaces": "mapperatorinator_tpu/ops/attention_kernel.py:88", "max_abs_err": max(err.values()),
                        "tol": "2e-5", "ms": t_["kernel"], "plain_ms": t_["plain"], "bound_ms": bounds["bound_ms"],
                        "bound_by": bounds["bound_by"], "library_ms": t_["library"],
                        "timed_shape": f"{shape} (a whisper-{size} encoder window)", "bounds": bounds})
        del q, k, v, qs, ks, vs, out
    torch.cuda.empty_cache()

    fp32 = str(torch.float32)
    v28 = [c for c in report["qmm_cases"] if c["dtype"] == fp32 and (c["K"], c["N"]) in
           ((512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 1024))]
    for path, cases, what in (("qmm", report["qmm_cold_cases"], "a decode step's fc1, the GEMV path, cold L2"),
                              ("qmm_tc", report["qmm_cases"], "an encoder window's fc1, the tensor-core path")):
        rows, k, n = QMM_TIMED_V28[path]
        timed = next(c for c in cases if c["dtype"] == fp32 and (c["rows"], c["K"], c["N"]) == (rows, k, n))
        held = [c for c in v28 if c["path"] == path]
        entries.append({"name": f"{path}_whisper_base", "route": "cuda",
                        "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
                        "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80",
                        "max_abs_err": max(c["max_abs_err"] for c in held),
                        "tol": f"{QMM_TOL[torch.float32]:g} x max(1, max |reference output|)",
                        "held_shapes": [[c["rows"], c["K"], c["N"]] for c in held], "ms": timed["ms"],
                        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                        "library_ms": timed["library_ms"], "device_ms": timed.get("device_ms"),
                        "timed_shape": f"rows{rows} K{k} N{n} fp32 ({what}; v28)"})
    return entries


def write_safetensors(path: Path, tensors: dict) -> None:
    """A safetensors file of fp32 tensors: the header length, the JSON header
    (padded to 8 bytes), the tensors' bytes end to end."""
    header, offset = {}, 0
    for name, t in tensors.items():
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + 4 * t.numel()]}
        offset += 4 * t.numel()
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little") + text)
        for t in tensors.values():
            f.write(t.float().contiguous().cpu().numpy().data)


def write_whisper_checkpoint(directory: Path, config: str, fmt: str, seed: int) -> dict:
    """A published (HF-format) checkpoint of ``-cn config``'s stock whisper
    model at full width with seeded random weights, as the reference's
    state dict names them: ``config.json``, ``tokenizer.json`` and
    ``model.safetensors`` (``fmt`` "safetensors", through
    :func:`write_safetensors`) or ``pytorch_model.bin`` (``torch.save``)."""
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
    from mapperatorinator_tpu_torch.osu import build_vocabulary

    t0 = time.perf_counter()
    args = load_config(config)
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    b = cfg.backbone
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, sd = b.d_model, {}

    def rand(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).cpu()

    def linear(key, out, inp, bias=True):
        sd[f"{key}.weight"] = rand(out, inp, std=inp**-0.5)
        if bias:
            sd[f"{key}.bias"] = rand(out, std=0.02)

    def norm(key):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = rand(d, std=0.02, mean=1.0), rand(d, std=0.02)

    t = "transformer.model"
    for conv, inp in (("conv1", b.num_mel_bins), ("conv2", d)):
        sd[f"{t}.encoder.{conv}.weight"] = rand(d, inp, 3, std=(3 * inp) ** -0.5)
        sd[f"{t}.encoder.{conv}.bias"] = rand(d, std=0.02)
    sd[f"{t}.decoder.embed_tokens.weight"] = rand(cfg.vocab_size_out, d)
    sd[f"{t}.decoder.embed_positions.weight"] = rand(b.max_target_positions, d)
    for side, n, ffn in (("encoder", b.encoder_layers, b.encoder_ffn), ("decoder", b.decoder_layers, b.decoder_ffn)):
        for i in range(n):
            p = f"{t}.{side}.layers.{i}"
            for attn in ("self_attn", "encoder_attn") if side == "decoder" else ("self_attn",):
                for proj in ("q", "k", "v", "out"):
                    linear(f"{p}.{attn}.{proj}_proj", d, d, bias=proj != "k")  # k_proj has no bias
                norm(f"{p}.{attn}_layer_norm")
            norm(f"{p}.final_layer_norm")
            linear(f"{p}.fc1", ffn, d)
            linear(f"{p}.fc2", d, ffn)
        norm(f"{t}.{side}.layer_norm")
    linear("transformer.proj_out", cfg.vocab_size_out, d, bias=False)
    sd["decoder_embedder.weight"] = rand(cfg.vocab_size_in, d)
    linear("encoder_embedder", d, cfg.n_mels + cfg.cond_size)

    hf_cfg = {"backbone_model_name": args.train.model.name, "vocab_size": cfg.vocab_size_out,
              "backbone_config": {"d_model": d, "encoder_layers": b.encoder_layers, "decoder_layers": b.decoder_layers,
                                  "encoder_attention_heads": b.encoder_heads,
                                  "decoder_attention_heads": b.decoder_heads, "encoder_ffn_dim": b.encoder_ffn,
                                  "decoder_ffn_dim": b.decoder_ffn, "max_source_positions": b.max_source_positions,
                                  "max_target_positions": b.max_target_positions, "num_mel_bins": b.num_mel_bins,
                                  "tie_word_embeddings": b.tie_word_embeddings},
              **{k: getattr(cfg, k) for k in (
                  "vocab_size_in", "num_classes", "num_mappers", "input_features", "project_encoder_input",
                  "embed_decoder_input", "cond_dim", "cond_size", "spectrogram_log_scale", "sample_rate", "n_fft",
                  "n_mels", "hop_length", "f_min", "f_max", "pad_mode", "rhythm_token_start", "rhythm_token_end",
                  "max_target_positions")}}
    directory.mkdir(parents=True)
    (directory / "config.json").write_text(json.dumps(hf_cfg))
    vocab.save_pretrained(directory)
    if fmt == "safetensors":
        write_safetensors(directory / "model.safetensors", sd)
    else:
        torch.save(sd, directory / "pytorch_model.bin")
    weights = next(directory.glob("model.safetensors" if fmt == "safetensors" else "pytorch_model.bin"))
    record = {"config": config, "backbone": args.train.model.name, "file": weights.name,
              "bytes": weights.stat().st_size, "tensors": len(sd), "write_s": time.perf_counter() - t0}
    print(f"{config}: seeded random {args.train.model.name} weights written as a published checkpoint, "
          f"{weights.name} ({record['bytes'] / 2**20:.1f} MiB, {len(sd)} tensors) in {record['write_s']:.2f} s")
    return record


def whisper_phase(tmp: Path, report: dict) -> tuple[dict, list[dict]]:
    """The whisper_abs family at full width from published (HF-format)
    checkpoints the script writes (``write_whisper_checkpoint``), on a
    ``WHISPER_AUDIO_SECONDS`` song:

    * kernels B and D at the family's shapes (``whisper_kernels``);
    * v29 (``openai/whisper-small``: d_model 768, 12 + 12 layers, 12 heads,
      ffn 3 072, 1 024 mel frames -> 512 source positions, 2 048 target
      positions) from a fp32 ``model.safetensors``: one request through
      ``load_model`` / ``generate`` at the v29 preset (sampled at
      temperature 0.9 and top-p 0.9) with ``super_timing=false`` (the
      preset's 20-member ensemble took 52.5 s on v32, PERF.md section 5);
      its first window's encoder states through B held against the plain
      path;
    * v28 (``openai/whisper-base``: d_model 512, 6 + 6 layers, 8 heads, ffn
      2 048) from ``pytorch_model.bin``: one greedy request with int8
      weights and KV, ``super_timing=false``; its first window's
      teacher-forced logits through D held against the plain version.

    Each must write a .osu that the port's parser reads; B must launch in
    both, D in v28's. Returns the requests' launches and the four
    kernels-line entries with their launches filled in."""
    entries = whisper_kernels(report)
    wav = write_wav(tmp / "whisper.wav", WHISPER_AUDIO_SECONDS, seed=2)
    records = {"v29": write_whisper_checkpoint(tmp / "v29-hf", "v29", "safetensors", seed=29),
               "v28": write_whisper_checkpoint(tmp / "v28-hf", "v28", "bin", seed=28)}

    def qmm_logits(engine, args, vocab, first) -> dict:
        frames = window0(args)
        enc = engine.encode_with_cond(frames)
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        return {"qmm_logits_check": check_qmm_logits("whisper-v28", engine, enc, seq)[0]}

    small = serve("whisper-v29", tmp, wav, [f"model_path={tmp / 'v29-hf'}", "super_timing=false"], report,
                  check_encoder=True, config="v29")
    base = serve("whisper-v28-int8", tmp, wav, [f"model_path={tmp / 'v28-hf'}", "super_timing=false",
                                                 "quantized_weights=true", "quantized_kv=true", "do_sample=false"],
                 report, check_encoder=False, after=qmm_logits, config="v28", widths=WHISPER_BASE)
    if small["flash_attention_fwd"] == 0 or base["flash_attention_fwd"] == 0 or base["qmm"] == 0 \
            or base["qmm_tc"] == 0:
        raise AssertionError(f"the whisper requests launched {small} and {base}: B in both, D's two paths in v28's")
    launches = {"flash_attention_fwd_whisper_small": small["flash_attention_fwd"],
                "flash_attention_fwd_whisper_base": base["flash_attention_fwd"],
                "qmm_whisper_base": base["qmm"], "qmm_tc_whisper_base": base["qmm_tc"]}
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    report["whisper_checkpoints"] = records
    return {k: small.get(k, 0) + base.get(k, 0) for k in small}, entries


def t5_reference_state(cfg, seed: int) -> dict:
    """The reference's state dict of ``cfg``'s model at full width: a T5 v1.1
    backbone under ``transformer.`` by ``T5ForConditionalGeneration``'s
    names, drawn as HF's T5 initialises one (factor 1: q from N(0, (d_model
    d_kv)^-0.5), k and v from N(0, d_model^-0.5), o from N(0, (heads
    d_kv)^-0.5), the relative-position tables from N(0, d_model^-0.5), wi_0
    and wi_1 from N(0, d_model^-0.5), wo from N(0, d_ff^-0.5), the shared
    token table from N(0, 1), RMSNorm scales 1), so that its unscaled
    attention sees logits of the size a T5 model has; then the wrapper's
    decoder token table, its encoder projection (the mels and the style
    embedding) and its style table."""
    from mapperatorinator_tpu_torch.models.mapperatorinator import encoder_input_width

    b = cfg.backbone
    d, h, dkv, ffn = b.d_model, b.decoder_heads, b.head_dim, b.encoder_ffn
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sd = {}

    def rand(*shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).cpu()

    def attn(p):
        sd[f"{p}.q.weight"] = rand(h * dkv, d, std=(d * dkv) ** -0.5)
        sd[f"{p}.k.weight"], sd[f"{p}.v.weight"] = rand(h * dkv, d, std=d**-0.5), rand(h * dkv, d, std=d**-0.5)
        sd[f"{p}.o.weight"] = rand(d, h * dkv, std=(h * dkv) ** -0.5)

    for side, n in (("encoder", b.encoder_layers), ("decoder", b.decoder_layers)):
        t = f"transformer.{side}"
        sd[f"{t}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = rand(
            b.relative_attention_num_buckets, h, std=d**-0.5)
        for i in range(n):
            p = f"{t}.block.{i}.layer"
            attn(f"{p}.0.SelfAttention")
            if side == "decoder":
                attn(f"{p}.1.EncDecAttention")
            ff = 2 if side == "decoder" else 1
            for j in range(ff + 1):
                sd[f"{p}.{j}.layer_norm.weight"] = torch.ones(d)
            sd[f"{p}.{ff}.DenseReluDense.wi_0.weight"] = rand(ffn, d, std=d**-0.5)
            sd[f"{p}.{ff}.DenseReluDense.wi_1.weight"] = rand(ffn, d, std=d**-0.5)
            sd[f"{p}.{ff}.DenseReluDense.wo.weight"] = rand(d, ffn, std=ffn**-0.5)
        sd[f"{t}.final_layer_norm.weight"] = torch.ones(d)
    sd["transformer.shared.weight"] = rand(cfg.vocab_size_out, d, std=1.0)
    if not b.tie_word_embeddings:
        sd["transformer.lm_head.weight"] = rand(cfg.vocab_size_out, d, std=1.0)
    sd["decoder_embedder.weight"] = rand(cfg.vocab_size_in, d, std=1.0)
    width = encoder_input_width(cfg)
    sd["encoder_embedder.weight"], sd["encoder_embedder.bias"] = rand(d, width, std=width**-0.5), rand(d, std=0.02)
    if cfg.do_style_embed:
        sd["style_embedder.embedding_table.weight"] = rand(cfg.num_classes + 1, d, std=1.0)
    return sd


def reference_event_module():
    """A stand-in for the reference's ``osuT5.osuT5.event`` module: the
    port's event and context types and ``EventRange`` as classes of that
    module, so that a tokenizer state pickles under the reference's path, as
    the osuT5 releases' ``custom_checkpoint_0.pkl`` did."""
    import enum
    import types

    from mapperatorinator_tpu_torch.osu.events import ContextType, EventType

    mod = types.ModuleType(REFERENCE_EVENTS)
    mod.EventType = enum.Enum("EventType", [(m.name, m.value) for m in EventType], module=REFERENCE_EVENTS)
    mod.ContextType = enum.Enum("ContextType", [(m.name, m.value) for m in ContextType], module=REFERENCE_EVENTS)
    mod.EventRange = dataclasses.make_dataclass("EventRange", [("type", object), ("min_value", int),
                                                               ("max_value", int)], module=REFERENCE_EVENTS)
    return mod


def write_legacy_tokenizer(path: Path, vocab) -> None:
    """``vocab``'s state with its enum keys and event ranges as instances of
    :func:`reference_event_module`'s classes, written with ``torch.save``;
    the stand-in module is importable only while it is written."""
    mod = reference_event_module()
    sd = vocab.state_dict()

    def er(x):
        return mod.EventRange(mod.EventType(x["type"]), x["min_value"], x["max_value"])

    state = dict(sd, event_ranges=[er(x) for x in sd["event_ranges"]],
                 input_event_ranges=[er(x) for x in sd["input_event_ranges"]],
                 event_range={mod.EventType(k): er(x) for k, x in sd["event_range"].items()},
                 **{field: {cls(k): v for k, v in sd[field].items()} for field, cls in (
                     ("context_sos", mod.ContextType), ("context_eos", mod.ContextType),
                     ("event_start", mod.EventType), ("event_end", mod.EventType))})
    names = ("osuT5", "osuT5.osuT5", REFERENCE_EVENTS)
    sys.modules.update({"osuT5": type(mod)("osuT5"), "osuT5.osuT5": type(mod)("osuT5.osuT5"), REFERENCE_EVENTS: mod})
    try:
        torch.save(state, path)
    finally:
        for name in names:
            sys.modules.pop(name, None)


def write_t5_checkpoints(directory: Path, seed: int):
    """One set of seeded T5 v1.1-base weights at full width
    (:func:`t5_reference_state`), of the model the port's ``t5_base`` preset
    builds with v32's vocabulary (so that ``-cn v32`` serves it), written in
    two forms: a published (HF-format) directory (``config.json`` with
    ``backbone_model_name`` google/t5-v1_1-base and T5Config's names,
    ``tokenizer.json``, ``model.safetensors`` through
    :func:`write_safetensors`) and a legacy accelerate directory
    (``pytorch_model.bin`` and the pickled tokenizer,
    :func:`write_legacy_tokenizer`). Returns (the HF directory, the legacy
    one, the training config, the record)."""
    from mapperatorinator_tpu_torch.config import load_config, load_train_config
    from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
    from mapperatorinator_tpu_torch.osu import build_vocabulary

    t0 = time.perf_counter()
    train = load_train_config("t5_base", T5_LEGACY_TRAIN)
    vocab = build_vocabulary(load_config("v32").train)
    cfg = build_config(train, vocab)
    b = cfg.backbone
    sd = t5_reference_state(cfg, seed)
    hf_cfg = {"backbone_model_name": train.model.name, "vocab_size": cfg.vocab_size_out,
              "max_source_positions": b.max_source_positions,
              "backbone_config": {"d_model": b.d_model, "num_layers": b.encoder_layers,
                                  "num_decoder_layers": b.decoder_layers, "num_heads": b.decoder_heads,
                                  "d_ff": b.encoder_ffn, "d_kv": b.head_dim, "feed_forward_proj": "gated-gelu",
                                  "relative_attention_num_buckets": b.relative_attention_num_buckets,
                                  "relative_attention_max_distance": b.relative_attention_max_distance,
                                  "layer_norm_epsilon": b.norm_eps, "tie_word_embeddings": b.tie_word_embeddings},
              **{k: getattr(cfg, k) for k in (
                  "vocab_size_in", "num_classes", "num_mappers", "input_features", "project_encoder_input",
                  "embed_decoder_input", "do_style_embed", "do_difficulty_embed", "do_mapper_embed",
                  "do_song_position_embed", "cond_dim", "cond_size", "spectrogram_log_scale", "sample_rate", "n_fft",
                  "n_mels", "hop_length", "f_min", "f_max", "pad_mode", "rhythm_token_start", "rhythm_token_end",
                  "max_target_positions")}}
    hf, legacy = directory / "hf", directory / "legacy"
    hf.mkdir(parents=True)
    (hf / "config.json").write_text(json.dumps(hf_cfg))
    vocab.save_pretrained(hf)
    write_safetensors(hf / "model.safetensors", sd)
    legacy.mkdir()
    torch.save(sd, legacy / "pytorch_model.bin")
    write_legacy_tokenizer(legacy / "custom_checkpoint_0.pkl", vocab)
    record = {"backbone": train.model.name, "tensors": len(sd), "parameters": sum(t.numel() for t in sd.values()),
              "safetensors_bytes": (hf / "model.safetensors").stat().st_size,
              "bin_bytes": (legacy / "pytorch_model.bin").stat().st_size, "write_s": time.perf_counter() - t0}
    print(f"T5: seeded {train.model.name} weights ({record['parameters'] / 1e6:.1f} M parameters, {len(sd)} "
          f"tensors) written as a published checkpoint ({record['safetensors_bytes'] / 2**20:.1f} MiB "
          f"model.safetensors) and a legacy one ({record['bin_bytes'] / 2**20:.1f} MiB pytorch_model.bin and "
          f"the tokenizer pickled under {REFERENCE_EVENTS}) in {record['write_s']:.2f} s")
    return hf, legacy, train, record


def unscaled_attention(q, k, v, report: dict, key: str = "t5_cross_attention",
                       label: str = "T5-base cross attention", name: str = "flash_attention_fwd_t5_cross",
                       source: str = "T5-base's cross attention, request (a)'s model") -> dict:
    """Kernel B as an unscaled call (``sm_scale`` 1.0) meets it, on the q, k
    and v that a request's model computed (T5's cross attention in its
    first decoder layer, at a T5 model's own activations: logits of std ~1,
    and values as large as the encoder states make them; nGPT's first
    encoder self-attention, q and k normalised and scaled): each route
    against both its plain versions. An attention output's rounding error grows with
    its values and the keys it sums over, so each route's tolerance is its
    bar (2e-5 fp32, 2e-2 bf16) or three times the distance of its
    rounding-faithful plain version from a float64 evaluation on the same
    inputs, whichever is larger: the kernel may be no less accurate than
    the plain version by more than that, and is held to float64 at the
    same tolerance. The fp32 route is timed beside
    SDPA at ``scale=1.0`` and its bound. Returns the kernels-line entry, its
    launches filled in by the caller."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (attention_plain, attention_plain_bf16_tc,
                                                                 attention_plain_fp32_tc, flash_fwd_fp32,
                                                                 flash_fwd_sm90)

    q, k, v = (x.contiguous() for x in (q, k, v))
    (B, T, H, D), S = q.shape, k.shape[1]

    def dist(a, b):
        return (a.double() - b.double()).abs().max().item()

    routes = {}
    for route, dtype, faithful, bar in (("fp32", torch.float32, attention_plain_fp32_tc, ATTN_TOL[torch.float32]),
                                        ("sm90", torch.bfloat16, attention_plain_bf16_tc, ATTN_TOL[torch.bfloat16])):
        xs = [x.to(dtype) for x in (q, k, v)]
        launch = flash_fwd_fp32 if route == "fp32" else flash_fwd_sm90
        out = launch(*xs, None, False, 0, 1.0, False)[0]
        plain, rounded = attention_plain(*xs, None, sm_scale=1.0), faithful(*xs, None, sm_scale=1.0)
        qd, kd, vd = (x.double() for x in xs)  # the same inputs, evaluated in float64
        truth = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd, kd), -1), vd)
        tol = max(bar, 3 * dist(rounded, truth))
        routes[route] = {"max_abs_err": {"tc": dist(out, rounded), "fp32": dist(out, plain)}, "tol": tol,
                         "bar": bar, "fp64": {"kernel": dist(out, truth), "plain": dist(plain, truth),
                                              "plain_rounded": dist(rounded, truth)},
                         "max_abs_out": truth.abs().max().item()}
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    qs, ks, vs = sdpa_layout(q, k, v)
    bounds = fp32_bounds(4.0 * B * H * T * S * D, 4 * 2 * B * H * D * (T + S))  # q, out; k, v
    t_ = in_turns({"plain": lambda: attention_plain(q, k, v, None, sm_scale=1.0),
                   "kernel": lambda: flash_fwd_fp32(q, k, v, None, False, 0, 1.0, False),
                   "library": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, scale=1.0)})
    shape = f"B{B} T{T} S{S} H{H} D{D} fp32 sm_scale 1.0"
    f32, b16 = routes["fp32"], routes["sm90"]
    print(f"flash_attention_fwd {label} {shape} (the model's q, k, v: logits std "
          f"{logits.std().item():.3f}, max |logit| {logits.abs().max().item():.2f}, max |out| "
          f"{f32['max_abs_out']:.2f}): fp32 route max_abs_err {f32['max_abs_err']['tc']:.3e} against the plain "
          f"version that splits as it does, {f32['max_abs_err']['fp32']:.3e} against the fp32 one (tol "
          f"{f32['tol']:.3e}); from float64: kernel {f32['fp64']['kernel']:.3e}, plain {f32['fp64']['plain']:.3e}, "
          f"split plain {f32['fp64']['plain_rounded']:.3e}; bf16 route max_abs_err {b16['max_abs_err']['tc']:.3e} "
          f"and {b16['max_abs_err']['fp32']:.3e} (tol {b16['tol']:.3e}); from float64: kernel "
          f"{b16['fp64']['kernel']:.3e}, plain {b16['fp64']['plain']:.3e}, rounding plain "
          f"{b16['fp64']['plain_rounded']:.3e}")
    print(f"flash_attention_fwd {label} {shape}: kernel {t_['kernel']:.4f} ms, plain "
          f"{t_['plain']:.4f} ms, scaled_dot_product_attention(scale=1.0) {t_['library']:.4f} ms "
          f"({t_['kernel'] / t_['library']:.2f}x); bound {bounds['bound_ms']:.4f} ms (three TF32 products "
          f"{bounds['tf32x3_ms']:.4f}, fp32 FMAs {bounds['fma_ms']:.4f}, bytes {bounds['bytes_ms']:.4f})")
    check = {"shape": shape, "routes": routes, "logits_std": logits.std().item(),
             "logits_max_abs": logits.abs().max().item()}
    report[key] = check
    if not all(e <= r["tol"] for r in routes.values() for e in (*r["max_abs_err"].values(), r["fp64"]["kernel"])):
        raise AssertionError(f"kernel B at the unscaled {label} disagrees with its plain versions: {check}")
    return {"name": name, "route": "cuda",
            "source": "mapperatorinator_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mapperatorinator_tpu/ops/attention_kernel.py:88",
            "max_abs_err": max(f32["max_abs_err"].values()), "tol": f32["tol"], "ms": t_["kernel"],
            "plain_ms": t_["plain"], "bound_ms": bounds["bound_ms"], "bound_by": bounds["bound_by"],
            "library_ms": t_["library"], "bounds": bounds, "fp64": f32["fp64"], "sm90": b16,
            "timed_shape": f"{shape} ({source})"}


def t5_kernels(report: dict) -> list[dict]:
    """Kernels A and D at the T5 shapes, each with its own kernels-line entry
    (launches filled in from request (b)): A at the legacy model's mel (388
    mels, no log, 512 frames a window) through :func:`mel_case`; D's two
    paths at T5-base's fc1 (``QMM_TIMED_T5``), as ``check_qmm`` held them
    (every T5 shape of ``QMM_SHAPES``) and ``check_qmm`` / ``time_qmm_cold``
    timed them."""
    from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram

    mel = mel_case(MelSpectrogram("pallas", False, 16000, 1024, 388, 128, 0, 8000, "constant").cuda(), 1, 512)
    report["t5_mel_case"] = mel
    entries = [{"name": "fused_mel_t5", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/fused_mel.cu",
                "replaces": "mapperatorinator_tpu/ops/mel_kernel.py:72", "max_abs_err": mel["max_abs_err"],
                "max_abs_err_tf32x3": mel["max_abs_err_tf32x3"], "tol": MEL_TC_TOL, "ms": mel["ms"],
                "plain_ms": mel["plain_ms"], "bound_ms": mel["bound_ms"], "bound_by": mel["bound_by"],
                "library_ms": None, "device_ms": mel["device_ms"],
                "timed_shape": "N512 1024->513->388 fp32, no log (the legacy T5 model's mel)"}]
    fp32 = str(torch.float32)
    t5 = [c for c in report["qmm_cases"] if c["dtype"] == fp32 and (c["rows"], c["K"], c["N"]) in T5_QMM]
    for path, cases, what in (("qmm", report["qmm_cold_cases"], "a decode step's fc1, the GEMV path, cold L2"),
                              ("qmm_tc", report["qmm_cases"], "an encoder window's fc1, the tensor-core path")):
        rows, k, n = QMM_TIMED_T5[path]
        timed = next(c for c in cases if c["dtype"] == fp32 and (c["rows"], c["K"], c["N"]) == (rows, k, n))
        held = [c for c in t5 if c["path"] == path]
        entries.append({"name": f"{path}_t5_base", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
                        "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80",
                        "max_abs_err": max(c["max_abs_err"] for c in held),
                        "tol": f"{QMM_TOL[torch.float32]:g} x max(1, max |reference output|)",
                        "held_shapes": [[c["rows"], c["K"], c["N"]] for c in held], "ms": timed["ms"],
                        "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
                        "library_ms": timed["library_ms"], "device_ms": timed.get("device_ms"),
                        "timed_shape": f"rows{rows} K{k} N{n} fp32 ({what}; T5-base)"})
    return entries


def t5_phase(tmp: Path, report: dict) -> tuple[dict, list[dict]]:
    """The T5 v1.1 family (``t5_relpos``) at full width, T5-base (d_model
    768, 12 + 12 layers, 12 heads of d_kv 64, gated tanh-GELU ffn 2 048, no
    conv stem), from one set of seeded weights written as a published and
    as a legacy checkpoint (:func:`write_t5_checkpoints`), whose two loads
    must give equal parameters; on a ``T5_AUDIO_SECONDS`` song:

    * request (a): the published directory through ``load_model`` /
      ``generate`` at ``-cn v32`` (fp32, sampled, ``super_timing=false``),
      its first window's encoder states and one teacher-forced logits pass
      (B at sm_scale 1.0 in every decoder layer's cross attention) held
      against the plain path, the first cross call's q, k and v kept for
      :func:`unscaled_attention`;
    * MaiMod on request (a)'s .osu (or a dense map) with that checkpoint:
      its teacher-forced analysis is where T5's cross attention takes B (a
      decode reads the cross k/v from the cache through plain attention, in
      every family, as in the JAX package; T5's self-attention carries its
      position bias and runs plain), 12 launches a batch, held against the
      plain path;
    * request (b): the legacy directory through ``load_legacy_checkpoint``
      with the port's ``t5_base`` preset and the fused mel, served with
      int8 weights and KV (``inference.serving_engine``) at that config's
      windows, greedy: A and D; its first window's teacher-forced logits
      through D held against the plain version.

    Each must write a .osu that the port's parser reads. Returns the
    launches and the kernels-line entries of B, A and D at T5's shapes."""
    from mapperatorinator_tpu_torch import inference, mai_mod
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.models.io import load_checkpoint
    from mapperatorinator_tpu_torch.models.legacy import load_legacy_checkpoint

    started = time.perf_counter()
    wav = write_wav(tmp / "t5.wav", T5_AUDIO_SECONDS, seed=5)
    hf, legacy, train, record = write_t5_checkpoints(tmp / "t5", seed=5)
    t0 = time.perf_counter()
    from_hf, _ = load_checkpoint(hf)
    record["hf_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_legacy, _ = load_legacy_checkpoint(legacy, train)
    record["legacy_load_s"] = time.perf_counter() - t0
    a, b = from_hf.state_dict(), from_legacy.state_dict()
    equal = set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    print(f"T5: the published checkpoint loaded in {record['hf_load_s']:.2f} s, the legacy one in "
          f"{record['legacy_load_s']:.2f} s; {len(a)} parameters, all equal: {equal}")
    if not equal:
        raise AssertionError("the published and the legacy T5 checkpoints load to different parameters")
    del from_hf, from_legacy, a, b

    captured = {}

    def teacher_forced(engine, args, vocab, first) -> dict:
        enc = engine.encode_with_cond(window0(args))
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        with capture_first_flash(captured):  # B at sm_scale 1.0 in every decoder layer's cross attention
            check = check_teacher_forced("t5-a", engine, enc, seq)
        if "qkv" not in captured:
            raise AssertionError("request t5-a: the teacher-forced pass launched no kernel B")
        return {"teacher_forced_check": check}

    first = serve("t5-a-hf", tmp, wav, [f"model_path={hf}", "super_timing=false"], report, check_encoder=True,
                  after=teacher_forced, widths=T5_BASE)
    osu, source = maimod_map(tmp, report["requests"][-1]["osu_path"], "request t5-a", T5_AUDIO_SECONDS)
    args = load_config("v32", [f"model_path={hf}", "seed=0", f"audio_path={wav}", f"beatmap_path={osu}",
                               "gamemode=0", "do_sample=false"])
    maimod, report["t5_maimod"] = maimod_run("t5 MaiMod", mai_mod.select_config_for_gamemode(args), source,
                                             widths=T5_BASE)

    def legacy_engine(args):
        model, vocab = load_legacy_checkpoint(legacy, train)
        return inference.serving_engine(model, vocab, args, torch.device("cuda"))

    def qmm_logits(engine, args, vocab, first) -> dict:
        enc = engine.encode_with_cond(window0(args))
        return {"qmm_logits_check": check_qmm_logits("t5-b", engine, enc, first["tokens"][:1, :int(first["end"])])[0]}

    second = serve("t5-b-legacy-int8", tmp, wav, ["do_sample=false", "quantized_weights=true", "quantized_kv=true",
                                                  "super_timing=false", *T5_LEGACY_SERVE],
                   report, check_encoder=False, after=qmm_logits, widths=T5_BASE, load=legacy_engine)
    if maimod["flash_attention_fwd"] == 0 or second["fused_mel"] == 0 or second["qmm"] == 0 or second["qmm_tc"] == 0:
        raise AssertionError(f"the T5 phase launched {first}, {maimod} and {second}: B in MaiMod's analysis, A and "
                             "D's two paths in request (b)")
    entries = [unscaled_attention(*captured["qkv"], report), *t5_kernels(report)]
    launches = {"flash_attention_fwd_t5_cross": first["flash_attention_fwd"] + maimod["flash_attention_fwd"]
                + second["flash_attention_fwd"], "fused_mel_t5": second["fused_mel"],
                "qmm_t5_base": second["qmm"], "qmm_tc_t5_base": second["qmm_tc"]}
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
    record["phase_s"] = time.perf_counter() - started
    report["t5"] = record
    print(f"T5 phase: {record['phase_s']:.1f} s, launches {launches}")
    return {k: first.get(k, 0) + maimod.get(k, 0) + second.get(k, 0) for k in first}, entries


def write_family_checkpoint(directory: Path, family: str, seed: int) -> tuple[dict, dict]:
    """A published (HF-format) checkpoint of ``-cn v32``'s model with
    ``FAMILY_MODELS[family]``'s settings at full width, seeded random
    weights in the reference's layout, through :func:`write_safetensors`:
    NWhisper-base (``NWhisperForConditionalGeneration``: each projection a
    ``NormLinear`` at ``.linear.weight``, the slerps' ``branch_scale``,
    ``qk_scale``, ``alpha_positions`` and ``logit_scale`` drawn near their
    inits, the encoder's learned position rows) or moonshine-tiny (HF
    ``MoonshineForConditionalGeneration``: the raw-wave stem, bias-free
    attention and LayerNorms, the gated decoder fc1, a tied head). Returns
    (the state dict written, the record)."""
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.models.mapperatorinator import build_config
    from mapperatorinator_tpu_torch.osu import build_vocabulary

    t0 = time.perf_counter()
    args = load_config("v32", FAMILY_MODELS[family])
    vocab = build_vocabulary(args.train)
    cfg = build_config(args.train, vocab)
    b = cfg.backbone
    gen = torch.Generator(device="cuda").manual_seed(seed)
    d, sd, t = b.d_model, {}, "transformer.model"

    def rand(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std + mean).cpu()

    def linear(key, out, inp, bias=True, weight="weight"):
        sd[f"{key}.{weight}"] = rand(out, inp, std=inp**-0.5)
        if bias:
            sd[f"{key}.bias"] = rand(out, std=0.02)

    if family == "nwhisper":
        def scale(key, n, at):
            sd[f"{key}.scale"] = rand(n, std=0.1 * at, mean=at)

        for conv, inp in (("conv1", d), ("conv2", d)):  # the projected input is d_model wide
            sd[f"{t}.encoder.{conv}.weight"] = rand(d, inp, 3, std=(3 * inp) ** -0.5)
            sd[f"{t}.encoder.{conv}.bias"] = rand(d, std=0.02)
        sd[f"{t}.encoder.embed_positions.weight"] = rand(b.max_source_positions, d)
        sd[f"{t}.decoder.embed_positions.weight"] = rand(b.max_target_positions, d)
        sd[f"{t}.decoder.embed_tokens.embedding.weight"] = rand(cfg.vocab_size_in, d)
        for side, n, ffn in (("encoder", b.encoder_layers, b.encoder_ffn),
                             ("decoder", b.decoder_layers, b.decoder_ffn)):
            scale(f"{t}.{side}.alpha_positions", d, d**-0.5)
            for i in range(n):
                p = f"{t}.{side}.layers.{i}"
                for res in ("self_attn_with_residual", "encoder_attn_with_residual") if side == "decoder" \
                        else ("attn_with_residual",):
                    for proj in ("q", "k", "v", "out"):
                        linear(f"{p}.{res}.fn.{proj}_proj.linear", d, d, bias=proj != "k")  # k has no bias
                    scale(f"{p}.{res}.fn.qk_scale", d, 1 / d)
                    scale(f"{p}.{res}.branch_scale", d, d**-0.5)
                linear(f"{p}.ff_with_residual.fn.fc1.linear", ffn, d, bias=False)
                linear(f"{p}.ff_with_residual.fn.fc2.linear", d, ffn, bias=False)
                scale(f"{p}.ff_with_residual.branch_scale", d, d**-0.5)
        linear("transformer.proj_out.linear", cfg.vocab_size_out, d, bias=False)
        scale("transformer.logit_scale", cfg.vocab_size_out, d**-0.5)
        linear("encoder_embedder", d, cfg.n_mels + cfg.cond_size)
        backbone = {"d_model": d, "encoder_layers": b.encoder_layers, "decoder_layers": b.decoder_layers,
                    "encoder_attention_heads": b.encoder_heads, "decoder_attention_heads": b.decoder_heads,
                    "encoder_ffn_dim": b.encoder_ffn, "decoder_ffn_dim": b.decoder_ffn,
                    "max_source_positions": b.max_source_positions, "max_target_positions": b.max_target_positions,
                    "num_mel_bins": d, "tie_word_embeddings": False, "input_vocab_size": cfg.vocab_size_in}
        extra = {}
    else:
        def ln(key):
            sd[f"{key}.weight"] = rand(d, std=0.02, mean=1.0)

        sd[f"{t}.encoder.conv1.weight"] = rand(d, 1, 127, std=127**-0.5)
        sd[f"{t}.encoder.groupnorm.weight"], sd[f"{t}.encoder.groupnorm.bias"] = rand(d, std=0.02, mean=1.0), \
            rand(d, std=0.02)
        for conv, out, inp, k in (("conv2", 2 * d, d, 7), ("conv3", d, 2 * d, 3)):
            sd[f"{t}.encoder.{conv}.weight"] = rand(out, inp, k, std=(k * inp) ** -0.5)
            sd[f"{t}.encoder.{conv}.bias"] = rand(out, std=0.02)
        ln(f"{t}.encoder.layer_norm")
        ln(f"{t}.decoder.norm")
        sd[f"{t}.decoder.embed_tokens.weight"] = rand(cfg.vocab_size_out, d)
        for side, n in (("encoder", b.encoder_layers), ("decoder", b.decoder_layers)):
            for i in range(n):
                p = f"{t}.{side}.layers.{i}"
                for attn in ("self_attn", "encoder_attn") if side == "decoder" else ("self_attn",):
                    for proj in "qkvo":
                        linear(f"{p}.{attn}.{proj}_proj", d, d, bias=False)
                for name in ("input_layernorm", "post_attention_layernorm", "final_layernorm")[:3 if side == "decoder"
                                                                                              else 2]:
                    ln(f"{p}.{name}")
                linear(f"{p}.mlp.fc1", 2 * b.decoder_ffn if side == "decoder" else b.encoder_ffn, d)
                linear(f"{p}.mlp.fc2", d, b.decoder_ffn if side == "decoder" else b.encoder_ffn)
        backbone = {"hidden_size": d, "encoder_num_hidden_layers": b.encoder_layers,
                    "decoder_num_hidden_layers": b.decoder_layers, "encoder_num_attention_heads": b.encoder_heads,
                    "decoder_num_attention_heads": b.decoder_heads, "intermediate_size": b.encoder_ffn,
                    "max_position_embeddings": b.max_target_positions, "rope_theta": b.rope_global_theta,
                    "partial_rotary_factor": b.rope_partial_factor, "attention_bias": False,
                    "decoder_hidden_act": "silu", "tie_word_embeddings": True}
        extra = {"max_source_positions": b.max_source_positions}
    sd["decoder_embedder.weight"] = rand(cfg.vocab_size_in, d)
    hf_cfg = {"backbone_model_name": args.train.model.name, "vocab_size": cfg.vocab_size_out, "backbone_config": backbone,
              **extra, **{k: getattr(cfg, k) for k in (
                  "vocab_size_in", "num_classes", "num_mappers", "input_features", "input_raw_wave",
                  "project_encoder_input", "embed_decoder_input", "do_style_embed", "cond_dim", "cond_size",
                  "spectrogram_log_scale", "sample_rate", "n_fft", "n_mels", "hop_length", "f_min", "f_max",
                  "pad_mode", "rhythm_token_start", "rhythm_token_end", "max_target_positions")}}
    directory.mkdir(parents=True)
    (directory / "config.json").write_text(json.dumps(hf_cfg))
    vocab.save_pretrained(directory)
    write_safetensors(directory / "model.safetensors", sd)
    record = {"backbone": args.train.model.name, "tensors": len(sd), "parameters": sum(x.numel() for x in sd.values()),
              "bytes": (directory / "model.safetensors").stat().st_size, "write_s": time.perf_counter() - t0}
    print(f"{family}: seeded {args.train.model.name} weights ({record['parameters'] / 1e6:.1f} M parameters, "
          f"{len(sd)} tensors) written as a published checkpoint ({record['bytes'] / 2**20:.1f} MiB "
          f"model.safetensors) in {record['write_s']:.2f} s")
    return sd, record


def load_family_checkpoint(directory: Path, family: str, sd: dict, record: dict) -> None:
    """``load_checkpoint`` of the directory: its parameters must equal the
    converter's map of the state dict the script drew (the file's round
    trip and the loader's dispatch), and its backbone must be the family's."""
    from mapperatorinator_tpu_torch.models.convert import config_from_hf, convert_mapperatorinator_state_dict
    from mapperatorinator_tpu_torch.models.io import load_checkpoint

    t0 = time.perf_counter()
    model, _ = load_checkpoint(directory)
    record["load_s"] = time.perf_counter() - t0
    got = model.state_dict()
    _, cfg = config_from_hf(json.loads((directory / "config.json").read_text()))
    want = convert_mapperatorinator_state_dict({k: v.float() for k, v in sd.items()}, cfg, family)
    equal = set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in got)
    b = model.cfg.backbone
    print(f"{family}: the published checkpoint loaded in {record['load_s']:.2f} s; {len(got)} parameters, equal to "
          f"the converter's: {equal}; norm_scheme {b.norm_scheme}, stem {b.stem_type}, head dim {b.head_dim}")
    if not equal or (b.norm_scheme == "ngpt") != (family == "nwhisper") or \
            (b.stem_type == "moonshine") != (family == "moonshine"):
        raise AssertionError(f"{family}: the loaded checkpoint is not the one written: {sorted(set(got) ^ set(want))[:5]}")


def capture_first_flash(captured: dict):
    """A context in which the first ``flash_attention`` call's q, k and v are
    kept in ``captured["qkv"]``."""
    from mapperatorinator_tpu_torch.models import transformer

    @contextlib.contextmanager
    def ctx():
        flash = transformer.flash_attention

        def capture(q, k, v, *a, **kw):
            captured.setdefault("qkv", (q.clone(), k.clone(), v.clone()))
            return flash(q, k, v, *a, **kw)

        transformer.flash_attention = capture
        try:
            yield
        finally:
            transformer.flash_attention = flash

    return ctx()


def check_teacher_forced(label: str, engine, enc, seq) -> dict:
    """Teacher-forced logits of ``seq`` through kernel B against the plain
    attention path, within ENC_TOL times the largest |logit|."""
    with_kernel = engine.forward(enc, seq)
    set_flash(engine.model, False)
    plain = engine.forward(enc, seq)
    set_flash(engine.model, True)
    err, tol = float(np.abs(with_kernel - plain).max()), ENC_TOL * float(np.abs(plain).max())
    print(f"request {label}, window 0: teacher-forced logits {with_kernel.shape} through kernel B vs plain "
          f"attention: max_abs_err {err:.3e} (tol {tol:.3e} = {ENC_TOL:g} x the largest |logit|)")
    if not (np.isfinite(with_kernel).all() and err <= tol):
        raise AssertionError(f"request {label}: teacher-forced logits through B disagree: {err} above {tol}")
    return {"shape": list(with_kernel.shape), "max_abs_err": err, "tol": tol}


def ngpt_phase(tmp: Path, report: dict) -> tuple[dict, list[dict]]:
    """The nGPT family at full width: NWhisper-base (d_model 512, 6 + 6
    layers, 8 heads of 64, ffn 2 048, 1 024 source and 2 560 target
    positions) from a published ``model.safetensors`` the script writes
    (:func:`write_family_checkpoint`), whose load must equal the converter's
    map; on a ``FAMILY_AUDIO_SECONDS`` song under ``-cn v32``:

    * request (a): the v32 defaults (sampled) with ``super_timing=false``,
      fp32; its first window's encoder states through B held against the
      plain path, the first encoder self-attention's q, k and v (normalised,
      scaled by ``qk_scale``) kept, one teacher-forced logits pass (B at
      ``sm_scale`` 1.0 in every self and cross call) held against the plain
      path, and one graphed decode step profiled (``profile_decode``);
    * request (b): greedy with int8 weights and KV asked for: the model must
      hold no ``QDense`` (every nGPT projection is a ``NormDense``, as in the
      JAX package) and its KV cache must be int8.

    Then B at that encoder window (B 1, T = S = 1 024, H 8, D 64, sm_scale
    1.0, the model's own q, k, v) on both routes (:func:`unscaled_attention`).
    Returns the launches and B's kernels-line entry."""
    from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline, get_eos_token_ids
    from mapperatorinator_tpu_torch.models.transformer import QDense

    started = time.perf_counter()
    wav = write_wav(tmp / "ngpt.wav", FAMILY_AUDIO_SECONDS, seed=11)
    directory = tmp / "nwhisper-hf"
    sd, record = write_family_checkpoint(directory, "nwhisper", seed=11)
    load_family_checkpoint(directory, "nwhisper", sd, record)
    del sd
    captured = {}

    def checks_a(engine, args, vocab, first) -> dict:
        with capture_first_flash(captured):
            enc = engine.encode_with_cond(window0(args))
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        out = {"teacher_forced_check": check_teacher_forced("ngpt-a", engine, enc, seq)}
        out["decode_profile"] = profile_decode(engine, enc, first["ids"][:1], build_logits_pipeline(
            vocab, do_sample=False), get_eos_token_ids(vocab), int8=False, steps=16, modes=("graphs",))["graphs"]
        st = out["decode_profile"]
        print(f"request ngpt-a: a graphed greedy decode step {st['host_ms_per_step']:.3f} ms of host time over "
              f"{st['device_ms_per_step']:.3f} ms of device kernels (idle {st['idle_share']:.3f}), "
              f"{st['kernels_per_step']:.0f} kernels a step")
        return out

    def checks_b(engine, args, vocab, first) -> dict:
        n_qdense = sum(isinstance(m, QDense) for m in engine.model.modules())
        with torch.inference_mode():
            cache = engine.model.init_cache(1, 8, engine.encode_with_cond(window0(args)))
        print(f"request ngpt-b: {n_qdense} QDense modules with int8 weights asked; KV cache {cache[0]['self']['k'].dtype}")
        if n_qdense or cache[0]["self"]["k"].dtype != torch.int8:
            raise AssertionError(f"request ngpt-b: {n_qdense} QDense (want 0: nGPT has no QDense site), "
                                 f"KV {cache[0]['self']['k'].dtype}")
        return {"qdense": n_qdense}

    first = serve("ngpt-a", tmp, wav, [f"model_path={directory}", "super_timing=false"], report, check_encoder=True,
                  after=checks_a, widths=NWHISPER_BASE)
    second = serve("ngpt-b-int8", tmp, wav, [f"model_path={directory}", "super_timing=false", "do_sample=false",
                                              "quantized_weights=true", "quantized_kv=true"],
                   report, check_encoder=False, after=checks_b, widths=NWHISPER_BASE)
    if first["flash_attention_fwd"] == 0 or second["flash_attention_fwd"] == 0 or second["qmm"] or second["qmm_tc"]:
        raise AssertionError(f"the nGPT requests launched {first} and {second}: B in both, no D")
    entry = unscaled_attention(*captured["qkv"], report, key="ngpt_attention",
                               label="NWhisper-base encoder self-attention", name="flash_attention_fwd_ngpt",
                               source="NWhisper-base's encoder window, request (a)'s model")
    entry["launches"] = first["flash_attention_fwd"] + second["flash_attention_fwd"]
    record["phase_s"] = time.perf_counter() - started
    report["ngpt"] = record
    print(f"nGPT phase: {record['phase_s']:.1f} s, B launches {entry['launches']}")
    return {k: first.get(k, 0) + second.get(k, 0) for k in first}, [entry]


def padded_attention(report: dict) -> tuple[dict, dict]:
    """Kernels B and C at moonshine's head dims, which they take zero-padded
    (``flash_attention``: to 40 / 56 on the fp32 route, 64 on the sm90
    route), each result held on the unpadded inputs against the plain
    versions that round as its route does and the fp32 ones: B at an encoder
    window (B 1, T = S = 681, H 8) at D 36 and D 52, C at D 36 with a key
    mask and causal with a key mask, on both routes. The fp32 route is timed
    through ``flash_attention`` (the padding copies included), beside the
    kernel alone on inputs padded beforehand, the copies alone, the plain
    version and SDPA at the unpadded D, and the bound of three TF32 products
    on the real D; the sm90 route likewise beside its bound. Returns B's
    kernels-line entry (launches filled in by the caller) and C's rows."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain, attention_backward_plain_bf16_tc, attention_backward_plain_fp32_tc,
        attention_plain, attention_plain_bf16_tc, attention_plain_fp32_tc, attention_route, flash_attention,
        flash_attention_bwd, flash_attention_fwd, head_dim_width, pad_head_dim)

    gen = torch.Generator(device="cuda").manual_seed(36)
    B, T, H = 1, MOONSHINE_WINDOW, 8
    faithful = {torch.float32: (attention_plain_fp32_tc, attention_backward_plain_fp32_tc),
                torch.bfloat16: (attention_plain_bf16_tc, attention_backward_plain_bf16_tc)}
    fwd_rows, bwd_rows = [], []
    for D in MOONSHINE_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            route = attention_route(dtype, D)
            width = head_dim_width(route, D)
            q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype) for _ in range(3))
            out = flash_attention(q, k, v)
            err, tol = {}, {}
            for name, ref in (("tc", faithful[dtype][0]), ("fp32", attention_plain)):
                want = ref(q, k, v).float()
                err[name] = (out.float() - want).abs().max().item()
                tol[name] = ATTN_TOL[dtype] * max(1.0, want.abs().max().item())
            qp, kp, vp = (pad_head_dim(x, width) for x in (q, k, v))
            qs, ks, vs = sdpa_layout(q, k, v)
            t_ = in_turns({"plain": lambda: faithful[dtype][0](q, k, v) if dtype == torch.bfloat16
                           else attention_plain(q, k, v),
                           "kernel": lambda: flash_attention(q, k, v),
                           "kernel_prepadded": lambda: flash_attention_fwd(qp, kp, vp, None, False, 0, D**-0.5),
                           "padding": lambda: [pad_head_dim(x, width) for x in (q, k, v)],
                           "library": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)})
            flops, nbytes = 4.0 * B * H * T * T * D, q.element_size() * 4 * B * T * H * D  # q, k, v in; out
            bounds = fp32_bounds(flops, nbytes) if dtype == torch.float32 else dict(zip(
                ("bound_ms", "bound_by"), bound(flops, nbytes, dtype)))
            row = {"shape": f"B{B} T{T} S{T} H{H} D{D} {str(dtype).split('.')[-1]}", "route": route, "width": width,
                   "max_abs_err": err, "tol": tol, "ms": t_["kernel"], "kernel_prepadded_ms": t_["kernel_prepadded"],
                   "padding_ms": t_["padding"], "plain_ms": t_["plain"], "library_ms": t_["library"], **bounds}
            fwd_rows.append(row)
            print(f"flash_attention_fwd {route} moonshine {row['shape']} (padded to D {width}): max_abs_err "
                  f"{err['tc']:.3e} against the plain version that rounds as the route does, {err['fp32']:.3e} "
                  f"against the fp32 one (tol {tol['tc']:.3e}); flash_attention {row['ms']:.4f} ms (the kernel on "
                  f"inputs padded beforehand {row['kernel_prepadded_ms']:.4f} ms, the three padding copies "
                  f"{row['padding_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, scaled_dot_product_attention "
                  f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
            if not all(err[n] <= tol[n] for n in err):
                raise AssertionError(f"kernel B at D {D} ({route}, padded to {width}) disagrees: {err} above {tol}")
            del q, k, v, qp, kp, vp, qs, ks, vs, out

    D = MOONSHINE_HEAD_DIMS[0]
    for dtype in (torch.float32, torch.bfloat16):
        route = attention_route(dtype, D)
        width = head_dim_width(route, D)
        for label, causal in (("key mask", False), ("causal + key mask", True)):
            q, k, v, do = (torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype) for _ in range(4))
            lengths = torch.randint(int(0.75 * T), T + 1, (B, 1), generator=gen, device="cuda")
            mask = torch.arange(T, device="cuda")[None] < lengths
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            grads = torch.autograd.grad(flash_attention(*leaves, mask, causal=causal), leaves, do)
            err, tol = {}, {}
            for name, ref in (("tc", faithful[dtype][1]), ("fp32", attention_backward_plain)):
                want = ref(q, k, v, mask, do, causal=causal)
                err[name] = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want))
                tol[name] = ATTN_TOL[dtype] * max(1.0, max(w.float().abs().max().item() for w in want))
            row = {"shape": f"B{B} T{T} S{T} H{H} D{D} {str(dtype).split('.')[-1]} {label}", "route": route,
                   "width": width, "max_abs_err": err, "tol": tol}
            if not causal:  # timed: the backward alone, dO's padding copy included
                qp, kp, vp = (pad_head_dim(x, width) for x in (q, k, v))
                out, lse = flash_attention_fwd(qp, kp, vp, mask, False, 0, D**-0.5, with_lse=True)
                qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
                sdpa_mask = mask[:, None, None, :]
                sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)
                do_s = do.transpose(1, 2).contiguous()
                t_ = in_turns({
                    "plain": lambda: faithful[dtype][1](q, k, v, mask, do) if dtype == torch.bfloat16
                    else attention_backward_plain(q, k, v, mask, do),
                    "kernel": lambda: [g[..., :D] for g in flash_attention_bwd(
                        qp, kp, vp, mask, out, lse, pad_head_dim(do, width), False, 0, D**-0.5)],
                    "library": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True)})
                el = B * T * H * D
                pairs = H * attended_pairs(B, T, T, False, mask)
                flops, nbytes = 10.0 * pairs * D, q.element_size() * 8 * el + 4 * B * H * T  # q, k, v, O, dO in; 3 out
                bounds = fp32_bounds(flops, nbytes) if dtype == torch.float32 else dict(zip(
                    ("bound_ms", "bound_by"), bound(flops, nbytes, dtype)))
                row.update({"ms": t_["kernel"], "plain_ms": t_["plain"], "library_ms": t_["library"], **bounds})
                del qp, kp, vp, out, lse, qs, ks, vs, sdpa_out
            bwd_rows.append(row)
            timing = (f"; flash_attention_bwd {row['ms']:.4f} ms (dO padded in the call), plain {row['plain_ms']:.4f} "
                      f"ms, SDPA's backward {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']})") if "ms" in row else ""
            print(f"flash_attention_bwd {route} moonshine {row['shape']} (padded to D {width}): max_abs_err "
                  f"{err['tc']:.3e} / {err['fp32']:.3e} (tol {tol['tc']:.3e} / {tol['fp32']:.3e}){timing}")
            if not all(err[n] <= tol[n] for n in err):
                raise AssertionError(f"kernel C at D {D} ({route}, padded to {width}) disagrees: {err} above {tol}")
            del q, k, v, do, grads, leaves
    torch.cuda.empty_cache()
    report["moonshine_attention"] = {"fwd": fwd_rows, "bwd": bwd_rows}
    timed = fwd_rows[0]
    entry = {"name": "flash_attention_fwd_moonshine", "route": "cuda",
             "source": "mapperatorinator_tpu_torch/csrc/flash_attention.cu",
             "replaces": "mapperatorinator_tpu/ops/attention_kernel.py:88",
             "max_abs_err": max(e for r in fwd_rows if r["route"] == "fp32" for e in r["max_abs_err"].values()),
             "tol": "2e-5 x max(1, max |reference output|)", "ms": timed["ms"], "plain_ms": timed["plain_ms"],
             "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"], "library_ms": timed["library_ms"],
             "timed_shape": f"{timed['shape']} (moonshine-tiny's encoder window, zero-padded to D {timed['width']} "
                            "in the timed call)", "shapes": fwd_rows}
    return entry, bwd_rows


def moonshine_phase(tmp: Path, report: dict) -> tuple[dict, list[dict], list[dict]]:
    """The moonshine family at full width: moonshine-tiny (d_model 288, 6 + 6
    layers, 8 heads of 36, ffn 1 152, a tied head; a v32 window's 262 144
    samples -> 681 encoder positions) from a published ``model.safetensors``
    the script writes, whose load must equal the converter's map; on a
    ``FAMILY_AUDIO_SECONDS`` song under ``-cn v32``:

    * request (a): greedy, fp32, ``super_timing=false``: B padded at D 36 in
      every encoder self and cross call; its first window's encoder states
      through B held against the plain path;
    * request (b): greedy with int8 weights and KV: D's tensor-core path at
      the encoder's fc1 (681 rows, K 288, N 1 152; the other moonshine
      shapes miss the qmm gate, as in the JAX package), its first window
      encoded and teacher-forced through D held against ``qmm_plain``.

    Then B and C at the head dims (:func:`padded_attention`). Returns the
    launches, B's kernels-line entry and C's rows."""
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm

    started = time.perf_counter()
    wav = write_wav(tmp / "moonshine.wav", FAMILY_AUDIO_SECONDS, seed=12)
    directory = tmp / "moonshine-hf"
    sd, record = write_family_checkpoint(directory, "moonshine", seed=12)
    load_family_checkpoint(directory, "moonshine", sd, record)
    del sd

    def checks_b(engine, args, vocab, first) -> dict:
        frames = window0(args)
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        before = qmm.launches_tc
        with_kernel = engine.forward(engine.encode_with_cond(frames), seq)
        launched = qmm.launches_tc - before
        set_qmm(engine.model, False)
        plain = engine.forward(engine.encode_with_cond(frames), seq)
        set_qmm(engine.model, True)
        err, tol = float(np.abs(with_kernel - plain).max()), ENC_TOL * float(np.abs(plain).max())
        print(f"request moonshine-b, window 0: encoded and teacher-forced through kernel D ({launched} tensor-core "
              f"launches, the encoder's fc1) vs qmm_plain: logits {with_kernel.shape} max_abs_err {err:.3e} (tol "
              f"{tol:.3e})")
        if launched != engine.model.cfg.backbone.encoder_layers or not (np.isfinite(with_kernel).all() and err <= tol):
            raise AssertionError(f"request moonshine-b: D at the encoder's fc1 launched {launched} times, or its "
                                 f"logits disagree with qmm_plain: {err} above {tol}")
        return {"qmm_logits_check": {"shape": list(with_kernel.shape), "max_abs_err": err, "tol": tol,
                                     "tc_launches": launched}}

    first = serve("moonshine-a", tmp, wav, [f"model_path={directory}", "super_timing=false", "do_sample=false"],
                  report, check_encoder=True, widths=MOONSHINE_TINY)
    second = serve("moonshine-b-int8", tmp, wav, [f"model_path={directory}", "super_timing=false", "do_sample=false",
                                                  "quantized_weights=true", "quantized_kv=true"],
                   report, check_encoder=False, after=checks_b, widths=MOONSHINE_TINY)
    if first["flash_attention_fwd"] == 0 or second["flash_attention_fwd"] == 0 or second["qmm_tc"] == 0:
        raise AssertionError(f"the moonshine requests launched {first} and {second}: B in both, D's tensor cores in "
                             "request (b)'s")
    entry, bwd_rows = padded_attention(report)
    entry["launches"] = first["flash_attention_fwd"] + second["flash_attention_fwd"]
    record["phase_s"] = time.perf_counter() - started
    report["moonshine"] = record
    print(f"moonshine phase: {record['phase_s']:.1f} s, B launches {entry['launches']}, D (tensor cores) "
          f"{second['qmm_tc']}")
    return {k: first.get(k, 0) + second.get(k, 0) for k in first}, [entry], bwd_rows


# the evaluation phase: the mapper classifier of configs/classifier/train_v1.yaml (whisper-base: d 512, 6 + 6
# layers, 8 heads, ffn 2 048, 1 024 frames and 1 024 tokens, 388 mels, projection 256, the mapper classes of
# datasets/beatmap_users.json), CM3P at Cm3pConfig()'s widths (d 512, 6 layers a tower, 1 024 frames, 512
# tokens, projection 512) and OsuR at configs/rcomplexion/train_v1.yaml, each from seeded random weights.
# classifier_test and rcomplexion_inference read EVAL_TRACKS of write_ors's tracks (4 maps of 60 s each)
EVAL_TRACKS = 2
EVAL_BATCH, CM3P_BATCH = 32, 16
# the auxiliary trainers (diffusion_train, classifier_train, rcomplexion_train), each through its entry point
# on train_phase's synthesized set (ORS_TRACKS tracks of ORS_MAPS maps, an object every 50 ms): DiT-B at
# configs/diffusion/v1.yaml's batch 256; the classifier at configs/classifier/train_v1.yaml's widths and grad_acc
# 2 and its micro-batch of 128 rows (fp32 activations of 1 024 frames and 1 024 tokens a row take about 0.6 GiB);
# OsuR at
# configs/rcomplexion/train_v1.yaml's batch 1 024. The step counts are cut, warmup_steps to 1, one eval batch
# each; printed with the phase
AUX_DIT_STEPS = 3
AUX_CLF_BATCH, AUX_CLF_MICRO_STEPS = 128, 4
AUX_OSUR_STEPS = 3
AUX_DIT_CHECK_BATCH, AUX_CLF_CHECK_BATCH = 32, 4  # the gradient checks' batches (plain attention's memory)
DIT_CALLS, CLF_CALLS = 12, 18  # attention calls a forward: DiT-B's blocks; the classifier's 6 + 6 + 6
# kernels B and C at the auxiliary trainers' calls (fp32, D 64): (label, B, T, S, H, causal + key mask)
AUX_ATTENTION = [("DiT-B training self-attention", 256, 128, 128, 12, False),
                 ("classifier training encoder and cross", AUX_CLF_BATCH, 1024, 1024, 8, False),
                 ("classifier training decoder self", AUX_CLF_BATCH, 1024, 1024, 8, True)]
# kernel B at the evaluation models' calls (fp32, H 8, D 64): (label, B, T, S, causal, key mask)
EVAL_ATTENTION = [("classifier encoder and cross", EVAL_BATCH, 1024, 1024, False, False),
                  ("classifier decoder self", EVAL_BATCH, 1024, 1024, True, True),
                  ("CM3P beatmap tower", CM3P_BATCH, 512, 512, False, True)]


def eval_attention(report: dict, cases=EVAL_ATTENTION, H: int = 8, key: str = "attention_eval",
                   seed: int = 19) -> list[dict]:
    """Kernel B at the classifier's and CM3P's calls (``EVAL_ATTENTION``; or
    ``cases`` at ``H`` heads, the rows kept under ``report[key]``), against
    both fp32 plain versions at 2e-5, timed beside the plain version, SDPA
    and the bound. Each key mask pads each row's end, and its batch row 0 is
    a window of pads only: every query row there sees no key and must
    average v over all S keys, as the JAX ``_attend`` does."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import attention_plain, attention_plain_fp32_tc, \
        flash_fwd_fp32

    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, tol = 64, ATTN_TOL[torch.float32]
    scale = D**-0.5
    rows = []
    for label, B, T, S, causal, masked in cases:
        q = torch.randn((B, T, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda") for _ in range(2))
        mask = sdpa_mask = None
        if masked:
            lengths = torch.randint(S // 4, S + 1, (B, 1), generator=gen, device="cuda")
            mask = torch.arange(S, device="cuda")[None] < lengths
            mask[0] = False
            sdpa_mask = mask[:, None, None, :]
            if causal:
                sdpa_mask = sdpa_mask & torch.ones((T, S), dtype=torch.bool, device="cuda").tril()
        out = flash_fwd_fp32(q, k, v, mask, causal, 0, scale, False)[0]
        err = {"tc": (out - attention_plain_fp32_tc(q, k, v, mask, causal=causal)).abs().max().item(),
               "fp32": (out - attention_plain(q, k, v, mask, causal=causal)).abs().max().item()}
        if masked:
            err["empty window"] = (out[0] - v[0].mean(0, keepdim=True)).abs().max().item()
        qs, ks, vs = sdpa_layout(q, k, v)
        times = in_turns({"plain": lambda: attention_plain(q, k, v, mask, causal=causal),
                          "kernel": lambda: flash_fwd_fp32(q, k, v, mask, causal, 0, scale, False),
                          "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                              qs, ks, vs, attn_mask=sdpa_mask)})
        pairs = H * attended_pairs(B, T, S, causal, mask)
        bounds = fp32_bounds(4.0 * pairs * D, 4 * 2 * B * H * D * (T + S))  # q, out; k, v
        row = {"label": label, "shape": f"B{B} T{T} S{S} H{H} D{D} fp32" + (" causal" if causal else "")
               + (" key mask, row 0 all pads" if masked else ""), "ms": times["kernel"], "plain_ms": times["plain"],
               "library_ms": times["library"], **bounds, "pairs_share": pairs / (B * H * T * S),
               "max_abs_err": err, "tol": tol}
        rows.append(row)
        print(f"flash_attention_fwd fp32 {label} {row['shape']}: max_abs_err {err['tc']:.3e} against the plain "
              f"version that splits as the kernel does, {err['fp32']:.3e} against the fp32 one"
              + (f", {err['empty window']:.3e} from v's mean in the window of pads" if masked else "")
              + f" (tol {tol:g}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}x); "
              f"bound {row['bound_ms']:.4f} ms (three TF32 products {row['tf32x3_ms']:.4f}, fp32 FMAs "
              f"{row['fma_ms']:.4f}, bytes {row['bytes_ms']:.4f}); the masks leave {row['pairs_share']:.4f} of T x S")
        if not all(e <= tol for e in err.values()):
            raise AssertionError(f"flash_attention fp32 {label}: {err} above {tol}")
        del q, k, v, out, qs, ks, vs, sdpa_mask
    torch.cuda.empty_cache()
    report[key] = rows
    return rows


def cm3p_torch_state_dict(model) -> dict:
    """A CM3P's weights in the torch dual-tower layout ``load_cm3p`` converts
    (``pytorch_model.bin``): the fused ``wqkv`` split into q / k / v
    projections (k without a bias, whose fused slot must be 0), the norms
    and feed-forwards under the whisper names."""
    state = {name: t.detach().cpu() for name, t in model.state_dict().items()}
    sd = {name: state[name] for name in ("beatmap_embedder.weight", "audio_embedder.weight", "audio_embedder.bias",
                                         "beatmap_projection.weight", "audio_projection.weight", "logit_scale")}
    for tower, backbone in (("beatmap_encoder", model.cfg.beatmap_backbone),
                            ("audio_encoder", model.cfg.audio_backbone)):
        norms = [("layer_norm", "norm")]
        for i in range(backbone.encoder_layers):
            p = f"{tower}.layers.{i}"
            q, k, v = state[f"{p}.self_attn.wqkv.weight"].chunk(3)
            qb, kb, vb = state[f"{p}.self_attn.wqkv.bias"].chunk(3)
            if kb.any():
                raise AssertionError(f"{p}: a k bias the torch layout cannot hold")
            sd.update({f"{p}.self_attn.q_proj.weight": q, f"{p}.self_attn.q_proj.bias": qb,
                       f"{p}.self_attn.k_proj.weight": k, f"{p}.self_attn.v_proj.weight": v,
                       f"{p}.self_attn.v_proj.bias": vb,
                       f"{p}.self_attn.out_proj.weight": state[f"{p}.self_attn.wo.weight"],
                       f"{p}.self_attn.out_proj.bias": state[f"{p}.self_attn.wo.bias"]})
            for fc in ("fc1", "fc2"):
                for leaf in ("weight", "bias"):
                    sd[f"{p}.{fc}.{leaf}"] = state[f"{p}.ffn.{fc}.{leaf}"]
            norms += [(f"layers.{i}.self_attn_layer_norm", f"layers.{i}.self_attn_norm"),
                      (f"layers.{i}.final_layer_norm", f"layers.{i}.final_norm")]
        for theirs, ours in norms:
            for leaf in ("weight", "bias"):
                if f"{tower}.{ours}.{leaf}" in state:
                    sd[f"{tower}.{theirs}.{leaf}"] = state[f"{tower}.{ours}.{leaf}"]
    return sd


def eval_bundles(tmp: Path, mappers: Path) -> tuple[dict, dict]:
    """The classifier bundle (``save_classifier_bundle``), CM3P written
    native (``save_cm3p``) and as ``pytorch_model.bin`` beside its config,
    and OsuR's ``params.msgpack``, all at full width from seeded random
    weights; CM3P's two loads must be equal. Returns the paths and the
    record."""
    from mapperatorinator_tpu_torch.config import load_classifier_config, load_config, load_rcomplexion_config
    from mapperatorinator_tpu_torch.models.classifier import (OsuR, OsuRConfig, build_classifier,
                                                              save_classifier_bundle)
    from mapperatorinator_tpu_torch.models.cm3p import Cm3p, Cm3pConfig, load_cm3p, save_cm3p
    from mapperatorinator_tpu_torch.models.io import save_params
    from mapperatorinator_tpu_torch.models.params import init_params
    from mapperatorinator_tpu_torch.osu import build_vocabulary
    from mapperatorinator_tpu_torch.rcomplexion import RTokenizer

    t0 = time.perf_counter()
    args = load_classifier_config("train_v1", [f"data.mappers_path={mappers}"])
    vocab = build_vocabulary(args)
    classifier = build_classifier(args, vocab)
    check_full_width(classifier, WHISPER_BASE)
    init_params(classifier, 19)
    paths = {"classifier": save_classifier_bundle(tmp / "classifier", classifier, args, vocab)}

    # Cm3pConfig()'s widths, its token table as wide as the vocabulary the bundle carries: v32's, whose event
    # types are those the feature extractor's parser emits at the JAX DataConfig() defaults (the classifier's
    # splits positions into POS_X / POS_Y, which that parser does not)
    cm3p_vocab = build_vocabulary(load_config("v32").train)
    cm3p = Cm3p(dataclasses.replace(Cm3pConfig(), vocab_size=max(Cm3pConfig().vocab_size, cm3p_vocab.vocab_size_in)))
    init_params(cm3p, 20)
    paths["cm3p"] = save_cm3p(tmp / "cm3p", cm3p, cm3p_vocab)
    paths["cm3p_bin"] = tmp / "cm3p_bin"
    paths["cm3p_bin"].mkdir()
    (paths["cm3p_bin"] / "cm3p_config.json").write_text((paths["cm3p"] / "cm3p_config.json").read_text())
    torch.save(cm3p_torch_state_dict(cm3p), paths["cm3p_bin"] / "pytorch_model.bin")
    native, from_bin = load_cm3p(paths["cm3p"])[0].state_dict(), load_cm3p(paths["cm3p_bin"])[0].state_dict()
    unequal = [name for name in native if not torch.equal(native[name], from_bin[name])]
    if set(native) != set(from_bin) or unequal:
        raise AssertionError(f"CM3P: the native and pytorch_model.bin loads differ at {unequal[:5]}")

    rc_args = load_rcomplexion_config("inference_v1")
    tokenizer = RTokenizer(rc_args)
    osur = OsuR(OsuRConfig(vocab_size_in=tokenizer.vocab_size_in, vocab_size_out=tokenizer.vocab_size_out,
                           src_seq_len=rc_args.data.src_seq_len, hidden_size=rc_args.model.hidden_size))
    init_params(osur, 21)
    paths["osur"] = tmp / "osur"
    paths["osur"].mkdir()
    save_params(paths["osur"] / "params.msgpack", osur)
    count = {name: sum(p.numel() for p in m.parameters()) for name, m in
             (("classifier", classifier), ("cm3p", cm3p), ("osur", osur))}
    record = {"parameters": count, "mapper_classes": vocab.num_mapper_classes,
              "cm3p_loads_equal": len(native), "bundles_s": time.perf_counter() - t0}
    print(f"eval bundles: classifier {count['classifier'] / 1e6:.1f} M parameters ({vocab.num_mapper_classes} "
          f"mapper classes), CM3P {count['cm3p'] / 1e6:.1f} M (native and pytorch_model.bin loads equal in all "
          f"{len(native)} tensors), OsuR {count['osur'] / 1e6:.2f} M; written in {record['bundles_s']:.1f} s")
    return paths, record


def counted(label: str, fn, record: dict):
    """``fn()`` with the attention counters set to 0 before and read after;
    its result, wall time and launches go to ``record[label]``."""
    reset_attention_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    record[label] = {"wall_s": time.perf_counter() - t0, "launches": attention_launches()}
    return out


def eval_generation(tmp: Path, report: dict) -> tuple[Path, str]:
    """(the map ``calc_fid`` takes as request 1's generation, what it is):
    request 2's .osu, or where random weights wrote one with no timing point
    or hit object (the classifier's parser asserts a timing point, as the
    JAX one does) or the same hit objects as request 1's (a comparison of a
    map with itself gives FID 0) the next request's on the same song (3,
    then super-timing's), else a dense map (``maimod_map``)."""
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap

    def objects(path) -> str:
        return Path(path).read_text().partition("[HitObjects]")[2].strip()

    real = objects(report["requests"][0]["osu_path"])
    same_song = [r for r in report["requests"][1:] if r["label"][0].isdigit()]
    for request in same_song:
        written = Beatmap.from_path(request["osu_path"])
        if written.timing_points and written.hit_objects() and objects(request["osu_path"]) != real:
            return Path(request["osu_path"]), f"request {request['label']}'s .osu"
    osu, source = maimod_map(tmp, report["requests"][1]["osu_path"], "request 2", AUDIO_SECONDS)
    return Path(osu), source


def mapper_table(path: Path, ors: Path) -> Path:
    """``datasets/beatmap_users.json`` with the maps of ``ors`` added under
    users it already holds, in turn, so that the classifier's classes are
    the table's and every synthesized map has a mapper."""
    table = json.loads((REPO / "datasets" / "beatmap_users.json").read_text())
    users = sorted(set(table.values()))
    bids = [int(json.loads((t / "metadata.json").read_text())["Beatmaps"][m]["BeatmapId"])
            for t in sorted(ors.glob("Track*")) for m in json.loads((t / "metadata.json").read_text())["Beatmaps"]]
    path.write_text(json.dumps({**table, **{str(bid): users[i % len(users)] for i, bid in enumerate(bids)}}))
    return path


def eval_phase(tmp: Path, wav: Path, report: dict) -> tuple[dict, list[dict]]:
    """The evaluation tools at full width (``eval_bundles``), each through
    its entry point on the card:

    * (a) ``classifier_classify`` on request 1's .osu and the song: the top
      100 mappers, each confidence finite;
    * (b) ``calc_fid`` with ``skip_generation=true``, every metric on (fid
      with the classifier at batch 32, ``fid_cm3p`` at batch 16, the rhythm
      and extra stats) over an ORS folder of request 1's map as the real one
      and request 2's as its generation (``eval_generation``: another
      request's where request 2's has no timing point or request 1's hit
      objects), on the same song: every number finite;
    * (c) ``classifier_test`` on ``EVAL_TRACKS`` of ``write_ors``'s tracks at
      batch 32, and (d) ``rcomplexion_inference`` (in a directory of its own:
      it writes ``rhythm_complexities.csv`` where it runs) and
      ``rcomplexion_test`` on them.

    The mapper table is ``datasets/beatmap_users.json`` with the synthesized
    maps' ids added under users it already holds, so the classes are the
    table's. Kernel B must launch in (a), (b) and (c) and nothing else of
    B or C; then B at the models' calls (``eval_attention``). Returns the
    launches and B's rows."""
    from mapperatorinator_tpu_torch import calc_fid, classifier_classify, classifier_test, rcomplexion_inference, \
        rcomplexion_test

    started = time.perf_counter()
    ors = write_ors(tmp / "eval_tracks", tracks=EVAL_TRACKS)
    mappers = mapper_table(tmp / "mappers.json", ors)
    paths, record = eval_bundles(tmp, mappers)

    real = Path(report["requests"][0]["osu_path"])
    generated, generated_source = eval_generation(tmp, report)
    record["generated"] = generated_source
    fid_set = tmp / "eval_fid"
    (fid_set / "Track00000" / "beatmaps").mkdir(parents=True)
    (fid_set / "generated" / "Track00000_real").mkdir(parents=True)
    (fid_set / "Track00000" / "beatmaps" / "real.osu").write_text(real.read_text())
    (fid_set / "Track00000" / "audio.wav").write_bytes(wav.read_bytes())
    (fid_set / "generated" / "Track00000_real" / "generated.osu").write_text(generated.read_text())

    clf = [f"model_path={paths['classifier']}", f"data.mappers_path={mappers}"]
    top = counted("classify", lambda: classifier_classify.main(
        ["-cn", "train_v1", *clf, f"beatmap_path={real}", f"audio_path={wav}", "time=0"]), record)
    fid = counted("calc_fid", lambda: calc_fid.main(
        [f"dataset_path={fid_set}", "dataset_start=0", "dataset_end=1", "gamemodes=[0]", "skip_generation=true",
         f"classifier_ckpt={paths['classifier']}", f"classifier_batch_size={EVAL_BATCH}", "fid=true",
         "fid_cm3p=true", f"cm3p_ckpt={paths['cm3p']}", f"cm3p_batch_size={CM3P_BATCH}", "rhythm_stats=true",
         "extra_stats=true"]), record)
    tracks = [f"data.test_dataset_path={ors}", "data.test_dataset_start=0", f"data.test_dataset_end={EVAL_TRACKS}"]
    tested = counted("classifier_test", lambda: classifier_test.main(
        ["-cn", "train_v1", *clf, *tracks, f"optim.batch_size={EVAL_BATCH}"]), record)
    rc = [f"model_path={paths['osur']}", f"data.train_dataset_path={ors}", "data.train_dataset_start=0",
          f"data.train_dataset_end={EVAL_TRACKS}"]
    (tmp / "rcomplexion").mkdir()
    with contextlib.chdir(tmp / "rcomplexion"):
        complexities = counted("rcomplexion_inference", lambda: rcomplexion_inference.main(
            ["-cn", "inference_v1", *rc]), record)
        grid = counted("rcomplexion_test", lambda: rcomplexion_test.main(
            ["-cn", "inference_v1", *rc, "-o", str(tmp / "rcomplexion" / "grid.png")]), record)

    numbers = [c for *_, c in top] + list(fid.values()) + list(tested.values()) + list(complexities.values())
    wanted = {"fid", "ssm_rmse", "fid_cm3p", "ssm_rmse_cm3p", "active_rhythm_f1", "drain_mse", "bpm_mse", "sr_mse"}
    complete = (len(top) == 100 and wanted <= set(fid) and len(tested) == 4
                and len(complexities) == ORS_MAPS * EVAL_TRACKS)
    if not (complete and np.isfinite(numbers).all() and np.isfinite(grid).all()):
        raise AssertionError(f"the evaluation outputs are incomplete or not finite: {len(top)} mappers, {fid}, "
                             f"{tested}, {complexities}")
    launches = {name: sum(r["launches"][name] for r in record.values() if isinstance(r, dict) and "launches" in r)
                for name in attention_launches()}
    by_step = {label: record[label]["launches"]["flash_attention_fwd"] for label in
               ("classify", "calc_fid", "classifier_test", "rcomplexion_inference", "rcomplexion_test")}
    if not (by_step["classify"] and by_step["calc_fid"] and by_step["classifier_test"]) \
            or by_step["rcomplexion_inference"] or by_step["rcomplexion_test"] \
            or launches["flash_attention_fwd"] != sum(launches.values()):
        raise AssertionError(f"the evaluation phase launched {launches} ({by_step}): B in (a)-(c), nothing else")
    record.update({"top": top[:5], "fid": fid, "test": tested, "rhythm_complexities": complexities,
                   "entropy_bits": float(grid.sum(axis=1).mean())})
    print(f"eval (a) classify: top mapper {top[0][1]} at {top[0][2]:.4f}, {record['classify']['wall_s']:.2f} s; "
          f"(b) calc_fid on {generated_source} as the generation, {record['calc_fid']['wall_s']:.2f} s: " + ", ".join(f"{k} {v:.6g}" for k, v in fid.items()
                                                                                if not isinstance(v, dict))
          + f"; (c) classifier_test {record['classifier_test']['wall_s']:.2f} s: "
          + ", ".join(f"{k} {v:.4f}" for k, v in tested.items())
          + f"; (d) rcomplexion_inference {record['rcomplexion_inference']['wall_s']:.2f} s, "
          f"{len(complexities)} maps, rcomplexion_test {record['rcomplexion_test']['wall_s']:.2f} s; B launches "
          f"{by_step}")
    rows = eval_attention(report)
    record["phase_s"] = time.perf_counter() - started
    report["eval"] = record
    print(f"eval phase: {record['phase_s']:.1f} s, B launches {launches['flash_attention_fwd']}")
    return launches, rows


def dense_dit_map(path: Path) -> Path:
    """``DIT_OBJECTS`` hit objects 150 ms apart at random positions:
    circles, and every ``DIT_SLIDER_EVERY``-th a slider (Bezier, perfect,
    linear, Catmull in turn) under a greenline of its own SV."""
    rng = np.random.default_rng(2)
    objects, greens = [], []
    for i in range(DIT_OBJECTS):
        x, y, time_ms = int(rng.integers(32, 480)), int(rng.integers(32, 352)), 500 + 150 * i
        if i % DIT_SLIDER_EVERY:
            objects.append(f"{x},{y},{time_ms},{5 if i % 8 == 0 else 1},0,0:0:0:0:")
            continue
        kind = "BPLC"[(i // DIT_SLIDER_EVERY) % 4]
        points = "|".join(f"{int(np.clip(x + rng.integers(-60, 60), 0, 512))}:"
                          f"{int(np.clip(y + rng.integers(-60, 60), 0, 384))}"
                          for _ in range({"B": 3, "P": 2, "L": 1, "C": 3}[kind]))
        greens.append(f"{time_ms},{-100 / float(rng.choice([0.75, 1.0, 1.5])):.4f},4,2,0,60,0,0")
        objects.append(f"{x},{y},{time_ms},6,0,{kind}|{points},1,{int(rng.integers(40, 90))}")
    text = OSU_TEMPLATE.format(i=0, bid=1, objects="\n".join(objects))
    path.write_text(text.replace("500,500,4,2,0,70,1,0\n", "500,500,4,2,0,70,1,0\n" + "\n".join(greens) + "\n"))
    return path


def dit_attention(report: dict, bucket: int, t_len: int, band: int) -> list[dict]:
    """Kernel B as the DiT calls it (B 2, H 12, D 64, fp32, window 2 * band,
    no log-sum-exp): on a chunk's power-of-two bucket with the key mask
    ``arange(bucket) < t_len``, and on the refine steps' unbucketed chunk of
    ``t_len`` rows with no key mask. Each against both plain versions within
    2e-5, then timed beside the plain version, SDPA with the same boolean
    mask (TF32 off; a row with no live key gives NaN there, the mean of v
    here) and the bound, whose pairs count the band."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import attention_plain, attention_plain_fp32_tc, flash_fwd_fp32

    gen = torch.Generator(device="cuda").manual_seed(5)
    H, D, B, window, tol = 12, 64, 2, 2 * band, ATTN_TOL[torch.float32]
    scale = D**-0.5
    rows = []
    for label, T, live in (("DiT chunk, bucket with key mask", bucket, t_len), ("DiT refine, unbucketed", t_len, None)):
        q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(3))
        mask = None if live is None else (torch.arange(T, device="cuda") < live).expand(B, T).contiguous()
        out = flash_fwd_fp32(q, k, v, mask, False, window, scale, False)[0]
        err = {name: (out - fn(q, k, v, mask, window=window)).abs().max().item()
               for name, fn in (("tc", attention_plain_fp32_tc), ("fp32", attention_plain))}
        idx = torch.arange(T, device="cuda")
        sdpa_mask = ((idx[:, None] - idx[None]).abs() <= band)[None, None]
        if mask is not None:
            sdpa_mask = sdpa_mask & mask[:, None, None, :]
        qs, ks, vs = sdpa_layout(q, k, v)
        pairs = H * attended_pairs(B, T, T, False, mask, window)
        bounds = fp32_bounds(4.0 * pairs * D, 4 * 4 * B * T * H * D)  # q, k, v in; out
        times = in_turns({"plain": lambda: attention_plain(q, k, v, mask, window=window),
                          "kernel": lambda: flash_fwd_fp32(q, k, v, mask, False, window, scale, False),
                          "library": lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs,
                                                                                             attn_mask=sdpa_mask)})
        row = {"label": label, "shape": f"B{B} T{T} S{T} H{H} D{D} fp32 window{window}"
                                        + ("" if live is None else f" key mask {live} of {T}"),
               "ms": times["kernel"], "plain_ms": times["plain"], "library_ms": times["library"], **bounds,
               "pairs_share": pairs / (B * H * T * T), "useful_tflops": bounds["flops"] / times["kernel"] / 1e9,
               "max_abs_err": err, "tol": tol}
        rows.append(row)
        print(f"flash_attention_fwd fp32 {label} {row['shape']}: max_abs_err {err['tc']:.3e} against the plain "
              f"version that splits as the kernel does, {err['fp32']:.3e} against the fp32 one (tol {tol:g}); kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, scaled_dot_product_attention "
              f"{row['library_ms']:.4f} ms ({row['ms'] / row['library_ms']:.2f}x); bound {row['bound_ms']:.4f} ms "
              f"(three TF32 products {row['tf32x3_ms']:.4f}, fp32 FMAs {row['fma_ms']:.4f}, bytes "
              f"{row['bytes_ms']:.4f}); the band and key mask leave {row['pairs_share']:.4f} of T x S: "
              f"{row['useful_tflops']:.1f} useful TFLOP/s")
        if not all(e <= tol for e in err.values()):
            raise AssertionError(f"flash_attention fp32 {label}: {err} above {tol}")
        del q, k, v, qs, ks, vs, out, sdpa_mask
    torch.cuda.empty_cache()
    report["attention_dit"] = rows
    return rows


def written_positions(events, refined, full: np.ndarray, seq_indices: dict) -> tuple[int, bool]:
    """The POS_X / POS_Y values that ``refined`` holds, against the sampled
    coordinates (the first of the CFG pair, in pixels, rounded) at the rows
    of ``events``' DISTANCE and POS_X / POS_Y events, in order; no DISTANCE
    may remain. Returns how many were written and whether all agree."""
    from mapperatorinator_tpu_torch.osu.events import EventType

    pixels = (full[0] + 1) / 2 * np.array([512.0, 384.0])
    want = {axis: [int(round(float(pixels[seq_indices[i], col]))) for i, e in enumerate(events)
                   if e.type in (EventType.DISTANCE, pos)]
            for axis, col, pos in (("x", 0, EventType.POS_X), ("y", 1, EventType.POS_Y))}
    got = {axis: [e.value for e in refined if e.type == pos]
           for axis, pos in (("x", EventType.POS_X), ("y", EventType.POS_Y))}
    ok = got == want and len(want["x"]) > 0 and not any(e.type == EventType.DISTANCE for e in refined)
    return len(got["x"]), ok


def dit_step_profile(pipe, diffusion, model_fn, x, t_len: int, noise, reps: int = 10) -> dict:
    """One DDPM step on the last chunk's bucket with its slider in-paint, as
    ``_sample_part`` runs it (``pipe``'s last chunk's sliders): the step's
    wall time (host clock, the card synchronized after ``reps`` steps) and
    the pieces of its in-paint (the wait for the step's queued device work,
    the copy out, the host geometry ``_slider_recompute_host`` on the
    step's own prediction, the copy in); the same step without the
    in-paint; the card's share (the profiler's device kernels) and its idle
    share."""
    mask = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    mask[:, :t_len] = True
    step = torch.full((x.shape[0],), diffusion.num_timesteps - 1, dtype=torch.int64, device=x.device)
    parts = dict.fromkeys(("wait", "copy_out", "geometry", "copy_in"), 0.0)

    def in_painted(xx):
        # DiffusionPipeline._slider_in_paint, its pieces timed apart
        xx = torch.where(mask, xx, x)
        t = [time.perf_counter()]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        x_np = xx.cpu().numpy()
        t.append(time.perf_counter())
        y = pipe._slider_recompute_host(x_np)
        t.append(time.perf_counter())
        out = torch.from_numpy(y).to(xx.device)
        t.append(time.perf_counter())
        for k, t0, t1 in zip(parts, t, t[1:]):
            parts[k] += t1 - t0
        return out

    def step_fn(denoised):
        return lambda: diffusion.p_sample(model_fn, x, step, lambda shape: noise, clip_denoised=True,
                                          denoised_fn=denoised)

    def wall_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        parts.update(dict.fromkeys(parts, 0.0))
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    with torch.no_grad():
        full = step_fn(in_painted)
        bare_wall = wall_ms(step_fn(lambda xx: torch.where(mask, xx, x)))
        wall = wall_ms(full)
        pieces = {f"{k}_ms": v * 1e3 / reps for k, v in parts.items()}
        device = device_ms(full, reps)
        forward = device_ms(lambda: model_fn(x, diffusion._map_t(step)), reps)
    out = {"sliders": len(pipe._cb_sliders), "wall_ms": wall, **pieces, "bare_wall_ms": bare_wall,
           "device_ms": device, "forward_device_ms": forward, "idle": None if device is None else 1 - device / wall}
    idle = "not measured" if device is None else f"{out['idle']:.3f}"
    print(f"DiT step (the last chunk's bucket, {out['sliders']} sliders): {wall:.3f} ms a step with the slider "
          f"in-paint, of it the wait for the card {pieces['wait_ms']:.3f}, the copy out {pieces['copy_out_ms']:.3f}, "
          f"the host geometry {pieces['geometry_ms']:.3f} and the copy in {pieces['copy_in_ms']:.3f} ms; "
          f"{bare_wall:.3f} ms without the in-paint; the card's share {fmt_ms(device)} (the DiT forward "
          f"{fmt_ms(forward)}), idle share {idle}")
    return out


def dit_phase(tmp: Path, wav: Path, report: dict) -> tuple[dict, list[dict]]:
    """DiT position refinement at full width (DiT-B: depth 12, hidden 768,
    12 heads, context 272, 48 classes; about 130 M parameters) with seeded
    random weights, written as a diffusion bundle and a refine bundle with
    the port's msgpack writer and loaded with ``load_diffusion_model``:

    * kernel B at the DiT's shapes (``dit_attention``), and one DiT forward
      and one ``p_sample`` step on the last chunk's padded bucket through
      the kernel against the plain path, same weights and noise, within
      ``DIT_TOL``;
    * (a) the pipeline on a dense synthesized song (``dense_dit_map``)
      parsed under v31, whose DISTANCE and POS_X / POS_Y events the
      pipeline replaces, at v32's 100 respaced steps (v31's other
      diffusion settings are v32's): two chunks (the second overlap
      re-noised), the slider ends in-painted on the host each step, 100
      DDPM steps and 10 refine steps a chunk, each DiT forward 12 launches
      of the fp32 forward kernel and nothing else of B, C or D, the
      positions written into the events those of the sampled sequence;
      then the same run through the plain path, whose difference is
      printed, not held (the loop grows one-step differences). The host's
      wait for the card at each in-paint is timed apart from the round
      trip itself, and ``dit_step_profile`` profiles one sampling step;
    * (b) one v32 request through ``inference.run`` with
      ``generate_positions=true`` and both bundles.

    Returns the launches of (a) and (b) and B's rows at the DiT shapes."""
    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.diffusion.vocab import DiffusionVocab
    from mapperatorinator_tpu_torch.infer import GenerationConfig
    from mapperatorinator_tpu_torch.infer.diffusion_pipeline import DiffusionPipeline, _bucket_len
    from mapperatorinator_tpu_torch.models.dit import DiT, DiTConfig
    from mapperatorinator_tpu_torch.models.io import save_dit_bundle
    from mapperatorinator_tpu_torch.models.params import init_dit_params
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm
    from mapperatorinator_tpu_torch.osu import build_vocabulary
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
    from mapperatorinator_tpu_torch.osu.parsing import BeatmapParser

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda = torch.device("cuda")
    v32_steps = ",".join(str(n) for n in load_config("v32").timesteps)
    args = load_config("v31", ["seed=0", f"timesteps=[{v32_steps}]"])
    d = args.diffusion
    cfg = DiTConfig.from_name(d.model.model, context_size=d.model.context_size,
                              class_size=DiffusionVocab.from_args(d).num_tokens)
    if (cfg.depth, cfg.hidden_size, cfg.num_heads, cfg.context_size, cfg.class_size) != (12, 768, 12, 272, 48):
        raise AssertionError(f"not DiT-B at v1's context and classes: {cfg}")
    t0 = time.perf_counter()
    for name, seed in (("dit", 0), ("dit_refine", 1)):
        model = DiT(cfg).to(cuda)
        init_dit_params(model, seed, std=DIT_WEIGHT_STD)
        save_dit_bundle(tmp / name, model)
        del model
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dit = inference.load_diffusion_model(tmp / "dit", cuda)
    refine = inference.load_diffusion_model(tmp / "dit_refine", cuda)
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in dit.parameters())
    bundle_bytes = (tmp / "dit" / "params.msgpack").stat().st_size
    print(f"DiT: {d.model.model} ({n_params / 1e6:.1f} M parameters, bundle {bundle_bytes / 1e6:.0f} MB), two bundles "
          f"written in {write_s:.2f} s and loaded in {load_s:.2f} s")

    beatmap = Beatmap.from_path(dense_dit_map(tmp / "dit_dense.osu"))
    events, _ = BeatmapParser(args.train, build_vocabulary(args.train)).parse(beatmap)
    timing = [tp for tp in beatmap.timing_points if tp.parent is None]
    generation_config = GenerationConfig(difficulty=5.0, circle_size=4.0)
    pipe = DiffusionPipeline(args, dit, refine)
    seq_x, _, seq_c, seq_len, seq_indices, sliders = pipe.events_to_sequence(events, timing,
                                                                             beatmap.slider_multiplier)
    ob, band = args.overlap_buffer, d.data.seq_len
    starts = list(range(0, max(seq_len - 2 * ob, 1), args.max_seq_len - 2 * ob))
    last, t_len = starts[-1], seq_len - starts[-1]
    bucket = _bucket_len(t_len)
    if len(starts) != 2 or not t_len < bucket or t_len % 64 == 0 or not sliders:
        raise AssertionError(f"the dense song gives {len(starts)} chunks, a last chunk of {t_len} rows in "
                             f"{bucket}, {len(sliders)} sliders: not two chunks, a padded bucket and sliders")
    rows = dit_attention(report, bucket, t_len, band)

    # one forward and one p_sample step on the last chunk's bucket, kernel against plain
    diffusion = pipe._get_diffusion()
    x = torch.zeros((2, bucket, 2), device=cuda)
    x[:, :t_len] = torch.as_tensor(seq_x[last:], dtype=torch.float32, device=cuda)
    c = torch.zeros((2, bucket, seq_c.shape[1]), device=cuda)
    c[:, :t_len] = torch.as_tensor(seq_c[last:], device=cuda)
    null = dataclasses.replace(generation_config, descriptors=generation_config.negative_descriptors)
    y = torch.as_tensor(np.stack([pipe.get_class_vector(generation_config), pipe.get_class_vector(null)]),
                        device=cuda)
    key_valid = torch.arange(bucket, device=cuda) < t_len
    step = torch.full((2,), diffusion.num_timesteps - 1, dtype=torch.int64, device=cuda)
    noise = torch.randn(x.shape, generator=torch.Generator(device=cuda).manual_seed(6), device=cuda)

    def model_fn(xx, tt):
        return dit.forward_with_cfg(xx, tt, c, y, args.diff_cfg_scale, band=band, key_valid=key_valid)

    outs = {}
    with torch.no_grad():
        for path, on in (("kernel", True), ("plain", False)):
            set_flash(dit, on)
            outs[path] = (model_fn(x, diffusion._map_t(step)),
                          diffusion.p_sample(model_fn, x, step, lambda shape: noise)["sample"])
    set_flash(dit, True)
    fwd_err = (outs["kernel"][0] - outs["plain"][0]).abs().max().item()
    step_err = (outs["kernel"][1] - outs["plain"][1]).abs().max().item()
    print(f"DiT forward (CFG pair, {bucket} rows, {t_len} real) through kernel B vs the plain path: max_abs_err "
          f"{fwd_err:.3e}; one p_sample step at t {diffusion.timestep_map[-1]}: {step_err:.3e} (tol {DIT_TOL:g})")
    if not (fwd_err <= DIT_TOL and step_err <= DIT_TOL):
        raise AssertionError(f"the DiT through kernel B disagrees with the plain path: {fwd_err}, {step_err}")
    del outs

    # (a) the dense song through the pipeline, through the kernel and then the plain path
    forwards = collections.Counter()
    hooks = [m.register_forward_hook(lambda *_, name=name: forwards.update([name]))
             for name, m in (("dit", dit), ("refine", refine))]
    runs = {}
    for path, on in (("kernel", True), ("plain", False)):
        set_flash(dit, on)
        set_flash(refine, on)
        pipe = DiffusionPipeline(args, dit, refine)
        fulls, waited = [], {"wait_s": 0.0, "in_paint_s": 0.0}
        to_positions, in_paint = pipe._to_positions, pipe._slider_in_paint
        pipe._to_positions = lambda full: (fulls.append(np.array(full)), to_positions(full))[1]

        def timed_in_paint(xx, in_paint=in_paint, waited=waited):
            # the wait for the step's queued device work, apart from the
            # round trip (copy out, host geometry, copy in) itself
            t_ = time.perf_counter()
            torch.cuda.synchronize()
            t_w = time.perf_counter()
            out = in_paint(xx)
            waited["wait_s"] += t_w - t_
            waited["in_paint_s"] += time.perf_counter() - t_w
            return out

        pipe._slider_in_paint = timed_in_paint
        reset_attention_launches()
        fused_mel.launches = qmm.launches = qmm.launches_gemv = qmm.launches_tc = 0
        forwards.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refined = pipe.generate(events, generation_config, timing)
        torch.cuda.synchronize()
        runs[path] = {"wall_s": time.perf_counter() - t0, "full": fulls[0], **waited, "refined": refined,
                      "forwards": dict(forwards), "events": len(refined),
                      "launches": {**attention_launches(), "fused_mel": fused_mel.launches, "qmm": qmm.launches_gemv,
                                   "qmm_tc": qmm.launches_tc}}
    set_flash(dit, True)
    set_flash(refine, True)
    for hook in hooks:
        hook.remove()
    kernel, plain = runs["kernel"], runs["plain"]
    steps, refine_iters = diffusion.num_timesteps, args.refine_iters
    want_forwards = {"dit": steps * len(starts), "refine": refine_iters * len(starts)}
    want_launches = 12 * sum(want_forwards.values())
    launched = kernel["launches"]
    drift = float(np.abs(kernel["full"] - plain["full"]).max())
    finite = bool(np.isfinite(kernel["full"]).all())
    moved = float(np.abs(kernel["full"][0] - seq_x).max())
    n_written, written_ok = written_positions(events, kernel.pop("refined"), kernel["full"], seq_indices)
    plain.pop("refined")
    print(f"DiT (a): {seq_len} rows from {DIT_OBJECTS} hit objects ({len(sliders)} sliders in-painted), "
          f"{len(starts)} chunks (the last {t_len} rows in a bucket of {bucket}), {steps} DDPM steps and "
          f"{refine_iters} refine steps a chunk, band {band}: {kernel['wall_s']:.2f} s through the kernel, "
          f"{kernel['in_paint_s']:.2f} s of it in the slider in-paint's host round trips and {kernel['wait_s']:.2f} s "
          f"waiting for the card before them; {plain['wall_s']:.2f} s through the plain path "
          f"({plain['in_paint_s']:.2f} and {plain['wait_s']:.2f} s); DiT forwards {kernel['forwards']}; launches "
          f"{launched}; positions finite {finite}, moved up to {moved:.3f} from the song's; {n_written} positions "
          f"written into the events, those of the sampled sequence {written_ok}; the whole loop through the kernel "
          f"vs the plain path differs by up to {drift:.3e} ({drift * 256:.3f} px; printed, not held)")
    if kernel["forwards"] != want_forwards or launched["flash_attention_fwd"] != want_launches \
            or any(launched[k] for k in launched if k != "flash_attention_fwd") or not finite or not written_ok:
        raise AssertionError(f"DiT (a): forwards {kernel['forwards']} (want {want_forwards}), launches {launched} "
                             f"(want {want_launches} of flash_attention_fwd and nothing else), finite {finite}, "
                             f"positions written {written_ok}")
    step_profile = dit_step_profile(pipe, diffusion, model_fn, x, t_len, noise)

    # (b) one v32 request with generate_positions, through inference.run
    (tmp / "dit-request").mkdir()
    rargs = load_config("v32", ["model_path=", "seed=0", f"audio_path={wav}", f"output_path={tmp / 'dit-request'}",
                                "gamemode=0", "generate_positions=true", f"diff_ckpt={tmp / 'dit'}",
                                f"diff_refine_ckpt={tmp / 'dit_refine'}"])
    request_forwards = collections.Counter()
    load_diffusion_model = inference.load_diffusion_model

    def counted_load(path, device):
        model = load_diffusion_model(path, device)
        model.register_forward_hook(lambda *_, name=Path(path).name: request_forwards.update([name]))
        return model

    inference.load_diffusion_model = counted_load
    reset_attention_launches()
    fused_mel.launches = qmm.launches = qmm.launches_gemv = qmm.launches_tc = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text, osu_path = inference.run(rargs)
        torch.cuda.synchronize()
        request_s = time.perf_counter() - t0
    finally:
        inference.load_diffusion_model = load_diffusion_model
    request_launches = {**attention_launches(), "fused_mel": fused_mel.launches, "qmm": qmm.launches_gemv,
                        "qmm_tc": qmm.launches_tc}
    written = Beatmap.from_path(osu_path)
    print(f"DiT (b): a v32 request with generate_positions=true through inference.run: {request_s:.2f} s (model "
          f"and bundles loaded), {len(written.hit_objects())} hit objects written, DiT forwards "
          f"{dict(request_forwards)}, launches {request_launches} (v32 writes positions as POS tokens, which the "
          f"pipeline, as the JAX one, leaves as generated)")
    if not request_forwards.get("dit") or request_launches["flash_attention_fwd"] < 12 * sum(request_forwards.values()):
        raise AssertionError(f"DiT (b): the request ran the DiT {dict(request_forwards)} times, launching "
                             f"{request_launches}")

    seconds = time.perf_counter() - started
    peak = torch.cuda.max_memory_allocated() - held
    print(f"DiT phase: {seconds:.1f} s, peak memory {peak / 2**30:.2f} GiB over the {held / 2**30:.2f} GiB held "
          f"before")
    report["dit"] = {"parameters": n_params, "bundle_bytes": bundle_bytes, "write_s": write_s, "load_s": load_s,
                     "seq_len": seq_len, "sliders": len(sliders), "chunks": len(starts), "last_chunk": t_len,
                     "bucket": bucket, "forward_err": fwd_err, "p_sample_err": step_err, "tol": DIT_TOL,
                     "a": {path: {k: v for k, v in run.items() if k != "full"} for path, run in runs.items()},
                     "a_drift": drift, "a_moved": moved, "a_written": n_written, "step": step_profile,
                     "b": {"seconds": request_s, "forwards": dict(request_forwards), "launches": request_launches,
                           "hit_objects": len(written.hit_objects())},
                     "seconds": seconds, "peak_gb": peak / 2**30, "held_before_gb": held / 2**30}
    del dit, refine, pipe
    torch.cuda.empty_cache()
    return {k: launched[k] + request_launches[k] for k in launched}, rows


def super_timing_phase(tmp: Path, wav: Path, report: dict) -> dict:
    """``generate`` with ``super_timing=true`` at ``TIMER_ITERATIONS`` members
    (v32's ``timer_iterations`` is 20): the ensemble pools every member's windows into parallel decodes of up to
    ``max_batch_size`` rows on the graphed step. Every window of every member
    must come back decoded; random weights may give no usable timing, and
    the run then falls back to the fixed redline, which is printed."""
    from mapperatorinator_tpu_torch.infer.processor import Processor
    from mapperatorinator_tpu_torch.infer.super_timing import SuperTimingGenerator
    from mapperatorinator_tpu_torch.osu.rendering import Renderer

    windows = {"pooled": 0, "decoded": 0}
    timing = {"ensemble_events": [], "timing_points": []}  # what the ensemble gave; what each timing became
    patched = {(Processor, "run_parallel_sessions"): Processor.run_parallel_sessions,
               (Processor, "consume_parallel_row"): Processor.consume_parallel_row,
               (SuperTimingGenerator, "generate"): SuperTimingGenerator.generate,
               (Renderer, "generate_timing"): Renderer.generate_timing}

    def pooled(self, sessions, verbose=True):
        windows["pooled"] += sum(len(state["windows"]) for state in sessions)
        return patched[Processor, "run_parallel_sessions"](self, sessions, verbose)

    def decoded(self, state, frame_time, row):
        windows["decoded"] += 1
        return patched[Processor, "consume_parallel_row"](self, state, frame_time, row)

    def ensemble(self, *a, **kw):
        events, times = patched[SuperTimingGenerator, "generate"](self, *a, **kw)
        timing["ensemble_events"].append(len(events))
        return events, times

    def timing_points(self, events):
        points = patched[Renderer, "generate_timing"](self, events)
        timing["timing_points"].append(len(points))
        return points

    for (cls, name), fn in zip(patched, (pooled, decoded, ensemble, timing_points)):
        setattr(cls, name, fn)
    try:
        launches = serve("4-super-timing", tmp, wav, ["super_timing=true", f"timer_iterations={TIMER_ITERATIONS}",
                                                      f"train.model.overwrite.decoder_layers={CUT_DECODER_LAYERS}"],
                         report, check_encoder=False, widths=WHISPER_SMALL_CUT)
    finally:
        for (cls, name), fn in patched.items():
            setattr(cls, name, fn)
    result = report["requests"][-1]
    # inference.generate renders the ensemble's events as timing first, when there are any
    fallback = timing["ensemble_events"] == [0] or timing["timing_points"][:1] == [0]
    result.update(super_timing={"iterations": TIMER_ITERATIONS, "windows": windows, **timing,
                                "fallback_redline": fallback})
    print(f"super-timing: {TIMER_ITERATIONS} members (cut from v32's {TIMER_ITERATIONS_V32}), {windows['pooled']} "
          f"windows pooled, {windows['decoded']} "
          f"decoded; decode calls by batch rows: "
          + ", ".join(f"B {rows}: {c['calls']} calls, {c['steps']} steps, {c['ms_per_step']:.3f} ms a step (host "
                      "clock, captures included)" for rows, c in sorted(result["decode_rows"].items()))
          + f"; {result['graphs']['captures']} graphs captured in {result['graphs']['capture_s']:.2f} s, a graph "
          f"pool of {fmt_bytes(result['graphs']['pool_bytes'])}; the ensemble gave {timing['ensemble_events'][0]} timing events, "
          + ("no usable timing: the fixed redline" if fallback else f"{timing['timing_points'][0]} timing points")
          + f"; the .osu has {result['timing_points']} timing points")
    if windows["pooled"] == 0 or windows["decoded"] != windows["pooled"]:
        raise AssertionError(f"super-timing decoded {windows['decoded']} of {windows['pooled']} pooled windows")
    return launches


def server_phase(tmp: Path, wav: Path, report: dict) -> dict:
    """The batching server in this process, serving one engine from its batch
    thread, and two greedy requests sent at once from two clients in two
    threads (difficulty 4 and 7). The first batch of more than one row is
    decoded again by a direct call of the same engine glue: the tokens must
    be equal. Both .osu files must parse. A request the server keeps failing
    raises in its thread (the client's RuntimeError) and ends the run."""
    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.infer.server import InferenceClient, InferenceServer, make_engine_generate_fn
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap

    out = tmp / "5-server"
    out.mkdir()
    args = [load_config("v32", ["model_path=", "seed=0", f"audio_path={wav}", f"output_path={out}", "gamemode=0",
                                "do_sample=false", f"difficulty={d}", f"title=Request {i}"])
            for i, d in enumerate((4, 7))]
    engine, vocab = inference.load_model(args[0])
    check_full_width(engine.model)
    glue = make_engine_generate_fn(engine, vocab)
    rows, recorded = [], {}

    def generate_fn(model_kwargs, generate_kwargs):
        batch = ({k: v.copy() for k, v in model_kwargs.items()}, dict(generate_kwargs))
        tokens, stats = glue(model_kwargs, generate_kwargs)
        rows.append(int(batch[0]["frames"].shape[0]))
        if rows[-1] > 1 and not recorded:
            recorded.update(batch=batch, tokens=tokens.copy())
        return tokens, stats

    # relative to the working directory (the repo root): a Unix socket's path may hold 107 bytes
    server = InferenceServer(generate_fn, max_batch_size=args[0].max_batch_size,
                             socket_path=os.path.relpath(OUT_DIR / "server.sock"))
    results, errors, served = {}, {}, {}
    start = threading.Barrier(2)

    def request(i):
        try:
            client = InferenceClient(socket_path=server.socket_path)
            served[i] = {"tokens": 0, "seconds": 0.0}
            call = client.generate

            def counted(model_kwargs, generate_kwargs):
                tokens = call(model_kwargs, generate_kwargs)
                served[i]["tokens"] += client.last_generation_stats["generated_tokens"]
                served[i]["seconds"] += client.last_generation_stats["elapsed_seconds"]
                return tokens

            client.generate = counted
            inference.compile_args(args[i], vocab, verbose=False)
            generation_config, beatmap_config = inference.get_config(args[i])
            start.wait(timeout=60)
            results[i] = inference.generate(args[i], generation_config=generation_config,
                                            beatmap_config=beatmap_config, engine=engine, vocab=vocab,
                                            verbose=False, client=client)
            client.close()
        except BaseException as e:  # handed to the main thread, which raises it
            errors[i] = e

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    server.start()
    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=request, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVER_JOIN_S)
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a request to the server did not return within {SERVER_JOIN_S} s")
    for e in errors.values():
        raise e
    torch.cuda.synchronize()
    launches = attention_launches()
    peak = torch.cuda.max_memory_allocated()
    for i, (text, path) in results.items():
        beatmap = Beatmap.from_path(path)
        if beatmap.mode != 0 or beatmap.title != f"Request {i}" or "[HitObjects]" not in text:
            raise AssertionError(f"server request {i}: {path} does not read back as the requested beatmap")
    if not recorded:
        raise AssertionError(f"the batch thread never formed a batch of more than one row: {rows}")
    direct, _ = glue(*recorded["batch"])
    equal = bool(np.array_equal(direct, recorded["tokens"]))
    result = {"wall_s": wall, "batch_rows": rows, "requests": served, "launches": launches, "peak_mem_gb": peak / 2**30,
              "captures": engine.captures, "capture_s": engine.capture_seconds,
              "recorded_batch_rows": int(recorded["batch"][0]["frames"].shape[0]), "direct_tokens_equal": equal}
    report["server"] = result
    print(f"server: two requests in {wall:.2f} s, {len(rows)} batches by rows {dict(collections.Counter(rows))}, "
          + ", ".join(f"request {i} {r['tokens']} tokens at {r['tokens'] / r['seconds']:.1f} tok/s"
                      for i, r in sorted(served.items()))
          + f"; {engine.captures} graphs captured in {engine.capture_seconds:.2f} s on the batch thread; peak memory "
          f"{peak / 2**30:.2f} GiB, launches {launches}; the first {result['recorded_batch_rows']}-row batch decoded "
          f"again by a direct call: tokens {'equal' if equal else 'DIFFERENT'}")
    if not equal or launches["flash_attention_fwd"] == 0:
        raise AssertionError(f"the server phase failed its checks: {result}")
    del engine, glue
    torch.cuda.empty_cache()
    return launches


OSU_TEMPLATE = """osu file format v14

[General]
AudioFilename: audio.wav
Mode: 0

[Metadata]
Title:T{i}
Artist:A
Creator:C
Version:V{i}
BeatmapID:{bid}

[Difficulty]
HPDrainRate:5
CircleSize:4
OverallDifficulty:7
ApproachRate:9
SliderMultiplier:1.4
SliderTickRate:1

[TimingPoints]
500,500,4,2,0,70,1,0

[HitObjects]
{objects}
"""


def write_ors(root: Path, tracks: int = ORS_TRACKS) -> Path:
    """An ``ors`` track-folder dataset made from a seed: ``tracks`` tracks
    of ``ORS_SECONDS`` s of audio, each with ``ORS_MAPS`` maps whose hit
    objects, one every 50 ms, fill the 2560-token target of a window."""
    rng = np.random.default_rng(0)
    for track_i in range(tracks):
        track = root / f"Track{track_i:05d}"
        (track / "beatmaps").mkdir(parents=True)
        write_wav(track / "audio.wav", ORS_SECONDS, seed=track_i, freq=220.0 + 30 * track_i)
        metadata = {"Beatmaps": {}}
        for bm_i in range(ORS_MAPS):
            bid = track_i * 10 + bm_i
            (track / "beatmaps" / f"map{bm_i}.osu").write_text(
                OSU_TEMPLATE.format(i=bm_i, bid=bid, objects=osu_objects(rng, ORS_SECONDS)))
            metadata["Beatmaps"][f"map{bm_i}"] = {"BeatmapId": bid, "Index": track_i * ORS_MAPS + bm_i,
                                                  "StandardStarRating": {"0": 5.0, "64": 6.2}, "RankedYear": 2020}
        (track / "metadata.json").write_text(json.dumps(metadata))
    return root


def data_overrides(ors: Path) -> list[str]:
    # the local track folders, for the checks and the paths that train on them: they read the descriptor table
    # from the repo's csv
    return ["data.dataset_type=ors", "data.descriptors_path=datasets/beatmap_descriptors.csv",
            f"data.train_dataset_path={ors}", "data.train_dataset_start=0", f"data.train_dataset_end={ORS_TRACKS}",
            f"data.test_dataset_path={ors}", "data.test_dataset_start=0", f"data.test_dataset_end={ORS_TRACKS}"]


# --- parquet: a plain writer (UNCOMPRESSED, PLAIN, one data page a column) and rows as JSON ---

PARQUET_TYPES = {"BOOLEAN": 0, "INT32": 1, "INT64": 2, "DOUBLE": 5, "BYTE_ARRAY": 6}
PARQUET_PLAIN = {"INT32": "<i4", "INT64": "<i8", "DOUBLE": "<f8"}
PARQUET_REPETITION = {"REQUIRED": 0, "OPTIONAL": 1, "REPEATED": 2}
PARQUET_CONVERTED = {"UTF8": 0, "LIST": 3}
THRIFT_TYPES = {"i32": 5, "i64": 6, "binary": 8, "struct": 12}


def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def thrift_value(kind: str, value) -> bytes:
    """A Thrift compact-protocol value: "i32", "i64", "binary", "struct"
    (``[(field id, kind, value)]`` in ascending id order) or "list_<kind>"."""
    if kind in ("i32", "i64"):
        return _varint((value << 1) ^ (value >> 63))
    if kind == "binary":
        data = value.encode("utf-8") if isinstance(value, str) else value
        return _varint(len(data)) + data
    if kind == "struct":
        out, last = bytearray(), 0
        for fid, field_kind, field in value:
            out.append(((fid - last) << 4) | THRIFT_TYPES.get(field_kind, 9))
            out += thrift_value(field_kind, field)
            last = fid
        return bytes(out) + b"\0"
    element = kind.removeprefix("list_")
    size = len(value)
    header = bytes([(size << 4) | THRIFT_TYPES[element]]) if size < 15 else \
        bytes([0xF0 | THRIFT_TYPES[element]]) + _varint(size)
    return header + b"".join(thrift_value(element, v) for v in value)


def _rle_levels(levels: list[int], max_level: int) -> bytes:
    """Levels as RLE runs of the hybrid encoding, behind their byte length."""
    width = (max_level.bit_length() + 7) // 8
    out = b"".join(_varint(len(list(run)) << 1) + value.to_bytes(width, "little")
                   for value, run in itertools.groupby(levels))
    return len(out).to_bytes(4, "little") + out


def _plain_values(ptype: str, values: list) -> bytes:
    if ptype == "BYTE_ARRAY":
        data = [v.encode("utf-8") if isinstance(v, str) else v for v in values]
        return b"".join(len(v).to_bytes(4, "little") + v for v in data)
    if ptype == "BOOLEAN":
        return np.packbits(np.asarray(values, bool), bitorder="little").tobytes()
    return np.asarray(values, PARQUET_PLAIN[ptype]).tobytes()


def write_parquet(path: Path, schema: list[dict], columns: list[tuple], num_rows: int) -> None:
    """A parquet file of one row group, each column one PLAIN data page,
    uncompressed, from the elements of ``schema`` under the root in
    depth-first order (``name``, ``repetition``, and ``type`` for a leaf,
    ``num_children`` for a group, ``converted_type``) and, for each leaf,
    ``(non-null values, definition levels, repetition levels)`` (None where
    the leaf has no such level)."""
    leaves, pos = [], 0

    def walk(prefix: list, max_def: int, max_rep: int) -> None:
        nonlocal pos
        element = schema[pos]
        pos += 1
        max_def += element["repetition"] != "REQUIRED"
        max_rep += element["repetition"] == "REPEATED"
        if "type" in element:
            leaves.append((element, [*prefix, element["name"]], max_def, max_rep))
        for _ in range(element.get("num_children", 0)):
            walk([*prefix, element["name"]], max_def, max_rep)

    top = 0
    while pos < len(schema):
        walk([], 0, 0)
        top += 1
    body, chunks = bytearray(b"PAR1"), []
    for (element, leaf_path, max_def, max_rep), (values, defs, reps) in zip(leaves, columns, strict=True):
        count = len(defs) if defs is not None else len(values)
        page = ((_rle_levels(reps, max_rep) if max_rep else b"") + (_rle_levels(defs, max_def) if max_def else b"")
                + _plain_values(element["type"], values))
        header = thrift_value("struct", [(1, "i32", 0), (2, "i32", len(page)), (3, "i32", len(page)),
                                         (5, "struct", [(1, "i32", count), (2, "i32", 0), (3, "i32", 3),
                                                        (4, "i32", 3)])])
        offset = len(body)
        body += header + page
        size = len(header) + len(page)
        meta = [(1, "i32", PARQUET_TYPES[element["type"]]), (2, "list_i32", [0, 3]), (3, "list_binary", leaf_path),
                (4, "i32", 0), (5, "i64", count), (6, "i64", size), (7, "i64", size), (9, "i64", offset)]
        chunks.append([(2, "i64", offset), (3, "struct", meta)])
    elements = [[(4, "binary", "schema"), (5, "i32", top)]]
    for e in schema:
        fields = [(1, "i32", PARQUET_TYPES[e["type"]])] if "type" in e else []
        fields += [(3, "i32", PARQUET_REPETITION[e["repetition"]]), (4, "binary", e["name"])]
        fields += [(5, "i32", e["num_children"])] if "num_children" in e else []
        fields += [(6, "i32", PARQUET_CONVERTED[e["converted_type"]])] if "converted_type" in e else []
        elements.append(fields)
    group = [(1, "list_struct", chunks), (2, "i64", len(body) - 4), (3, "i64", num_rows)]
    footer = thrift_value("struct", [(1, "i32", 1), (2, "list_struct", elements), (3, "i64", num_rows),
                                     (4, "list_struct", [group]), (6, "binary", "chip_smoke.py write_parquet")])
    path.write_bytes(bytes(body) + footer + len(footer).to_bytes(4, "little") + b"PAR1")


def write_web_shard(path: Path, rows: list[dict]) -> None:
    """A web-dataset shard of ``{"json": str or None, "opus": {"bytes":
    bytes or None} or None}`` rows, the schema pandas writes for them."""
    schema = [{"name": "json", "repetition": "OPTIONAL", "type": "BYTE_ARRAY", "converted_type": "UTF8"},
              {"name": "opus", "repetition": "OPTIONAL", "num_children": 1},
              {"name": "bytes", "repetition": "OPTIONAL", "type": "BYTE_ARRAY"}]
    opus = [0 if r["opus"] is None else 1 if r["opus"]["bytes"] is None else 2 for r in rows]
    write_parquet(path, schema, [([r["json"] for r in rows if r["json"] is not None],
                                  [int(r["json"] is not None) for r in rows], None),
                                 ([r["opus"]["bytes"] for r, d in zip(rows, opus) if d == 2], opus, None)],
                  len(rows))


def encode_cell(value):
    """A cell of a parquet row as JSON: Python scalars as they are, the rest
    tagged (a non-finite float, bytes as hex, datetimes, dates, arrays with
    their dtype, dicts)."""
    if isinstance(value, np.generic):
        value = value.item()
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value if math.isfinite(value) else {"float": repr(value)}
    if isinstance(value, bytes):
        return {"bytes": value.hex()}
    if isinstance(value, datetime.datetime):
        return {"datetime": value.isoformat()}
    if isinstance(value, datetime.date):
        return {"date": value.isoformat()}
    if isinstance(value, np.ndarray):
        return {"array": str(value.dtype), "values": [encode_cell(v) for v in value]}
    if isinstance(value, dict):
        return {"dict": {k: encode_cell(v) for k, v in value.items()}}
    raise TypeError(f"no JSON form for a cell of type {type(value).__name__}")


def encode_rows(rows: list[dict], index: list) -> dict:
    return {"index": [encode_cell(i) for i in index], "rows": [{k: encode_cell(v) for k, v in r.items()} for r in rows]}


def parquet_phase(report: dict) -> None:
    """The port's reader on every committed fixture (written by pandas and
    pyarrow: SNAPPY, dictionary pages): its rows must equal the rows
    recorded beside each file."""
    from mapperatorinator_tpu_torch.train.data.parquet import read_table, table_row

    report["parquet"] = out = {}
    for path in sorted(PARQUET_FIXTURES.glob("*.parquet")):
        t0 = time.perf_counter()
        columns, index = read_table(path)
        rows = [table_row(columns, i) for i in range(len(index))]
        seconds = time.perf_counter() - t0
        equal = encode_rows(rows, list(index)) == json.loads(path.with_suffix(".json").read_text())
        out[path.name] = {"rows": len(rows), "columns": len(columns), "bytes": path.stat().st_size,
                          "read_s": seconds, "equal": equal}
        print(f"parquet reader: {path.name} ({path.stat().st_size} bytes, {len(rows)} rows x {len(columns)} "
              f"columns) read in {seconds:.4f} s; rows equal to the recorded ones: {equal}")
        if not equal:
            raise AssertionError(f"the reader's rows of {path} differ from {path.with_suffix('.json').name}")
    if len(out) < 2:
        raise AssertionError(f"the committed parquet fixtures are missing: {sorted(out)}")


def osu_objects(rng, seconds: float) -> str:
    """Hit objects one every 50 ms (a new combo every eighth): they fill a
    window's 2 560-token target."""
    return "\n".join(f"{int(rng.integers(50, 450))},{int(rng.integers(50, 330))},{500 + k * 50},"
                     f"{5 if k % 8 == 0 else 1},0,0:0:0:0:" for k in range(int((seconds - 1) * 20)))


def write_mmrs(root: Path) -> Path:
    """An MMRS dataset: the committed ``metadata.parquet`` (written by pandas,
    ``tests/fixtures/parquet_fixtures.py``) and the folders and files its
    rows name, made from a seed as ``write_ors`` makes its tracks."""
    rng = np.random.default_rng(0)
    root.mkdir(parents=True)
    (root / "metadata.parquet").write_bytes((PARQUET_FIXTURES / "mmrs_metadata.parquet").read_bytes())
    for set_i in range(ORS_TRACKS):
        folder = root / "data" / MMRS_FOLDER.format(set_i)
        folder.mkdir(parents=True)
        write_wav(folder / "audio.wav", ORS_SECONDS, seed=set_i, freq=220.0 + 30 * set_i)
        for bm_i in range(ORS_MAPS):
            (folder / f"map{bm_i}.osu").write_text(OSU_TEMPLATE.format(
                i=bm_i, bid=set_i * 10 + bm_i, objects=osu_objects(rng, ORS_SECONDS)))
    return root


def web_beatmap(set_i: int, bm_i: int, content: str) -> dict:
    """A beatmap's osu!web metadata in a web row's ``json``."""
    return {"beatmap_id": set_i * 10 + bm_i, "beatmapset_id": 1000 + set_i, "mode": 0, "approved": 1,
            "approved_date": "2020-05-01 10:00:00", "submit_date": "2019-05-01 10:00:00", "difficultyrating": 5.0,
            "user_id": 42, "content": content}


def write_web(root: Path) -> Path:
    """A web dataset: one shard under ``compressed/`` (v32's
    ``dataset_subset``) of ``ORS_TRACKS`` sets, each a row with
    ``ORS_MAPS`` maps in its ``json`` and ``ORS_SECONDS`` s of WAV audio
    embedded, written by :func:`write_web_shard` (pyarrow, which writes the
    real shards, is not on the machine)."""
    rng = np.random.default_rng(0)
    (root / "compressed").mkdir(parents=True)
    rows = []
    for set_i in range(ORS_TRACKS):
        wav = write_wav(root / "audio.wav", ORS_SECONDS, seed=set_i, freq=220.0 + 30 * set_i)
        beatmaps = [web_beatmap(set_i, bm_i, OSU_TEMPLATE.format(i=bm_i, bid=set_i * 10 + bm_i,
                                                                  objects=osu_objects(rng, ORS_SECONDS)))
                    for bm_i in range(ORS_MAPS)]
        rows.append({"json": json.dumps({"beatmaps": beatmaps}), "opus": {"bytes": wav.read_bytes()}})
    (root / "audio.wav").unlink()
    write_web_shard(root / "compressed" / "train-00000.parquet", rows)
    return root


def web_overrides(web: Path) -> list[str]:
    # v32's own dataset_type (web) and subset (compressed), from a local directory of shards
    return [f"data.train_dataset_path={web}", "data.train_dataset_start=0", "data.train_dataset_end=1",
            f"data.test_dataset_path={web}", "data.test_dataset_start=0", "data.test_dataset_end=1"]


def mmrs_overrides(mmrs: Path) -> list[str]:
    # the recipe's own dataset_type (mmrs), from an MMRS root of ORS_TRACKS sets
    return [f"data.train_dataset_path={mmrs}", "data.train_dataset_start=0", f"data.train_dataset_end={ORS_TRACKS}",
            f"data.test_dataset_path={mmrs}", "data.test_dataset_start=0", f"data.test_dataset_end={ORS_TRACKS}"]


def check_gradients(ors: Path, report: dict) -> dict:
    """On the first training batch at batch 2: the loss and every parameter
    gradient through the kernels against the plain attention path. In fp32
    (the fp32 kernels B and C) within ``GRAD_TOL``. In bf16 (the tensor-core
    pair), on the same batch and the same seeded weights, both bf16 paths
    are held against the fp32 plain gradients: the kernels' error must stay
    within ``GRAD_TOL_BF16`` times plain bf16 attention's own. Returns the
    attention launches of both passes: a check, not a main path."""
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.step import to_device

    def build(precision: str):
        args = load_train_config("v32", data_overrides(ors) + [f"mixed_precision={precision}",
                                                               "dataloader.num_workers=0"])
        return train_main.build_model_and_data(args, torch.device("cuda"))

    def loss_and_grads(model, batch, flash: bool):
        set_flash(model, flash)
        model.zero_grad(set_to_none=True)
        _, loss = model(**batch)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}

    def with_kernels(model, batch, kernels) -> tuple[float, dict, dict]:
        reset_attention_launches()
        loss, grads = loss_and_grads(model, batch, True)
        launches = attention_launches()
        want = {name: ATTN_PER_STEP if name in kernels else 0 for name in launches}
        if launches != want:
            raise AssertionError(f"the gradient check launched {launches}, not {want}")
        return loss, grads, launches

    model, _, make_batches = build("no")
    batch = to_device({k: v[:2] for k, v in next(iter(make_batches(test=False))).items()}, "cuda")
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_k, grads_k, fp32_launches = with_kernels(model, batch, ("flash_attention_fwd", "flash_attention_bwd"))
    loss_ref, ref = loss_and_grads(model, batch, False)
    err, name = worst_relative(grads_k, ref)
    print(f"training gradients, first batch, fp32, B2, kernels B+C (fp32) vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_ref:.6f}, {len(ref)} gradient tensors, largest error relative to the tensor's largest entry "
          f"{err:.3e} ({name}; tol {GRAD_TOL:g}), launches {fp32_launches}")
    report["training"]["gradient_check"] = {"loss_kernels": loss_k, "loss_plain": loss_ref, "tensors": len(ref),
                                            "worst_relative": err, "worst_tensor": name, "tol": GRAD_TOL}
    if sorted(grads_k) != sorted(ref) or len(ref) != len(list(model.parameters())):
        raise AssertionError("the two paths reached different parameters")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_ref) <= GRAD_TOL * abs(loss_ref) and err <= GRAD_TOL):
        raise AssertionError(f"gradients through the kernels disagree: loss {loss_k} vs {loss_ref}, worst {err}")
    del model, grads_k
    torch.cuda.empty_cache()

    model, _, _ = build("bf16")
    if any(not torch.equal(p, weights[n]) for n, p in model.named_parameters()):
        raise AssertionError("the bf16 model's seeded weights differ from the fp32 model's")
    loss_k, grads_k, launches = with_kernels(model, batch, ("flash_attention_fwd_sm90", "flash_attention_bwd_sm90"))
    loss_p, grads_p = loss_and_grads(model, batch, False)
    (err_k, name_k), (err_p, name_p), (err_kp, _) = (worst_relative(grads_k, ref), worst_relative(grads_p, ref),
                                                     worst_relative(grads_k, grads_p))
    print(f"training gradients, first batch, bf16, B2, against the fp32 plain gradients: kernels B+C (tensor "
          f"cores) loss {loss_k:.6f}, largest relative error {err_k:.3e} ({name_k}); plain bf16 attention loss "
          f"{loss_p:.6f}, {err_p:.3e} ({name_p}); fp32 loss {loss_ref:.6f} (tol: the kernels within "
          f"{GRAD_TOL_BF16:g}x plain bf16's error); kernels vs plain bf16 {err_kp:.3e}; launches {launches}")
    report["training"]["gradient_check_bf16"] = {
        "loss_kernels": loss_k, "loss_plain_bf16": loss_p, "loss_fp32": loss_ref, "worst_relative_kernels": err_k,
        "worst_tensor_kernels": name_k, "worst_relative_plain_bf16": err_p, "worst_tensor_plain_bf16": name_p,
        "kernels_vs_plain_bf16": err_kp, "tol_factor": GRAD_TOL_BF16, "launches": launches}
    if not (math.isfinite(loss_k) and abs(loss_k - loss_ref) <= GRAD_TOL_BF16 * abs(loss_p - loss_ref) + 1e-2
            and err_k <= GRAD_TOL_BF16 * err_p):
        raise AssertionError(f"bf16 gradients through the kernels are further from fp32 than plain bf16 attention's: "
                             f"{err_k} against {err_p}, loss {loss_k} against {loss_p} (fp32 {loss_ref})")
    del model, grads_k, grads_p, ref, batch, weights
    torch.cuda.empty_cache()
    return {name: fp32_launches[name] + launches[name] for name in launches}


def train_overrides(data: list[str], ckpt: Path, batch: int, grad_acc: int, steps: int) -> list[str]:
    return data + [
        f"optim.batch_size={batch}", f"optim.grad_acc={grad_acc}", f"optim.total_steps={steps}",
        "dataloader.balancer_buffer_size=0", "eval.every_steps=0", "checkpoint.every_steps=1000000",
        f"checkpoint_path={ckpt}", "logging.every_steps=1", "logging.log_with=none"]


def metrics_steps(logs: Path) -> list[dict]:
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    return [r for r in records if "train/loss" in r]


def train_fp32(tmp: Path, ors: Path, report: dict) -> dict:
    """fp32 training through ``train.main`` (``mixed_precision=no``), the
    fp32 pair's training path: the full-width model at batch
    ``FP32_TRAIN_BATCH`` for ``FP32_TRAIN_STEPS`` micro-steps. Every step's
    loss must be finite, and every attention call must launch the fp32 pair
    and nothing else. Returns its attention launches."""
    from mapperatorinator_tpu_torch.train import main as train_main

    logs = tmp / "logs_fp32"
    overrides = train_overrides(data_overrides(ors), tmp / "ckpt_fp32", FP32_TRAIN_BATCH, 1, FP32_TRAIN_STEPS)
    reset_attention_launches()
    t0 = time.perf_counter()
    state = train_main.main(["-cn", "v32", *overrides, "mixed_precision=no"], log_dir=str(logs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attention_launches()
    steps = metrics_steps(logs)
    if state.model.cfg.backbone.dtype != torch.float32 or len(steps) != FP32_TRAIN_STEPS:
        raise AssertionError(f"fp32 training: dtype {state.model.cfg.backbone.dtype}, {len(steps)} steps logged")
    if not all(math.isfinite(r["train/loss"]) for r in steps):
        raise AssertionError(f"an fp32 training loss is not finite: {[r['train/loss'] for r in steps]}")
    want = {name: 0 for name in launches}
    want["flash_attention_fwd"] = want["flash_attention_bwd"] = ATTN_PER_STEP * FP32_TRAIN_STEPS
    if launches != want:
        raise AssertionError(f"the fp32 micro-steps launched {launches}, not {want}")
    print(f"training fp32 (mixed_precision=no), batch {FP32_TRAIN_BATCH}: {FP32_TRAIN_STEPS} micro-steps in "
          f"{wall:.1f} s (model build and data included), losses {[round(r['train/loss'], 4) for r in steps]}, "
          f"s/step {[round(r['train/seconds_per_step'], 3) for r in steps]}, launches {launches}")
    report["training_fp32"] = {"wall_s": wall, "launches": launches, "steps": steps, "batch": FP32_TRAIN_BATCH}
    del state
    torch.cuda.empty_cache()
    return launches


def train_phase(tmp: Path, report: dict) -> dict:
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import CheckpointManager, batch_tokens, card_line
    from mapperatorinator_tpu_torch.train.optim import build_optimizer
    from mapperatorinator_tpu_torch.train.step import TrainState, make_train_step, named_flax_params

    from mapperatorinator_tpu_torch.train.data.parquet import read_table

    report["training"] = {}
    for name, write in (("ors", write_ors), ("web", write_web), ("mmrs", write_mmrs)):
        t0 = time.perf_counter()
        write(tmp / name)
        report["training"][f"{name}_write_s"] = time.perf_counter() - t0
    shard = next((tmp / "web" / "compressed").glob("*.parquet"))
    t0 = time.perf_counter()
    read_table(shard)
    report["training"]["web_shard_read_s"] = read_s = time.perf_counter() - t0
    print(f"datasets: {ORS_TRACKS} sets x {ORS_MAPS} maps, {ORS_SECONDS:g} s of audio each, as ors track folders, "
          f"a web shard ({shard.stat().st_size / 2**20:.1f} MiB, the audio embedded; read by the port's parquet "
          f"reader in {read_s:.3f} s) and an MMRS root, written in "
          + ", ".join(f"{report['training'][f'{n}_write_s']:.1f} s" for n in ("ors", "web", "mmrs")))
    ors, web = tmp / "ors", tmp / "web"
    check_launches = check_gradients(ors, report)
    fp32_launches = train_fp32(tmp, ors, report)

    ckpt, logs = tmp / "ckpt", tmp / "logs"
    overrides = train_overrides(web_overrides(web), ckpt, TRAIN_BATCH, TRAIN_GRAD_ACC, TRAIN_MICRO_STEPS)
    print(f"training cuts: {TRAIN_MICRO_STEPS} micro-steps ({TRAIN_MICRO_STEPS // TRAIN_GRAD_ACC} updates) of v32's "
          f"batch {TRAIN_BATCH} x grad_acc {TRAIN_GRAD_ACC}; its own dataset_type web from one local shard of the "
          "synthesized sets; no eval; token balancer off (its 2048-sample buffer outlasts the run); width and depth "
          "as published")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    t0 = time.perf_counter()
    state = train_main.main(["-cn", "v32", *overrides], log_dir=str(logs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = attention_launches()

    b = state.model.cfg.backbone
    if (b.d_model, b.encoder_layers, b.decoder_layers, b.decoder_heads, b.encoder_ffn, b.dtype) != \
            (768, 12, 12, 12, 3072, torch.bfloat16):
        raise AssertionError(f"not the full-width bf16 v32 backbone: {b}")
    steps = metrics_steps(logs)
    shapes = {"frames": np.zeros((TRAIN_BATCH, 2047 * 128)), "decoder_input_ids": np.zeros((TRAIN_BATCH, 2560))}
    tokens = batch_tokens(shapes, state.model.cfg)
    card = card_line()
    for r in steps:
        print(f"train step {r['step']}: loss {r['train/loss']:.4f}, grad_l2 {r['train/grad_l2']:.3f}, "
              f"{r['train/seconds_per_step']:.3f} s/step, {tokens / r['train/seconds_per_step']:.0f} tokens/s "
              f"(encoder frames + decoder positions), peak {r['train/peak_mem_gib']:.2f} GiB, "
              f"MFU {r.get('train/mfu', float('nan')):.4f} of 989 TFLOP/s bf16 ({card})")
    if len(steps) != TRAIN_MICRO_STEPS or state.step != TRAIN_MICRO_STEPS:
        raise AssertionError(f"training ran {state.step} steps, logged {len(steps)}")
    if not all(math.isfinite(r["train/loss"]) for r in steps):
        raise AssertionError(f"a training loss is not finite: {[r['train/loss'] for r in steps]}")
    # bf16 micro-steps run the tensor-core pair only, once per attention call
    want = {name: 0 for name in launches}
    want["flash_attention_fwd_sm90"] = want["flash_attention_bwd_sm90"] = ATTN_PER_STEP * TRAIN_MICRO_STEPS
    if launches != want:
        raise AssertionError(f"the bf16 micro-steps launched {launches}, not {want}")
    print(f"training: {TRAIN_MICRO_STEPS} micro-steps in {wall:.1f} s (model build, data and the final checkpoint "
          f"included), launches {launches}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # restore the final checkpoint into a fresh state
    args = load_train_config("v32", overrides)
    if args.data.dataset_type != "web":
        raise AssertionError(f"v32 trained from dataset_type {args.data.dataset_type!r}, not its own web")
    fresh, _, make_batches = train_main.build_model_and_data(args, torch.device("cuda"))
    restored = CheckpointManager(ckpt).restore(TrainState(0, fresh, build_optimizer(args, named_flax_params(fresh))))
    trained = dict(state.model.named_parameters())
    same = all(torch.equal(p, trained[n]) for n, p in restored.model.named_parameters())
    print(f"checkpoint {CheckpointManager(ckpt).latest_step()}: restored step {restored.step}, parameters equal {same}")
    if restored.step != state.step or not same or restored.optimizer.count != state.optimizer.count:
        raise AssertionError("the checkpoint does not restore the trained state")
    del fresh, restored

    # one more micro-step, profiled by kernel
    from torch.profiler import ProfilerActivity, profile

    batch = next(iter(make_batches(test=False)))
    step = make_train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        metrics["loss"].item()
        torch.cuda.synchronize()
        profiled_s = time.perf_counter() - t1
    events = device_kernels(prof.key_averages())
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    breakdown = [{"kernel": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in top]
    print(f"profiled micro-step: {profiled_s:.3f} s on the host clock, {device_ms:.1f} ms of device kernels "
          f"(idle share {1 - device_ms / 1e3 / profiled_s:.3f})")
    for row in breakdown:
        print(f"  {row['ms']:9.2f} ms {row['calls']:5d} calls  {row['kernel']}")
    report["training"].update({
        "wall_s": wall, "launches": launches, "tokens_per_step": tokens, "steps": steps,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "batch": TRAIN_BATCH,
        "grad_acc": TRAIN_GRAD_ACC, "profiled_step_s": profiled_s, "profiled_device_ms": device_ms,
        "breakdown": breakdown})
    del state
    torch.cuda.empty_cache()
    return launches, fp32_launches, check_launches


def trace_kernels(trace: dict, top: int = 6) -> tuple[float, float, list]:
    """(device ms, span ms, the ``top`` kernels by device time) of a
    ``torch.profiler`` Chrome trace: the device kernels' summed durations,
    and the span from the first traced event to the last end."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]][0] += e["dur"]
            kernels[e["name"]][1] += 1
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return (sum(us for us, _ in kernels.values()) / 1e3, span / 1e3,
            [{"kernel": name[:90], "ms": us / 1e3, "calls": n} for name, (us, n) in ranked])


def lora_request_checks(base: Path, lora_dir: Path, quantized: bool):
    """A LoRA request's checks on its engine: the served weights are the base
    checkpoint's with the adapter merged (``merge_lora`` on the card, as
    ``load_model`` runs it), every target at base + (alpha / r) (A B)^T and
    every other weight the base's bits; with int8 weights, they are
    ``quantize_model`` of that merged model."""

    def checks(engine, args, vocab, first) -> dict:
        from mapperatorinator_tpu_torch.models.io import load_checkpoint, quantize_model
        from mapperatorinator_tpu_torch.models.lora import load_lora, merge_lora, merge_lora_into

        model, _ = load_checkpoint(base / "gamemode=0")
        model = model.to("cuda")
        adapter, config = load_lora(lora_dir, model)
        merged = merge_lora(dict(model.named_parameters()), adapter, alpha=config["lora_alpha"])
        unmerged = {n: t.clone() for n, t in model.state_dict().items()}
        merge_lora_into(model, adapter, alpha=config["lora_alpha"])
        want = quantize_model(model).state_dict() if quantized else model.state_dict()
        got = engine.model.state_dict()
        differ = sorted(n for n, t in want.items() if not torch.equal(got[n], t))
        moved = sum(not torch.equal(merged[n], unmerged[n]) for n in merged)
        n_targets = len(merged)
        print(f"LoRA request{' (int8)' if quantized else ''}: {n_targets} target weights merged at alpha "
              f"{config['lora_alpha']:g}, rank {config['r']} ({moved} moved off the base); served state "
              f"{'equals quantize_model of the merged model' if quantized else 'equals the merged model'}: "
              f"{not differ} ({len(want)} tensors)")
        if differ or moved != n_targets or set(got) != set(want):
            raise AssertionError(f"the served weights are not the merged adapter: {differ[:4]}, {moved} moved")
        del model, adapter, merged, unmerged, want
        torch.cuda.empty_cache()
        return {"lora_targets": n_targets, "weights_equal_merged": True}

    return checks


def finetune_phase(tmp: Path, report: dict) -> tuple[dict, dict]:
    """The fine-tune path: ``train.main -cn lora_v32`` from a base checkpoint
    of seeded random bf16 v32 weights under ``<tmp>/base/gamemode=0``, then
    two greedy requests served with the adapter it wrote, on a song of
    ``LORA_AUDIO_SECONDS``. The base's config
    carries the fused mel (``spectrogram.implementation=pallas``): a
    checkpoint's model config, not the request's, picks the mel, so kernel A
    runs in the micro-steps (once each, on 32 rows) and in both requests.
    Returns the launches of the LoRA micro-steps (attention and A) and those
    of the two requests."""
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.models.io import load_checkpoint, save_checkpoint
    from mapperatorinator_tpu_torch.models.lora import (get_model_checkpoint_subfolder, normalize_targets,
                                                         resolve_compatible_lora_path, resolve_model_checkpoint_path,
                                                         target_kernels)
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import batch_tokens, card_line

    report["finetune"] = out = {}
    mmrs = tmp / "mmrs"  # the training phase's MMRS root: lora_v32's own dataset_type
    t0 = time.perf_counter()
    args = load_train_config("lora_v32", mmrs_overrides(mmrs) + ["pretrained_path=", "dataloader.num_workers=0",
                                                                 "model.spectrogram.implementation=pallas"])
    model, vocab, _ = train_main.build_model_and_data(args, torch.device("cuda"))
    check_full_width(model)
    if model.cfg.backbone.dtype != torch.bfloat16:
        raise AssertionError(f"the base is not the bf16 training model: {model.cfg.backbone.dtype}")
    base = tmp / "base"
    save_checkpoint(base / "gamemode=0", model.cfg, model.state_dict(), vocab)
    del model
    torch.cuda.empty_cache()
    print(f"fine-tune base: seeded random full-width v32 bf16 training weights, the fused mel in its config, saved "
          f"under {base.name}/gamemode=0 in {time.perf_counter() - t0:.1f} s")

    ckpt, logs = tmp / "lora_ckpt", tmp / "logs_lora"
    overrides = mmrs_overrides(mmrs) + [
        f"pretrained_path={base}", "pretrained_gamemode=0", f"optim.grad_acc={LORA_GRAD_ACC}",
        f"optim.total_steps={LORA_MICRO_STEPS}", "eval.every_steps=0", "checkpoint.every_steps=1000000",
        f"checkpoint_path={ckpt}", "logging.every_steps=1", "logging.log_with=none", "profile.do_profile=true",
        "profile.wait=1", "profile.warmup=1", "profile.active=1", "dataloader.drop_last=true"]
    print(f"fine-tune cuts: pretrained_path {base.name} (seeded random weights; the published v32 checkpoint is a "
          f"download), its own dataset_type mmrs from the synthesized MMRS root (train_dataset_end {ORS_TRACKS} of "
          f"10), grad_acc 16 -> {LORA_GRAD_ACC}, {LORA_MICRO_STEPS} micro-steps "
          f"({LORA_MICRO_STEPS // LORA_GRAD_ACC} updates) of 1000, no eval, drop_last on (every micro-step 32 rows; "
          f"the synthesized set's epoch ends in a partial batch); rank, alpha, targets, Muon, bf16 and batch 32 as "
          f"published; the trace covers micro-steps {LORA_TRACED[0]}-{LORA_TRACED[-1]}")

    def counts() -> dict:
        return {**attention_launches(), "fused_mel": fused_mel.launches}

    # each micro-step's launches and tokens, the base and the adapter, seen
    # through the train step main builds
    per_step, b_moved, step_tokens, seen = [], [], [], {}
    make_step = train_main.make_lora_train_step

    def recording(model, alpha):
        step = make_step(model, alpha)
        seen["base"] = model

        def run(state, batch):
            before = counts()
            state, metrics = step(state, batch)
            after = counts()
            per_step.append({k: after[k] - before[k] for k in after})
            b_moved.append(all(bool(f.b.detach().abs().sum() > 0) for f in state.model.values()))
            step_tokens.append(batch_tokens(batch, model.cfg))
            return state, metrics

        return run

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    fused_mel.launches = 0
    train_main.make_lora_train_step = recording
    try:
        t0 = time.perf_counter()
        state = train_main.main(["-cn", "lora_v32", *overrides], log_dir=str(logs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        train_main.make_lora_train_step = make_step
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    steps = metrics_steps(logs)
    want_step = {name: 0 for name in launches}
    want_step["flash_attention_fwd_sm90"] = want_step["flash_attention_bwd_sm90"] = ATTN_PER_STEP
    want_step["fused_mel"] = 1
    if len(steps) != LORA_MICRO_STEPS or per_step != [want_step] * LORA_MICRO_STEPS:
        raise AssertionError(f"the LoRA micro-steps launched {per_step}, not {want_step} each")
    if not all(math.isfinite(r["train/loss"]) for r in steps):
        raise AssertionError(f"a LoRA loss is not finite: {[r['train/loss'] for r in steps]}")
    if b_moved != [False] + [True] * (LORA_MICRO_STEPS - 1):
        raise AssertionError(f"B should be zero until the first update and nonzero after it: {b_moved}")
    stored, _ = load_checkpoint(base / "gamemode=0")
    trained_base = seen["base"].state_dict()
    frozen = all(torch.equal(t, trained_base[n].cpu()) for n, t in stored.state_dict().items())
    lora_args = load_train_config("lora_v32", overrides)
    targets = target_kernels(stored, normalize_targets(lora_args.lora["target_modules"]))
    rank = lora_args.lora["r"]
    want_params = sum(rank * (m.in_features + m.out_features) for m in targets.values())
    n_params = sum(p.numel() for p in state.model.parameters())
    trace = logs / "profile" / "trace.json"
    trace_text = trace.read_text() if trace.exists() else ""
    traced = {name: name in trace_text for name in ("flash_fwd_sm90_kernel", "flash_bwd_sm90_kernel")}
    traced_ms, span_ms, top = trace_kernels(json.loads(trace_text)) if trace_text else (0.0, 0.0, [])
    del trace_text
    lora_config = json.loads((ckpt / "lora" / "lora_config.json").read_text())
    print(f"fine-tune: {LORA_MICRO_STEPS} micro-steps in {wall:.1f} s (checkpoint load, data, the trace and the "
          f"adapter's save included), launches {launches} ({ATTN_PER_STEP} + {ATTN_PER_STEP} sm90 and one A a "
          f"micro-step, nothing else of B or C), base weights after the run bit-equal to the checkpoint: {frozen}, "
          f"B nonzero after each micro-step {b_moved}, {n_params} trainable parameters over {len(targets)} targets "
          f"(sum of r (in + out): {want_params}), trace {trace.stat().st_size / 2**20 if trace.exists() else 0:.1f} "
          f"MiB naming {traced}, lora_config ckpt_subfolders {lora_config['ckpt_subfolders']}")
    if not frozen or n_params != want_params or not all(traced.values()) \
            or lora_config["ckpt_subfolders"] != ["gamemode=0"]:
        raise AssertionError("the fine-tune run failed a check")
    card = card_line()
    for r, tokens in zip(steps, step_tokens):
        traced_mark = " (traced)" if r["step"] in LORA_TRACED else ""
        print(f"LoRA micro-step {r['step']}{traced_mark}: loss {r['train/loss']:.4f}, grad_l2 "
              f"{r['train/grad_l2']:.4f}, {tokens:.0f} tokens (encoder frames + decoder positions), "
              f"{r['train/seconds_per_step']:.3f} s/step, {tokens / r['train/seconds_per_step']:.0f} tokens/s, peak "
              f"{r['train/peak_mem_gib']:.2f} GiB, MFU {r.get('train/mfu', float('nan')):.4f} by the port's "
              f"numerator, {r.get('train/mfu_jax_numerator', float('nan')):.4f} by the JAX one ({card})")
    steady = [r for r in steps if r["step"] in LORA_STEADY]
    steady_s = sum(r["train/seconds_per_step"] for r in steady) / len(steady)
    steady_tokens = sum(step_tokens[r["step"] - 1] for r in steady) / len(steady)
    steady_mfu = {k: sum(r.get(f"train/{k}", float("nan")) for r in steady) / len(steady)
                  for k in ("mfu", "mfu_jax_numerator")}
    print(f"steady LoRA micro-steps {LORA_STEADY} (untraced, mid-epoch, an accumulation and an update): "
          f"{steady_s:.3f} s a micro-step, {steady_tokens / steady_s:.0f} tokens/s, MFU {steady_mfu['mfu']:.4f} by "
          f"the port's numerator, {steady_mfu['mfu_jax_numerator']:.4f} by the JAX one ({card})")
    out["steady"] = {"steps": list(LORA_STEADY), "s_per_step": steady_s, "tokens_per_s": steady_tokens / steady_s,
                     **steady_mfu}
    n_traced = len(LORA_TRACED)
    print(f"traced LoRA micro-steps {LORA_TRACED}: {traced_ms / n_traced:.1f} ms of device kernels a micro-step (the "
          f"full bf16 micro-step's, profiled above: {report['training']['profiled_device_ms']:.1f} ms); the trace "
          f"spans {span_ms / 1e3:.3f} s, device idle share {1 - traced_ms / span_ms:.3f} ({card})")
    for row in top:
        print(f"  {row['ms'] / n_traced:9.2f} ms {row['calls'] // n_traced:5d} calls a micro-step  {row['kernel']}")
    out.update({"traced_device_ms_per_step": traced_ms / n_traced, "trace_span_ms": span_ms, "traced_top": top})
    out.update({"wall_s": wall, "launches": launches, "per_step": per_step, "steps": steps, "peak_mem_gib": peak,
                "tokens_per_step": step_tokens, "trainable_params": n_params, "targets": len(targets),
                "trace_bytes": trace.stat().st_size, "b_moved": b_moved, "base_frozen": frozen})
    del state, stored, trained_base, seen["base"]
    torch.cuda.empty_cache()

    # serve with the adapter
    lora_dir = ckpt / "lora"
    wav = write_wav(tmp / "lora_song.wav", LORA_AUDIO_SECONDS)
    serving = {}
    for label, extra, quantized in (("lora-greedy-fused-mel", [], False),
                                    ("lora-int8-fused-mel", ["quantized_weights=true", "quantized_kv=true"], True)):
        serving[label] = serve(label, tmp, wav, [f"model_path={base}", f"lora_path={lora_dir}",
                                                 "do_sample=false", *extra],
                               report, check_encoder=False, after=lora_request_checks(base, lora_dir, quantized))
    # the kernels of request 2 (A and B) and of request 3 (B and both of D's
    # paths) with A; A once a window, as in request 2
    requests = {r["label"]: r for r in report["requests"]}
    for label, like in (("lora-greedy-fused-mel", "2-greedy-fused-mel"), ("lora-int8-fused-mel", "3-int8-checkpoint")):
        got, want = serving[label], requests[like]["launches"]
        if {k for k, v in got.items() if v} != {k for k, v in want.items() if v} | {"fused_mel"} \
                or got["fused_mel"] != requests[label]["windows"]:
            raise AssertionError(f"{label} launched {got} over {requests[label]['windows']} windows, request {like} "
                                 f"{want}")
    if requests["2-greedy-fused-mel"]["launches"]["fused_mel"] != requests["2-greedy-fused-mel"]["windows"]:
        raise AssertionError(f"request 2 launched A {requests['2-greedy-fused-mel']['launches']['fused_mel']} "
                             f"times over {requests['2-greedy-fused-mel']['windows']} windows")
    skipped, _ = resolve_compatible_lora_path(
        lora_dir, get_model_checkpoint_subfolder(resolve_model_checkpoint_path(base, gamemode=1)), verbose=False)
    kept, _ = resolve_compatible_lora_path(
        lora_dir, get_model_checkpoint_subfolder(resolve_model_checkpoint_path(base, gamemode=0)), verbose=False)
    print(f"the resolver at gamemode=1: adapter {'skipped' if skipped is None else 'kept'}; at gamemode=0: "
          f"{'kept' if kept is not None else 'skipped'}")
    if skipped is not None or kept is None:
        raise AssertionError("the resolver does not honour the adapter's ckpt_subfolders")
    out["serving_launches"] = serving
    return launches, {k: sum(r[k] for r in serving.values()) for k in next(iter(serving.values()))}


def aux_attention(report: dict) -> tuple[list[dict], list[dict]]:
    """Kernels B and C at the auxiliary trainers' calls (``AUX_ATTENTION``),
    against both fp32 plain versions (forward within 2e-5, backward within
    2e-5 times the largest reference gradient), timed beside the plain
    version, SDPA (its backward through autograd) and the bound. The
    classifier decoder's key mask pads each row's end, and its batch row 0
    is a window of pads only: no key is live there, so the exact dq and dk
    are 0, which C must write. Returns B's and C's rows."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain, attention_backward_plain_fp32_tc, attention_plain, attention_plain_fp32_tc,
        flash_bwd_fp32, flash_fwd_fp32)

    gen = torch.Generator(device="cuda").manual_seed(20)
    D, tol = 64, ATTN_TOL[torch.float32]
    scale = D**-0.5
    fwd_rows, bwd_rows = [], []
    for label, B, T, S, H, masked in AUX_ATTENTION:
        q, do = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(2))
        k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda") for _ in range(2))
        mask = sdpa_mask = None
        if masked:
            lengths = torch.randint(S // 4, S + 1, (B, 1), generator=gen, device="cuda")
            mask = torch.arange(S, device="cuda")[None] < lengths
            mask[0] = False
            sdpa_mask = torch.ones((T, S), dtype=torch.bool, device="cuda").tril()[None, None] & mask[:, None, None, :]
        out, lse = flash_fwd_fp32(q, k, v, mask, masked, 0, scale, True)
        fwd_err = {"tc": (out - attention_plain_fp32_tc(q, k, v, mask, causal=masked)).abs().max().item(),
                   "fp32": (out - attention_plain(q, k, v, mask, causal=masked)).abs().max().item()}
        grads = flash_bwd_fp32(q, k, v, mask, out, lse, do, masked, 0, scale)
        bwd_err, bwd_tol = {}, {}
        for name, plain in (("tc", attention_backward_plain_fp32_tc), ("fp32", attention_backward_plain)):
            want = plain(q, k, v, mask, do, causal=masked)
            bwd_err[name] = max((g - w).abs().max().item() for g, w in zip(grads, want))
            bwd_tol[name] = tol * max(1.0, max(w.abs().max().item() for w in want))
            del want
        if masked:  # no live key in row 0: dq and dk exactly 0 there
            bwd_err["pads row dq, dk"] = max(grads[0][0].abs().max().item(), grads[1][0].abs().max().item())
            bwd_tol["pads row dq, dk"] = 0.0
        del grads
        qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=sdpa_mask)
        do_s = do.transpose(1, 2).contiguous()
        el_q, el_k = B * T * H * D, B * S * H * D
        pairs = H * attended_pairs(B, T, S, masked, mask)
        shape = f"B{B} T{T} S{S} H{H} D{D} fp32" + (" causal + key mask, row 0 all pads" if masked else "")
        kinds = (("fwd", fwd_rows, fwd_err, {"tc": tol, "fp32": tol},
                  {"plain": lambda: attention_plain(q, k, v, mask, causal=masked),
                   "kernel": lambda: flash_fwd_fp32(q, k, v, mask, masked, 0, scale, True),
                   "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                       qs.detach(), ks.detach(), vs.detach(), attn_mask=sdpa_mask)},
                  fp32_bounds(4.0 * pairs * D, 4 * (2 * el_q + 2 * el_k) + 4 * B * H * T)),  # q, k, v in; out, lse
                 ("bwd", bwd_rows, bwd_err, bwd_tol,
                  {"plain": lambda: attention_backward_plain(q, k, v, mask, do, causal=masked),
                   "kernel": lambda: flash_bwd_fp32(q, k, v, mask, out, lse, do, masked, 0, scale),
                   "library": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True)},
                  # q, k, v, O, dO and lse in; dq, dk, dv out
                  fp32_bounds(10.0 * pairs * D, 4 * (3 * el_q + 2 * el_k) + 4 * (el_q + 2 * el_k) + 4 * B * H * T)))
        for kind, rows, err, tols, fns, bounds in kinds:
            t_ = in_turns(fns, reps=5)
            row = {"label": label, "shape": shape, "ms": t_["kernel"], "plain_ms": t_["plain"],
                   "library_ms": t_["library"], **bounds, "pairs_share": pairs / (B * H * T * S),
                   "max_abs_err": err, "tol": tols}
            rows.append(row)
            print(f"flash_attention_{kind} fp32 {label} {shape}: max_abs_err "
                  + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3e})" for n, e in err.items())
                  + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA"
                  + (" backward" if kind == "bwd" else "") + f" {row['library_ms']:.4f} ms "
                  f"({row['ms'] / row['library_ms']:.2f}x); bound {row['bound_ms']:.4f} ms (three TF32 products "
                  f"{row['tf32x3_ms']:.4f}, fp32 FMAs {row['fma_ms']:.4f}, bytes {row['bytes_ms']:.4f}); the masks "
                  f"leave {row['pairs_share']:.4f} of T x S")
            if not all(err[n] <= tols[n] for n in err):
                raise AssertionError(f"flash_attention_{kind} fp32 {label}: {err} above {tols}")
        del q, k, v, do, out, lse, qs, ks, vs, sdpa_out, do_s, sdpa_mask
        torch.cuda.empty_cache()
    report["attention_aux_training"] = {"fwd": fwd_rows, "bwd": bwd_rows}
    return fwd_rows, bwd_rows


@contextlib.contextmanager
def timed_steps(module, name: str, steps: list, describe=None):
    """``module.<name>`` (a train-step factory) replaced, while the block
    runs, by one whose steps each append their seconds (to a synchronize
    after the step), attention launches and, given ``describe``, what
    ``describe`` makes of the step's arguments to ``steps``."""
    make = getattr(module, name)

    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a, **kw):
            described = describe(*a, **kw) if describe is not None else {}
            before = attention_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            after = attention_launches()
            steps.append({"s": time.perf_counter() - t0, "launches": {k: after[k] - before[k] for k in after},
                          **described})
            return out

        return run

    setattr(module, name, factory)
    try:
        yield
    finally:
        setattr(module, name, make)


def trainer_run(label: str, module, factory: str, argv: list, record: dict):
    """``module.main(argv)``, each step timed (``timed_steps``), the
    attention counters set to 0 before and read after, the peak memory
    reset before: the run's wall, launches, steps and peak go to
    ``record[label]``. Returns what ``main`` returns."""
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with timed_steps(module, factory, steps):
        out = counted(label, lambda: module.main(argv), record)
    record[label].update({"steps": steps, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out


def worst_relative(grads: dict, ref: dict) -> tuple[float, str]:
    """The largest gradient error relative to its reference tensor's largest entry, and its tensor."""
    errs = {n: ((grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item() for n, g in ref.items()}
    name = max(errs, key=errs.get)
    return errs[name], name


def gradient_check(label: str, model, loss_fn, record: dict) -> dict:
    """``loss_fn()``'s loss and every parameter gradient through kernels B
    and C against the plain attention path (``set_flash``), within
    ``GRAD_TOL`` times each tensor's largest entry; the kernels' launches
    are the check's, not a main path's."""
    def loss_and_grads(flash: bool):
        set_flash(model, flash)
        loss = loss_fn()
        grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True, materialize_grads=True)
        return loss.item(), {n: g for (n, _), g in zip(model.named_parameters(), grads)}

    reset_attention_launches()
    loss_k, grads_k = loss_and_grads(True)
    launches = attention_launches()
    loss_p, grads_p = loss_and_grads(False)
    set_flash(model, True)
    err, name = worst_relative(grads_k, grads_p)
    out = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(grads_p), "worst_relative": err,
           "worst_tensor": name, "tol": GRAD_TOL, "launches": launches}
    print(f"{label} gradients, kernels B + C (fp32) against plain attention: loss {loss_k:.6f} vs {loss_p:.6f}, "
          f"{len(grads_p)} gradient tensors, largest error relative to the tensor's largest entry {err:.3e} ({name}; "
          f"tol {GRAD_TOL:g}), launches {launches}")
    record[f"{label} gradient check"] = out
    if not (launches["flash_attention_fwd"] and launches["flash_attention_fwd"] == launches["flash_attention_bwd"]
            and math.isfinite(loss_k) and abs(loss_k - loss_p) <= GRAD_TOL * abs(loss_p) and err <= GRAD_TOL):
        raise AssertionError(f"{label}: gradients through the kernels disagree: {out}")
    del grads_k, grads_p
    return launches


def per_step(run: dict) -> str:
    return ", ".join(f"{s['s']:.3f} s (B {s['launches']['flash_attention_fwd']}, C "
                     f"{s['launches']['flash_attention_bwd']})" for s in run["steps"])


def aux_train_phase(tmp: Path, report: dict) -> tuple[dict, dict, list[dict], list[dict]]:
    """The three auxiliary trainers through their entry points on the card,
    on train_phase's synthesized set (``tmp / "ors"``), each from weights
    seeded as flax draws them (``AUX_*`` says what is cut):

    * (a) ``diffusion_train -cn v1``: DiT-B (hidden 768, depth 12, heads 12,
      128 positions, context 272) at v1's batch 256, the uniform sampler;
      the EMA bundle it writes read back equal; then one step of the same
      model with the ``loss-second-moment`` sampler from a warm history;
    * (b) ``classifier_train -cn train_v1`` at train_v1's widths (d 512,
      6 + 6 layers, 8 heads, 388 mels): two optimizer steps of grad_acc 2
      and one eval batch; its bundle read back equal;
    * (c) ``rcomplexion_train -cn train_v1``: OsuR at batch 1 024, a few
      steps and one eval; its export read back equal.

    Every attention call of (a) and (b) must run B forward and C backward
    (12 of each a DiT step, 18 a classifier micro-step, 18 B an eval batch),
    and (c) none. Then one fp32 gradient check each for the DiT and the
    classifier through B + C against plain attention, and B and C at the
    trainers' calls (``aux_attention``). Returns the trainers' launches (a
    main path) and B's and C's rows."""
    from mapperatorinator_tpu_torch import classifier_train, diffusion_train, rcomplexion_train
    from mapperatorinator_tpu_torch.config import load_diffusion_config
    from mapperatorinator_tpu_torch.diffusion import create_diffusion
    from mapperatorinator_tpu_torch.diffusion.data import DiffusionDataset
    from mapperatorinator_tpu_torch.diffusion.schedule_sampler import make_schedule_sampler
    from mapperatorinator_tpu_torch.diffusion.vocab import DiffusionVocab
    from mapperatorinator_tpu_torch.config import load_classifier_config
    from mapperatorinator_tpu_torch.models.classifier import load_classifier_bundle
    from mapperatorinator_tpu_torch.models.io import load_dit_bundle, load_params
    from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
    from mapperatorinator_tpu_torch.train.data.batching import batch_iterator
    from mapperatorinator_tpu_torch.train.data.classifier import ClassifierDataset
    from mapperatorinator_tpu_torch.train.optim import build_adamw_chain

    gc.collect()  # the classifier at micro-batch 128 peaks at about 76 of the card's 79 GiB
    torch.cuda.empty_cache()
    started = time.perf_counter()
    ors, work, record = tmp / "ors", tmp / "aux", {}
    work.mkdir()
    common = ["logging.every_steps=1", "logging.log_with=none", "checkpoint.every_steps=1000000",
              "optim.warmup_steps=1"]
    print(f"auxiliary training cuts: DiT {AUX_DIT_STEPS} steps of 400 000 and one loss-second-moment step, the "
          f"classifier at micro-batch {AUX_CLF_BATCH} (train_v1's 128) for {AUX_CLF_MICRO_STEPS} micro-steps at "
          f"grad_acc 2, OsuR "
          f"{AUX_OSUR_STEPS} steps at batch 1 024; warmup_steps 1 (a schedule needs decay steps after its "
          "warmup), one eval batch, no checkpoint but the last; the synthesized set for the datasets; widths and "
          "batches otherwise as published")

    with contextlib.chdir(work):  # each trainer logs under ./logs, as the JAX ones do
        # (a) DiT-B
        dit_argv = ["-cn", "v1", f"data.train_dataset_path={ors}", "data.start=0", f"data.end={ORS_TRACKS}",
                    f"optim.total_steps={AUX_DIT_STEPS}", f"checkpoint_path={work / 'dit'}", *common]
        model, ema = trainer_run("dit", diffusion_train, "make_diffusion_train_step", dit_argv, record)
        cfg = ema.cfg
        if (cfg.hidden_size, cfg.depth, cfg.num_heads, cfg.context_size) != (768, 12, 12, 272):
            raise AssertionError(f"not DiT-B at v1: {cfg}")
        t0 = time.perf_counter()
        bundle = load_dit_bundle(work / "dit" / "final")
        unequal = [n for n, t in ema.state_dict().items() if not torch.equal(bundle.state_dict()[n], t.cpu())]
        record["dit"]["bundle_read_s"] = time.perf_counter() - t0
        if unequal:
            raise AssertionError(f"the DiT bundle reads back unequal at {unequal[:5]}")
        del bundle
        losses = [json.loads(line)["train/loss"] for line in (work / "logs" / "diffusion" / "metrics.jsonl")
                  .read_text().splitlines()]
        record["dit"]["losses"] = losses

        args = load_diffusion_config("v1")
        vocab = DiffusionVocab.from_args(args)
        args.data.train_dataset_path, args.data.end = str(ors), ORS_TRACKS
        diffusion = create_diffusion("", noise_schedule=args.model.noise_schedule,
                                     diffusion_steps=args.model.diffusion_steps)
        batch = diffusion_train.to_device(next(batch_iterator(DiffusionDataset(args.data, vocab),
                                                              args.optim.batch_size)), "cuda",
                                          diffusion_train.BATCH_KEYS)
        sampler = make_schedule_sampler("loss-second-moment", args.model.diffusion_steps,
                                        max_timestep=args.model.max_diffusion_step)
        gen = torch.Generator(device="cuda").manual_seed(7)
        state = sampler.init("cuda")
        state["history"].uniform_(0.05, 2.0, generator=gen)
        state["counts"][: sampler.support_size] = sampler.history_per_term
        history = state["history"].clone()
        lsm = diffusion_train.make_diffusion_train_step(
            model, ema, diffusion, build_adamw_chain(args.optim, model),
            max_t=args.model.max_diffusion_step, sampler=sampler)
        reset_attention_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, state = lsm(batch, state, gen, gen)
        loss = loss.item()
        record["dit loss-second-moment"] = {"s": time.perf_counter() - t0, "launches": attention_launches(),
                                            "loss": loss, "rows_moved": int((state["history"] != history)
                                                                            .any(-1).sum().item())}
        if not (math.isfinite(loss) and record["dit loss-second-moment"]["rows_moved"] > 0
                and int(state["counts"].sum()) == sampler.support_size * sampler.history_per_term):
            raise AssertionError(f"the loss-second-moment step: {record['dit loss-second-moment']}")
        # the vectorised ring update alone, at v1's batch (what it costs a step)
        t = torch.randint(0, sampler.support_size, (args.optim.batch_size,), generator=gen, device="cuda")
        losses = torch.rand(args.optim.batch_size, generator=gen, device="cuda")
        record["dit loss-second-moment"]["update_ms"] = median_ms(lambda: sampler.update(state, t, losses))

        x, c, y = (batch[k][:AUX_DIT_CHECK_BATCH] for k in ("x", "c", "y"))
        t = torch.randint(0, args.model.max_diffusion_step, (len(x),), generator=gen, device="cuda")
        noise = torch.randn(x.shape, generator=gen, device="cuda")
        checked = gradient_check("DiT-B", model, lambda: diffusion.training_losses(
            lambda xt, tt: model(xt, tt, c, y), x, t, lambda shape: noise)["loss"].mean(), record)
        del model, ema, batch, x, c, y, noise, lsm, state, history
        torch.cuda.empty_cache()

        # (b) the classifier at train_v1's widths
        mappers = mapper_table(tmp / "aux_mappers.json", ors)
        split = [f"data.mappers_path={mappers}", f"data.train_dataset_path={ors}", "data.train_dataset_start=0",
                 f"data.train_dataset_end={ORS_TRACKS}", f"data.test_dataset_path={ors}", "data.test_dataset_start=0",
                 f"data.test_dataset_end={ORS_TRACKS}"]
        clf_argv = ["-cn", "train_v1", *split, f"optim.batch_size={AUX_CLF_BATCH}",
                    f"optim.total_steps={AUX_CLF_MICRO_STEPS}", f"eval.every_steps={AUX_CLF_MICRO_STEPS}",
                    "eval.steps=1", f"checkpoint_path={work / 'clf'}", *common]
        classifier = trainer_run("classifier", classifier_train, "make_train_step", clf_argv, record)
        b = classifier.cfg.backbone
        if (b.d_model, b.encoder_layers, b.decoder_layers, b.encoder_heads, classifier.cfg.n_mels) != \
                (512, 6, 6, 8, 388):
            raise AssertionError(f"not the classifier at train_v1's widths: {classifier.cfg}")
        loaded = load_classifier_bundle(work / "clf" / "final")[0]
        unequal = [n for n, t in classifier.state_dict().items() if not torch.equal(loaded.state_dict()[n], t.cpu())]
        if unequal:
            raise AssertionError(f"the classifier bundle reads back unequal at {unequal[:5]}")
        logged = [json.loads(line) for line in (work / "logs" / "classifier" / "metrics.jsonl").read_text()
                  .splitlines()]
        record["classifier"]["logged"] = logged
        clf_args = load_classifier_config("train_v1", clf_argv[2:])
        clf_vocab = build_vocabulary(clf_args)
        check = next(batch_iterator(ClassifierDataset(clf_args, BeatmapParser(clf_args, clf_vocab), clf_vocab,
                                                      test=True), AUX_CLF_CHECK_BATCH))
        check = classifier_train.to_device(check, "cuda")
        checked_clf = gradient_check("classifier", classifier, lambda: classifier(
            check["frames"], check["decoder_input_ids"], check["decoder_attention_mask"], check["labels"])["loss"],
            record)
        del classifier, loaded, check
        torch.cuda.empty_cache()

        # (c) OsuR
        rc_argv = ["-cn", "train_v1", f"data.train_dataset_path={ors}", "data.train_dataset_start=0",
                   f"data.train_dataset_end={ORS_TRACKS}", f"data.test_dataset_path={ors}",
                   "data.test_dataset_start=0", f"data.test_dataset_end={ORS_TRACKS}",
                   "optim.batch_size=1024", f"optim.total_steps={AUX_OSUR_STEPS}",
                   f"eval.every_steps={AUX_OSUR_STEPS}", "eval.steps=1", f"checkpoint_path={work / 'osur'}", *common]
        osur = trainer_run("osur", rcomplexion_train, "make_train_step", rc_argv, record)
        exported = load_params(work / "osur" / "final" / "params.msgpack", copy.deepcopy(osur).cpu())
        if any(not torch.equal(a, b.cpu()) for a, b in zip(exported.state_dict().values(), osur.state_dict().values())):
            raise AssertionError("OsuR's export reads back unequal")
        record["osur"]["logged"] = [json.loads(line) for line in (work / "logs" / "rcomplexion" / "metrics.jsonl")
                                    .read_text().splitlines()]
        del osur, exported

    # every attention call of the DiT and the classifier on B and C, OsuR none
    want = {"dit": (DIT_CALLS * AUX_DIT_STEPS, DIT_CALLS * AUX_DIT_STEPS),
            "dit loss-second-moment": (DIT_CALLS, DIT_CALLS),
            "classifier": (CLF_CALLS * (AUX_CLF_MICRO_STEPS + 1), CLF_CALLS * AUX_CLF_MICRO_STEPS), "osur": (0, 0)}
    for label, (fwd, bwd) in want.items():
        got = record[label]["launches"]
        if (got["flash_attention_fwd"], got["flash_attention_bwd"]) != (fwd, bwd) \
                or got["flash_attention_fwd_sm90"] or got["flash_attention_bwd_sm90"]:
            raise AssertionError(f"{label} launched {got}, not B {fwd} and C {bwd} on the fp32 route")
    numbers = record["dit"]["losses"] + [v for r in record["classifier"]["logged"] + record["osur"]["logged"]
                                         for v in r.values()]
    val = [r for r in record["classifier"]["logged"] + record["osur"]["logged"] if "val/loss" in r]
    if len(record["dit"]["losses"]) != AUX_DIT_STEPS or len(val) != 2 or not np.isfinite(numbers).all():
        raise AssertionError(f"the trainers logged {record['dit']['losses']}, {record['classifier']['logged']}, "
                             f"{record['osur']['logged']}")
    for label, what in (("dit", "DiT-B, batch 256"), ("classifier", f"the classifier, micro-batch {AUX_CLF_BATCH}"),
                        ("osur", "OsuR, batch 1 024")):
        run = record[label]
        print(f"aux train ({what}): {run['wall_s']:.2f} s (model build, data, checkpoint and export included), "
              f"peak {run['peak_mem_gib']:.2f} GiB; steps {per_step(run)}")
    lsm_run = record["dit loss-second-moment"]
    print(f"aux train: DiT losses {[round(x, 5) for x in record['dit']['losses']]}, bundle read back equal in "
          f"{record['dit']['bundle_read_s']:.2f} s; loss-second-moment step {lsm_run['s']:.3f} s, loss "
          f"{lsm_run['loss']:.5f}, {lsm_run['rows_moved']} history rows moved, the sampler's update alone "
          f"{lsm_run['update_ms']:.4f} ms at batch 256; classifier "
          f"{record['classifier']['logged']}; OsuR {record['osur']['logged']}")
    fwd_rows, bwd_rows = aux_attention(report)
    record["phase_s"] = time.perf_counter() - started
    report["aux_train"] = record
    launches = {name: sum(record[label]["launches"][name] for label in want) for name in attention_launches()}
    checks = {name: checked[name] + checked_clf[name] for name in checked}
    print(f"aux train phase: {record['phase_s']:.1f} s, launches {launches} (gradient checks {checks})")
    return launches, checks, fwd_rows, bwd_rows


# the backbone training phase: every other backbone family through train.main at full width, its recipe's bf16 and
# adamwscale, on train_phase's synthesized set, from seeded random weights (the machine has no checkpoint, so none
# is loaded). Cut: grad_acc BACKBONE_GRAD_ACC and BACKBONE_MICRO_STEPS micro-steps (two updates) of the recipes'
# grad_acc 8 (v28 and the three model presets) and 32 (v29); warmup 1 of 10 000 (a cosine decay needs steps after
# its warmup); no eval; the micro-batch the recipe's 128 where it fits in BACKBONE_MEMORY_SHARE of the card, else
# the largest power of two that does, reckoned from two probes (printed with the phase)
BACKBONE_TRAIN = {  # config: (label, published widths, kernel B and C calls a forward)
    "v29": ("whisper-small (whisper_abs)", WHISPER_SMALL, 36),  # encoder self, decoder self, cross: 12 + 12 + 12
    "v28": ("whisper-base (whisper_abs)", WHISPER_BASE, 18),
    "t5_base": ("T5 v1.1-base (t5_relpos)", T5_BASE, 12),  # cross only: self-attention adds the position bias
    "nwhisper_base": ("NWhisper-base (nGPT)", NWHISPER_BASE, 18),  # every call, at sm_scale 1.0
    "moonshine_tiny": ("moonshine-tiny", MOONSHINE_TINY, 18),  # every call, D 36 zero-padded to 64
}
BACKBONE_GRAD_ACC, BACKBONE_MICRO_STEPS = 2, 4
BACKBONE_CHECK_BATCH, BACKBONE_PROBE_BATCH = 2, 8  # the gradient check's rows; the second memory probe's
BACKBONE_MEMORY_SHARE = 0.85


def capture_flash_calls(calls: dict):
    """A context in which the first ``flash_attention`` call of each
    signature (T, S, H, D, causal, window, key mask, sm_scale) keeps its
    inputs in ``calls``."""
    from mapperatorinator_tpu_torch.models import transformer

    @contextlib.contextmanager
    def ctx():
        flash = transformer.flash_attention

        def capture(q, k, v, kv_mask=None, *, causal=False, window=0, sm_scale=None):
            key = (q.shape[1], k.shape[1], q.shape[2], q.shape[3], bool(causal), int(window), kv_mask is not None,
                   sm_scale)
            if key not in calls:
                calls[key] = tuple(None if x is None else x.detach().clone() for x in (q, k, v, kv_mask))
            return flash(q, k, v, kv_mask, causal=causal, window=window, sm_scale=sm_scale)

        transformer.flash_attention = capture
        try:
            yield
        finally:
            transformer.flash_attention = flash

    return ctx()


def backbone_gradient_check(label: str, name: str, overrides: list, calls_per_forward: int) -> dict:
    """On the first training batch's first ``BACKBONE_CHECK_BATCH`` rows: the
    loss and every parameter gradient of the bf16 model through kernels B
    and C against the fp32 model's through plain attention, on the same
    seeded weights, within ``GRAD_TOL_BF16`` times plain bf16 attention's
    own error (``check_gradients``' rule), the kernels launched once each a
    covered call; the kernel pass keeps each call's inputs
    (:func:`capture_flash_calls`). Then the bf16 model's peak memory over a
    forward and backward at the check's rows and at
    ``BACKBONE_PROBE_BATCH``. Returns the record: the check, the calls, the
    peaks, the parameter count and the launches (a check's, not a main
    path's)."""
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.step import to_device

    def build(precision: str):
        args = load_train_config(name, overrides + [f"mixed_precision={precision}"])
        return train_main.build_model_and_data(args, torch.device("cuda"))

    def loss_and_grads(model, batch, flash: bool):
        set_flash(model, flash)
        model.zero_grad(set_to_none=True)
        _, loss = model(**batch)
        loss.backward()
        grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    model, _, make_batches = build("no")
    first = next(iter(make_batches(test=False)))
    batch = to_device({k: v[:BACKBONE_CHECK_BATCH] for k, v in first.items()}, "cuda")
    probe = to_device({k: v[:BACKBONE_PROBE_BATCH] for k, v in first.items()}, "cuda")
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_ref, ref = loss_and_grads(model, batch, False)
    n_params = sum(p.numel() for p in model.parameters())
    if len(ref) != len(weights):
        raise AssertionError(f"{label}: the fp32 loss reaches {len(ref)} of {len(weights)} parameters")
    del model
    torch.cuda.empty_cache()

    model, _, _ = build("bf16")
    if any(not torch.equal(p, weights[n]) for n, p in model.named_parameters()):
        raise AssertionError(f"{label}: the bf16 model's seeded weights differ from the fp32 model's")
    del weights
    calls = {}
    reset_attention_launches()
    with capture_flash_calls(calls):
        loss_k, grads_k = loss_and_grads(model, batch, True)
    launches = attention_launches()
    loss_p, grads_p = loss_and_grads(model, batch, False)
    want = {k: 0 for k in launches}
    want["flash_attention_fwd_sm90"] = want["flash_attention_bwd_sm90"] = calls_per_forward
    if launches != want or sorted(grads_k) != sorted(ref) or sorted(grads_p) != sorted(ref):
        raise AssertionError(f"{label}: the gradient check launched {launches}, not {want}, or its passes reached "
                             f"other parameters")
    (err_k, name_k), (err_p, name_p) = worst_relative(grads_k, ref), worst_relative(grads_p, ref)
    check = {"rows": BACKBONE_CHECK_BATCH, "loss_kernels": loss_k, "loss_plain_bf16": loss_p, "loss_fp32": loss_ref,
             "worst_relative_kernels": err_k, "worst_tensor_kernels": name_k, "worst_relative_plain_bf16": err_p,
             "worst_tensor_plain_bf16": name_p, "tensors": len(ref), "tol_factor": GRAD_TOL_BF16,
             "launches": launches}
    print(f"backbone training {label}: gradients at B{BACKBONE_CHECK_BATCH} of the first batch, bf16, against the "
          f"fp32 plain gradients: kernels B+C (tensor cores) loss {loss_k:.6f}, largest relative error {err_k:.3e} "
          f"({name_k}); plain bf16 attention loss {loss_p:.6f}, {err_p:.3e} ({name_p}); fp32 loss {loss_ref:.6f}; "
          f"{len(ref)} tensors (tol: the kernels within {GRAD_TOL_BF16:g}x plain bf16's error); launches {launches}")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_ref) <= GRAD_TOL_BF16 * abs(loss_p - loss_ref) + 1e-2
            and err_k <= GRAD_TOL_BF16 * err_p):
        raise AssertionError(f"{label}: bf16 gradients through the kernels are further from fp32 than plain bf16 "
                             f"attention's: {check}")
    del grads_k, grads_p, ref

    peaks = {}
    set_flash(model, True)
    for rows, b in ((BACKBONE_CHECK_BATCH, batch), (BACKBONE_PROBE_BATCH, probe)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, loss = model(**b)
        loss.backward()
        model.zero_grad(set_to_none=True)
        del loss
        peaks[rows] = torch.cuda.max_memory_allocated()
    probed = attention_launches()
    del model, batch, probe
    gc.collect()
    torch.cuda.empty_cache()
    return {"check": check, "calls": calls, "peaks": peaks, "params": n_params, "launches": probed}


def backbone_micro_batch(label: str, recipe_batch: int, probed: dict) -> tuple[int, dict]:
    """The micro-batch to train at: the recipe's where the reckoned peak fits
    in ``BACKBONE_MEMORY_SHARE`` of the card, else the largest power of two
    below it that does. The reckoning: the probes' peaks are linear in the
    rows (parameters, their gradients and bf16 copies, then activations a
    row), plus the optimizer's two fp32 moments and its accumulator a
    parameter, 12 bytes."""
    (r0, p0), (r1, p1) = sorted(probed["peaks"].items())
    per_row = (p1 - p0) / (r1 - r0)
    static = p0 - r0 * per_row + 12 * probed["params"]
    budget = BACKBONE_MEMORY_SHARE * torch.cuda.get_device_properties(0).total_memory
    batch = recipe_batch
    while batch > 1 and static + batch * per_row > budget:
        batch //= 2
    reckoning = {"per_row_gib": per_row / 2**30, "static_gib": static / 2**30, "budget_gib": budget / 2**30,
                 "recipe_gib": (static + recipe_batch * per_row) / 2**30,
                 "reckoned_gib": (static + batch * per_row) / 2**30, "batch": batch, "recipe_batch": recipe_batch}
    cut = "" if batch == recipe_batch else f"; cut to {batch}, the largest power of two that fits"
    print(f"backbone training {label}: reckoned peak {reckoning['recipe_gib']:.2f} GiB at the recipe's micro-batch "
          f"{recipe_batch} ({reckoning['static_gib']:.2f} GiB fixed + {reckoning['per_row_gib']:.3f} GiB a row, "
          f"from the peaks at {r0} and {r1} rows), budget {reckoning['budget_gib']:.2f} GiB{cut}")
    return batch, reckoning


def backbone_attention(label: str, calls: dict) -> tuple[list[dict], list[dict]]:
    """Kernels B and C on the bf16 route at each attention call of a
    family's training forward, on the inputs the gradient check's kernel
    pass gave them (its rows of the first batch): through ``flash_attention``
    under autograd (a head dim below 64 zero-padded, the output and the
    gradients sliced back) against both bf16 plain versions, the one that
    rounds as the route does and the fp32 one, within 2e-2 times the
    largest reference entry (at least 1), timed beside the plain version,
    SDPA (its backward through autograd) and the bound on the unpadded head
    dim. Returns B's and C's rows."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain, attention_backward_plain_bf16_tc, attention_plain, attention_plain_bf16_tc,
        attention_route, flash_attention, head_dim_width)

    gen = torch.Generator(device="cuda").manual_seed(21)
    tol, dtype = ATTN_TOL[torch.bfloat16], torch.bfloat16
    fwd_rows, bwd_rows = [], []
    for (T, S, H, D, causal, window, _, sm_scale), (q, k, v, mask) in calls.items():
        B = q.shape[0]
        call = "decoder self" if causal else "encoder self" if T == S else "cross"
        kw = {"causal": causal, "window": window, "sm_scale": sm_scale}
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention(*leaves, mask, **kw)
        grads = torch.autograd.grad(out, leaves, do, retain_graph=True)
        fwd_err, fwd_tol, bwd_err, bwd_tol = {}, {}, {}, {}
        for name, fwd, bwd in (("tc", attention_plain_bf16_tc, attention_backward_plain_bf16_tc),
                               ("fp32", attention_plain, attention_backward_plain)):
            want = fwd(q, k, v, mask, **kw).float()
            fwd_err[name] = (out.detach().float() - want).abs().max().item()
            fwd_tol[name] = tol * max(1.0, want.abs().max().item())
            want = bwd(q, k, v, mask, do, **kw)
            bwd_err[name] = max((g.float() - w.float()).abs().max().item() for g, w in zip(grads, want))
            bwd_tol[name] = tol * max(1.0, max(w.float().abs().max().item() for w in want))
            del want
        qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
        live = None
        if causal or mask is not None:
            live = torch.ones((T, S), dtype=torch.bool, device="cuda")
            live = (live.tril() if causal else live)[None, None]
            live = live if mask is None else live & mask[:, None, None, :]
        sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, attn_mask=live, scale=sm_scale)
        do_s = do.transpose(1, 2).contiguous()
        el_q, el_k = B * T * H * D, B * S * H * D
        pairs = H * attended_pairs(B, T, S, causal, mask, window)
        shape = (f"B{B} T{T} S{S} H{H} D{D} bf16" + (" causal" if causal else "") + (" key mask" if mask is not None
                 else "") + (f" sm_scale {sm_scale:g}" if sm_scale is not None else ""))
        width = head_dim_width(attention_route(dtype, D), D)
        kinds = (("fwd", fwd_rows, fwd_err, fwd_tol,
                  {"plain": lambda: attention_plain_bf16_tc(q, k, v, mask, **kw),
                   "kernel": lambda: flash_attention(q, k, v, mask, **kw),
                   "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                       qs.detach(), ks.detach(), vs.detach(), attn_mask=live, scale=sm_scale)},
                  bound(4.0 * pairs * D, 2 * (2 * el_q + 2 * el_k) + 4 * B * H * T, dtype)),  # q, k, v in; out, lse
                 ("bwd", bwd_rows, bwd_err, bwd_tol,
                  {"plain": lambda: attention_backward_plain_bf16_tc(q, k, v, mask, do, **kw),
                   "kernel": lambda: torch.autograd.grad(out, leaves, do, retain_graph=True),
                   "library": lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True)},
                  # q, k, v, O, dO and lse in; dq, dk, dv out
                  bound(10.0 * pairs * D, 2 * (3 * el_q + 2 * el_k) + 2 * (el_q + 2 * el_k) + 4 * B * H * T, dtype)))
        for kind, rows, err, tols, fns, (bound_ms, bound_by) in kinds:
            t_ = in_turns(fns, reps=5)
            row = {"label": f"{label} {call}", "shape": shape, "route": "sm90", "width": width, "ms": t_["kernel"],
                   "plain_ms": t_["plain"], "library_ms": t_["library"], "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": err, "tol": tols}
            rows.append(row)
            print(f"flash_attention_{kind}_sm90 {label} {call} {shape} (width {width}): max_abs_err "
                  + ", ".join(f"{n} {e:.3e} (tol {tols[n]:.3e})" for n, e in err.items())
                  + f"; flash_attention{' under autograd' if kind == 'bwd' else ''} {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, SDPA{' backward' if kind == 'bwd' else ''} {row['library_ms']:.4f} ms; "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if not all(err[n] <= tols[n] for n in err):
                raise AssertionError(f"flash_attention_{kind}_sm90 {label} {call}: {err} above {tols}")
        del q, k, v, mask, do, leaves, out, grads, qs, ks, vs, sdpa_out, do_s, live
    calls.clear()
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def backbone_train_phase(tmp: Path, report: dict) -> tuple[dict, dict, list[dict], list[dict]]:
    """Training every other backbone family through ``train.main`` (``-cn
    <name>``) on the card, on train_phase's synthesized sets, each from its
    recipe's own ``dataset_type`` (v28's and v29's ``mmrs``: ``tmp /
    "mmrs"``; the others' ``ors``: ``tmp / "ors"``), at full width and its
    recipe's bf16 (``BACKBONE_TRAIN``): v29
    (whisper-small) and v28 (whisper-base), T5 v1.1-base, NWhisper-base and
    moonshine-tiny. For each:

    * a gradient check (:func:`backbone_gradient_check`, on the ``ors``
      tracks) and the two memory probes that pick the micro-batch
      (:func:`backbone_micro_batch`);
    * ``BACKBONE_MICRO_STEPS`` micro-steps at grad_acc ``BACKBONE_GRAD_ACC``:
      every loss finite, ``state.step`` the micro-steps run, two updates,
      the published widths in bf16, and a B and a C launched a covered call
      (whisper_abs: every encoder self, decoder self and cross call; T5:
      the cross calls; nGPT at sm_scale 1.0 and moonshine at D 36 padded
      to 64: every call), nothing on the fp32 route and no fused mel;
    * the final checkpoint restored into a fresh state with equal
      parameters, step and update count;
    * B and C at the family's calls (:func:`backbone_attention`).

    Prints seconds a micro-step, tokens per second, peak GiB and MFU beside
    the card. Returns the training launches (a main path), the checks'
    launches, and B's and C's rows."""
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import CheckpointManager, batch_tokens, card_line, step_flops
    from mapperatorinator_tpu_torch.train.optim import build_optimizer
    from mapperatorinator_tpu_torch.train.step import TrainState, named_flax_params

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    ors, work, record = tmp / "ors", tmp / "backbones", {}
    work.mkdir()
    card = card_line()
    print(f"backbone training cuts: {BACKBONE_MICRO_STEPS} micro-steps at grad_acc {BACKBONE_GRAD_ACC} (two updates) "
          f"of the recipes' grad_acc 8 (v28, t5_base, nwhisper_base, moonshine_tiny) and 32 (v29); warmup_steps 1 of "
          f"10 000 (a cosine decay needs steps after its warmup); no eval; the recipe's dataset_type on the "
          f"synthesized sets (v28's and v29's mmrs, the others' ors); the recipe's micro-batch 128 where the reckoned "
          f"peak fits {BACKBONE_MEMORY_SHARE:g} of the card; seeded random weights; widths and depths as published")
    launches_total = {k: 0 for k in attention_launches()}
    checks_total = dict(launches_total)
    fwd_rows, bwd_rows = [], []
    for name, (label, widths, calls_per_forward) in BACKBONE_TRAIN.items():
        t_family = time.perf_counter()
        # the data pipeline draws its augmentations from random and np.random, as the JAX one does: seeded, so that
        # the checks' inputs repeat from run to run
        random.seed(0)
        np.random.seed(0)
        args = load_train_config(name)
        probed = backbone_gradient_check(label, name, data_overrides(ors) + [
            f"optim.batch_size={BACKBONE_PROBE_BATCH}", "dataloader.num_workers=0"], calls_per_forward)
        batch, reckoning = backbone_micro_batch(label, args.optim.batch_size, probed)
        f_rows, b_rows = backbone_attention(label, probed.pop("calls"))
        fwd_rows += f_rows
        bwd_rows += b_rows
        checks_total = {k: checks_total[k] + probed["launches"][k] for k in checks_total}

        ckpt, logs = work / f"{name}_ckpt", work / f"{name}_logs"
        data = mmrs_overrides(tmp / "mmrs") if args.data.dataset_type == "mmrs" else data_overrides(ors)
        overrides = train_overrides(data, ckpt, batch, BACKBONE_GRAD_ACC, BACKBONE_MICRO_STEPS) + [
            "optim.warmup_steps=1"]
        steps = []

        def describe(state, batch_):
            return {"rows": int(batch_["frames"].shape[0]), "tokens": batch_tokens(batch_, state.model.cfg),
                    "flops": step_flops(state.model, batch_, state.model.cfg)}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_attention_launches()
        fused_mel.launches = 0
        t0 = time.perf_counter()
        with timed_steps(train_main, "make_train_step", steps, describe):
            state = train_main.main(["-cn", name, *overrides], log_dir=str(logs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = attention_launches()
        logged = metrics_steps(logs)
        check_full_width(state.model, widths)
        b = state.model.cfg.backbone
        if b.dtype != torch.bfloat16 or state.step != BACKBONE_MICRO_STEPS or len(logged) != BACKBONE_MICRO_STEPS \
                or len(steps) != BACKBONE_MICRO_STEPS \
                or state.optimizer.count != BACKBONE_MICRO_STEPS // BACKBONE_GRAD_ACC:
            raise AssertionError(f"{label}: dtype {b.dtype}, step {state.step}, {len(logged)} steps logged, "
                                 f"{len(steps)} timed, {state.optimizer.count} updates")
        if not all(math.isfinite(r["train/loss"]) for r in logged):
            raise AssertionError(f"{label}: a training loss is not finite: {[r['train/loss'] for r in logged]}")
        want = {k: 0 for k in launches}
        want["flash_attention_fwd_sm90"] = want["flash_attention_bwd_sm90"] = calls_per_forward * BACKBONE_MICRO_STEPS
        if launches != want or fused_mel.launches:
            raise AssertionError(f"{label}: the micro-steps launched {launches} and {fused_mel.launches} fused mel, "
                                 f"not {want} and 0")
        launches_total = {k: launches_total[k] + launches[k] for k in launches_total}

        args = load_train_config(name, overrides)
        fresh, _, _ = train_main.build_model_and_data(args, torch.device("cuda"))
        t1 = time.perf_counter()
        restored = CheckpointManager(ckpt).restore(TrainState(0, fresh, build_optimizer(args, named_flax_params(fresh))))
        restore_s = time.perf_counter() - t1
        trained = dict(state.model.named_parameters())
        same = all(torch.equal(p, trained[n]) for n, p in restored.model.named_parameters())
        if restored.step != state.step or not same or restored.optimizer.count != state.optimizer.count:
            raise AssertionError(f"{label}: the checkpoint does not restore the trained state")
        n_params = sum(p.numel() for p in state.model.parameters())
        del fresh, restored, state, trained
        gc.collect()
        torch.cuda.empty_cache()

        for s_ in steps:
            s_["tokens_per_s"] = s_["tokens"] / s_["s"]
            s_["mfu"] = s_["flops"] / (PEAK_FLOPS[torch.bfloat16] * s_["s"])
        record[name] = {"label": label, "batch": batch, "reckoning": reckoning, "check": probed["check"],
                        "peaks_probed_gib": {r: p / 2**30 for r, p in probed["peaks"].items()}, "params": n_params,
                        "wall_s": wall, "peak_mem_gib": peak, "launches": launches, "steps": steps, "logged": logged,
                        "restore_s": restore_s, "family_s": time.perf_counter() - t_family}
        print(f"backbone training {label} ({n_params / 1e6:.1f} M parameters), micro-batch {batch}: "
              f"{BACKBONE_MICRO_STEPS} micro-steps in {wall:.1f} s (model build, data and the final checkpoint "
              f"included), losses {[round(r['train/loss'], 4) for r in logged]}, launches {launches}, peak "
              f"{peak:.2f} GiB; checkpoint restored equal in {restore_s:.2f} s; the family "
              f"{record[name]['family_s']:.1f} s ({card})")
        for i, s_ in enumerate(steps, 1):
            print(f"  micro-step {i}: {s_['rows']} rows, {s_['s']:.3f} s to the step's synchronize "
                  f"({logged[i - 1]['train/seconds_per_step']:.3f} s between the loop's logs, data included), "
                  f"{s_['tokens_per_s']:.0f} tokens/s (encoder positions + decoder positions), MFU {s_['mfu']:.4f} "
                  f"of 989 TFLOP/s bf16 ({card})")
    record["phase_s"] = time.perf_counter() - started
    report["backbone_train"] = record
    print(f"backbone training phase: {record['phase_s']:.1f} s, launches {launches_total} (gradient checks and memory "
          f"probes {checks_total})")
    return launches_total, checks_total, fwd_rows, bwd_rows


# multi-process training (parallel_phase): v32 at full width and bf16 through train.main with the parallel.* keys
# on the one card. (a) one NCCL rank at the recipe's micro-batch 32 and grad_acc 1 (each micro-step an update), 2
# micro-steps; (b) two ranks sharing the card over gloo, spawned as processes, micro-batch 8 a rank (global 16) at
# the recipe's grad_acc 2, 4 micro-steps (2 updates); (c) FSDP (parallel.fsdp_axis=data) as (a), then as (b) where
# gloo's reduce-scatter takes CUDA tensors. One update on a fixed seeded batch of PARALLEL_CHECK_BATCH rows through
# plain attention, without a process group and under DDP, shows what the group changes.
PARALLEL_BATCH, PARALLEL_STEPS = 32, 2
PARALLEL_RANKS, PARALLEL_RANK_BATCH, PARALLEL_GRAD_ACC, PARALLEL_RANK_STEPS = 2, 8, 2, 4
# (c) on two ranks, run beside (b): 4 rows a rank and 2 micro-steps (one update), cut from (b)'s 8 and 4 to fit
# the card beside (b) and the whole run inside its limit (Muon gathers each sharded gradient matrix whole through
# gloo, which copies it through the host)
PARALLEL_FSDP_RANK_BATCH, PARALLEL_FSDP_RANK_STEPS = 4, 2
PARALLEL_CHECK_BATCH = 4
PARALLEL_RANK_TIMEOUT = 600
# (a), (b) and (c) at 6 + 6 layers, cut from 12 + 12: their checkpoints, with (d)'s and (g)'s, put the run past the
# machine's limit on bytes written to its disk (45 GiB)
PARALLEL_DEPTH = 6
PARALLEL_CUT = [f"model.overwrite.encoder_layers={PARALLEL_DEPTH}", f"model.overwrite.decoder_layers={PARALLEL_DEPTH}"]
PARALLEL_ATTN_PER_STEP = 3 * PARALLEL_DEPTH
# FSDP's gathered parameters against DDP's after the same updates, their difference relative to their norm, all
# together and each matrix: the bf16 attention bar (ATTN_TOL)
PARALLEL_PARAM_TOL = 2e-2
# (d) tensor-parallel training on the two ranks after (c): 4 rows (the same on both ranks), 2 micro-steps at grad_acc 2
# (one update), the 12 heads split 6 a rank; cut from 8 rows at grad_acc 1, which took 16.1 and 13.5 s a micro-step
# (the activations' all-reduces and Muon's gathers through gloo) and the run past its limit. (e) and (f) greedy
# decode on request 3's first window, the first 8 steps' scores compared; 36 all-reduces a decode step (wo, the
# cross wo and fc2 of 12 layers); (g) adafactor
TENSOR_ROWS, TENSOR_STEPS, TENSOR_GRAD_ACC, TENSOR_HEADS = 4, 2, 2, 6
TENSOR_DECODE_STEPS, TENSOR_LOGIT_STEPS, TENSOR_REDUCES_PER_STEP = 128, 8, 36
ADAFACTOR_STEPS = 2
BF16_LOSS_REL = 0.06  # tests/test_torch_bf16_parity.py's bar (REL_TOL), the loss of 2 ranks against one process's


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def param_checksums(model) -> list[int]:
    """Each parameter's fp32 bit patterns summed as integers (the whole
    parameter, in flax order, where it is sharded: a collective): equal
    lists mean parameters equal bit for bit, but for a collision."""
    from mapperatorinator_tpu_torch.parallel.sharding import gathered

    return [int(gathered(p.detach(), like=p).contiguous().view(torch.int32).sum(dtype=torch.int64))
            for p in model.parameters()]


@contextlib.contextmanager
def attention_heads(heads: set):
    """A context in which each ``flash_attention`` call of the model adds its
    head count to ``heads``."""
    from mapperatorinator_tpu_torch.models import transformer

    flash = transformer.flash_attention

    def counted(q, *args, **kwargs):
        heads.add(int(q.shape[2]))
        return flash(q, *args, **kwargs)

    transformer.flash_attention = counted
    try:
        yield
    finally:
        transformer.flash_attention = flash


def tensor_mesh(size: int):
    """A ``DeviceMesh`` of one ``tensor`` axis over the process group."""
    from mapperatorinator_tpu_torch.parallel import make_global_mesh

    return make_global_mesh(types.SimpleNamespace(mesh_shape=[size], axis_names=["tensor"]), "cuda")


def tensor_decode(model, vocab, inputs: Path, mesh=None, count: bool = False) -> dict:
    """``TENSOR_DECODE_STEPS`` greedy steps of ``model`` (request 3's fp32
    v32 checkpoint, on the CPU) on request 3's first window and prompt
    (``inputs``), through ``DecodeEngine`` on the card: whole, or placed on
    ``mesh``'s tensor axis. The tokens, the end, the first ``TENSOR_LOGIT_STEPS``
    steps' scores, the graphs captured, whether the engine replays graphs,
    the B launches (the encoder's) and, with ``count``, the tensor regions'
    all-reduces issued inside a capture and outside one."""
    from mapperatorinator_tpu_torch.decode import DecodeEngine
    from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline, get_eos_token_ids
    from mapperatorinator_tpu_torch.parallel import shard_params
    from mapperatorinator_tpu_torch.parallel import tensor as tensor_module

    model = model.to("cuda").eval()
    if mesh is not None:
        shard_params(model, mesh, tensor_axis="tensor")
    with np.load(inputs) as f:
        frames, ids = f["frames"], f["ids"]
    P = ids.shape[1]
    engine = DecodeEngine(model, P + TENSOR_DECODE_STEPS, vocab.pad_id, device="cuda")
    reduces = {"captured": 0, "eager": 0}
    reduce = tensor_module.all_reduce_sum

    def counted(x, group):
        reduces["captured" if torch.cuda.is_current_stream_capturing() else "eager"] += 1
        return reduce(x, group)

    if count:
        tensor_module.all_reduce_sum = counted
    heads: set = set()
    reset_attention_launches()
    steps = []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with attention_heads(heads):
            enc = engine.encode_with_cond(frames)
        tokens, end = engine.generate(enc, ids, build_logits_pipeline(vocab, do_sample=False),
                                      get_eos_token_ids(vocab), seed=0, step_logits=steps)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        tensor_module.all_reduce_sum = reduce
    out = {"tokens": tokens, "end": end, "prompt": P, "seconds": seconds, "captures": engine.captures,
           "graphed": engine.graphable, "launches": attention_launches(), "heads": sorted(heads),
           "scores": torch.stack(steps[:TENSOR_LOGIT_STEPS]).cpu().numpy(), "reduces": reduces}
    del engine, model, enc
    gc.collect()
    torch.cuda.empty_cache()
    return out


def rank_train(job: dict, dist) -> dict:
    """A train job of :func:`parallel_rank`: ``train.main`` on ``job["argv"]``,
    each micro-step's seconds and launches and, after each update, the
    parameters' checksums; with ``first_update``, the full state dict after
    the first update, which rank 0 writes there."""
    from torch.distributed.tensor import DTensor

    from mapperatorinator_tpu_torch.parallel import process_index
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import full_state_dict

    # the data pipeline draws its augmentations from random and np.random: seeded alike in every rank and the parent
    random.seed(0)
    np.random.seed(0)
    steps = []
    make = train_main.make_train_step

    def factory(*a, **k):
        step = make(*a, **k)

        def run(state, batch):
            count, before = state.optimizer.count, attention_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(state, batch)
            torch.cuda.synchronize()
            after = attention_launches()
            record = {"s": time.perf_counter() - t0, "launches": {k_: after[k_] - before[k_] for k_ in after}}
            if state.optimizer.count != count:
                record["checksums"] = param_checksums(state.model)
                if job.get("first_update") and state.optimizer.count == 1:
                    full = {n: t.detach().float().cpu() for n, t in full_state_dict(state.model).items()}
                    if process_index() == 0:
                        torch.save(full, job["first_update"])
                    del full
            steps.append(record)
            return out

        return run

    heads: set = set()
    started = time.perf_counter()
    train_main.make_train_step = factory
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    try:
        with attention_heads(heads):
            state = train_main.main(job["argv"], log_dir=job["log_dir"])
    finally:
        train_main.make_train_step = make
    result = {"rank": process_index(), "backend": dist.get_backend(), "steps": steps, "step": state.step,
              "updates": state.optimizer.count, "final": param_checksums(state.model),
              "launches": attention_launches(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "heads": sorted(heads), "sharded": sum(isinstance(p, DTensor) for p in state.model.parameters()),
              "job_s": time.perf_counter() - started}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return result


def rank_decode(job: dict, dist) -> dict:
    """A decode job of :func:`parallel_rank`: :func:`tensor_decode` on a
    tensor axis over the job's group, its scores written to
    ``job["scores"]`` by rank 0."""
    from mapperatorinator_tpu_torch.models.io import load_checkpoint
    from mapperatorinator_tpu_torch.parallel import maybe_initialize, process_index

    started = time.perf_counter()
    maybe_initialize(types.SimpleNamespace(coordinator_address=job["address"], num_processes=job["world"],
                                           process_id=job["rank"]), "cuda")
    torch.cuda.reset_peak_memory_stats()
    out = tensor_decode(*load_checkpoint(job["checkpoint"]), Path(job["inputs"]), mesh=tensor_mesh(job["world"]))
    if process_index() == 0:
        np.save(job["scores"], out["scores"])
    return {"rank": process_index(), "backend": dist.get_backend(), "tokens": out["tokens"].tolist(),
            "end": out["end"], "seconds": out["seconds"], "captures": out["captures"], "graphed": out["graphed"],
            "launches": out["launches"], "heads": out["heads"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "job_s": time.perf_counter() - started}


def parallel_rank(jobs: list, probe: bool) -> None:
    """One process of ``parallel_phase``'s spawned runs: it runs ``jobs`` in
    turn, each in a process group of its own (``train``: :func:`rank_train`,
    which joins through ``train.main``'s ``parallel.*`` keys; ``decode``:
    :func:`rank_decode`), and prints each job's result as one
    ``PARALLEL_RANK <label>`` JSON line. With ``probe``, it first checks
    that gloo's reduce-scatter and all-gather take CUDA tensors, and where
    they do not prints ``GLOO_CUDA_UNSUPPORTED`` and stops."""
    import torch.distributed as dist

    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.parallel import maybe_initialize, world_size

    if probe:
        maybe_initialize(load_train_config("v32", jobs[0]["argv"][2:]).parallel, "cuda")
        try:
            whole = torch.arange(2.0 * world_size(), device="cuda")
            part = torch.empty(2, device="cuda")
            dist.reduce_scatter_tensor(part, whole)
            dist.all_gather_into_tensor(whole, part)
            torch.cuda.synchronize()
        except RuntimeError as err:
            print("GLOO_CUDA_UNSUPPORTED " + json.dumps(str(err)[:400]), flush=True)
            dist.destroy_process_group()
            return
    for job in jobs:
        result = (rank_train if job["kind"] == "train" else rank_decode)(job, dist)
        print(f"PARALLEL_RANK {job['label']} " + json.dumps(result), flush=True)
        dist.destroy_process_group()


def start_ranks(label: str, jobs_of, out_dir: Path, probe: bool = False) -> list:
    """Start :func:`parallel_rank` as ``PARALLEL_RANKS`` processes on the card
    (``jobs_of(rank)`` each), their output to files in ``out_dir``;
    :func:`collect_ranks` waits for them."""
    import subprocess

    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.parallel_rank(json.loads(sys.argv[2]), sys.argv[3] == '1')")
    started = []
    for rank in range(PARALLEL_RANKS):
        out, err = (out_dir / f"{label}_rank{rank}.{kind}" for kind in ("out", "err"))
        with open(out, "w") as out_f, open(err, "w") as err_f:
            proc = subprocess.Popen([sys.executable, "-X", "faulthandler", "-c", code, str(REPO),
                                     json.dumps(jobs_of(rank)), "1" if probe else "0"],
                                    cwd=REPO, stdout=out_f, stderr=err_f, text=True)
        started.append((proc, out, err))
    return started


def stop_ranks(started: list) -> None:
    for proc, _, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def collect_ranks(label: str, started: list) -> dict | None:
    """Wait for :func:`start_ranks`' processes and return {job label: each
    rank's result}, or None where the probe found gloo refusing CUDA
    tensors."""
    results: dict = {}
    for rank, (proc, out, err) in enumerate(started):
        proc.wait(timeout=PARALLEL_RANK_TIMEOUT)
        text = out.read_text()
        if proc.returncode != 0:
            raise AssertionError(f"{label}: rank {rank} exited {proc.returncode}:\n{text[-2000:]}\n"
                                 f"{err.read_text()[-4000:]}")
        if any(line.startswith("GLOO_CUDA_UNSUPPORTED ") for line in text.splitlines()):
            print(f"{label}: gloo's reduce-scatter does not take CUDA tensors on this machine "
                  f"({text.split('GLOO_CUDA_UNSUPPORTED ', 1)[1].splitlines()[0]}); the 2-rank FSDP run stays the "
                  f"CPU tests'")
            return None
        for line in text.splitlines():
            if line.startswith("PARALLEL_RANK "):
                job, payload = line[len("PARALLEL_RANK "):].split(" ", 1)
                results.setdefault(job, []).append(json.loads(payload))
    if not results or any(len(r) != len(started) for r in results.values()):
        raise AssertionError(f"{label}: a rank printed no result: {sorted(results)}")
    return results


def check_ranks(label: str, ranks: list, micro_steps: int, updates: int, backend: str,
                per_step: int = ATTN_PER_STEP) -> dict:
    """Every rank ran ``micro_steps`` micro-steps and ``updates`` updates on
    ``backend``, launched B and C (bf16) once a covered call (``per_step``
    a micro-step) and nothing else, and held parameters equal bit for bit
    to every other rank's after every update. Returns the ranks' launches
    summed."""
    want = {k: 0 for k in attention_launches()}
    want["flash_attention_fwd_sm90"] = want["flash_attention_bwd_sm90"] = per_step * micro_steps
    for r in ranks:
        if (r["step"], r["updates"], r["backend"], r["launches"]) != (micro_steps, updates, backend, want):
            raise AssertionError(f"{label}: rank {r['rank']} ran {r['step']} micro-steps, {r['updates']} updates on "
                                 f"{r['backend']}, launched {r['launches']}; want {micro_steps}, {updates}, "
                                 f"{backend}, {want}")
    sums = [[s["checksums"] for s in r["steps"] if "checksums" in s] for r in ranks]
    if len(sums[0]) != updates or any(s != sums[0] for s in sums) or any(r["final"] != ranks[0]["final"]
                                                                       for r in ranks):
        raise AssertionError(f"{label}: the ranks' parameters differ after an update")
    return {k: sum(r["launches"][k] for r in ranks) for k in want}


def without_key_biases(name: str, t: torch.Tensor) -> torch.Tensor:
    """A parameter less the key part of the fused qkv / kv biases, whose exact
    gradient is zero (softmax ignores a shift shared by a row's logits): both
    runs update them from rounding noise (``tests/test_torch_train.py``)."""
    if name.endswith("wqkv.bias"):
        inner = t.shape[0] // 3
        return torch.cat([t[:inner], t[2 * inner:]])
    if name.endswith("wkv.bias"):
        return t[t.shape[0] // 2:]
    return t


def relative_differences(got: dict, want: dict) -> tuple[float, list, list]:
    """The norm of the parameters' difference relative to theirs, all
    together, and (a tensor's difference relative to its norm, its name)
    for the matrices and for the vectors, the largest first; the key
    biases' key parts left out."""
    rows, diff, size = [], 0.0, 0.0
    for n, w in want.items():
        a, b = without_key_biases(n, got[n].float()), without_key_biases(n, w.float())
        d, z = (a - b).norm().item(), b.norm().item()
        diff, size = diff + d * d, size + z * z
        rows.append((d / max(z, 1e-30), n, w.dim()))
    rows.sort(reverse=True)
    return (diff / size) ** 0.5, [r[:2] for r in rows if r[2] >= 2], [r[:2] for r in rows if r[2] < 2]


def parallel_phase(tmp: Path, report: dict) -> tuple[dict, dict, list[dict], list[dict]]:
    """Multi-process training through ``train.main`` with the
    ``parallel.*`` keys, v32 at full width and bf16 on train_phase's set
    (``tmp / "ors"``), on the one card:

    * a fixed seeded batch of ``PARALLEL_CHECK_BATCH`` rows, one update
      through plain attention (C adds dq with atomics, in no fixed order, so
      two updates through the kernels differ) without a process group and
      under DDP at world size 1 (after (a) has made the group): equal bit
      for bit;
    * (a) one rank on NCCL (``parallel.coordinator_address`` with
      ``num_processes=1``): the backend, 2 micro-steps at micro-batch 32,
      grad_acc 1, one B and C a covered call;
    * (c) the same under ``parallel.fsdp_axis=data``: the parameters sharded,
      gathered after the 2 updates within ``PARALLEL_PARAM_TOL`` of (a)'s,
      the checkpoint restored unsharded into one process equal to them;
    * (b) two ranks sharing the card over gloo, spawned
      (:func:`parallel_rank`), 4 micro-steps at 8 rows a rank and grad_acc
      2: parameters bit-equal across ranks after every update, B and C on
      every call of every rank, the first global loss within
      ``BF16_LOSS_REL`` of one process's on the same 16 rows, rank 0's
      checkpoint restored here equal to its parameters; the card's compute
      mode must let two processes share it;
    * (c) again as (b) under FSDP, run beside it (four processes on the
      card), ``PARALLEL_FSDP_RANK_BATCH`` rows a rank and
      ``PARALLEL_FSDP_RANK_STEPS`` micro-steps, where gloo's reduce-scatter
      takes CUDA tensors (a probe says; where it does not, the phase prints
      that);
    * (e) the fp32 v32 model of request 3's checkpoint (``tmp /
      "v32-checkpoint"``) on a tensor axis of 1 over one NCCL rank:
      ``TENSOR_DECODE_STEPS`` graphed greedy steps of request 3's first
      window (``tmp / "tensor_decode.npz"``), the graphs capturing the
      regions' all-reduces, tokens equal to the whole engine's;
    * (d) in (c)'s processes after it: ``train.main`` at tensor 2 over gloo,
      ``TENSOR_ROWS`` rows on both ranks, ``TENSOR_STEPS`` micro-steps at
      ``TENSOR_GRAD_ACC``: B and C once a covered call at ``TENSOR_HEADS``
      heads, parameters bit-equal across ranks after the update, the first
      loss within ``BF16_LOSS_REL`` of one process's, the gathered
      parameters after the first update within ``PARALLEL_PARAM_TOL`` of one
      process's update on the same rows, rank 0's checkpoint restored
      unsharded;
    * (f) in (b)'s processes after it: (e)'s decode at tensor 2 over gloo,
      eager (the engine's rule), tokens against (e)'s, the first
      ``TENSOR_LOGIT_STEPS`` steps' scores within ``ENC_TOL`` of the whole
      engine's;
    * (g) ``optim.name=adafactor`` through ``train.main`` on one card,
      ``ADAFACTOR_STEPS`` micro-steps at batch 32, peak GiB beside Muon's
      (``report["training"]``);
    * B and C at a rank's heads of (c)'s 8-row calls, timed beside SDPA.

    Prints seconds a micro-step, peak GiB, the backend and the B and C
    launches of every rank beside the card. Returns the main paths'
    launches (the train.main runs and decodes, every rank's), the
    fixed-batch checks' and the rank-heads rows of B and C."""
    import subprocess

    import torch.distributed as dist

    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.models.io import load_checkpoint
    from mapperatorinator_tpu_torch.osu import BeatmapParser, build_vocabulary
    from mapperatorinator_tpu_torch.parallel import maybe_initialize, replicate
    from mapperatorinator_tpu_torch.parallel.sharding import any_sharded
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import CheckpointManager, card_line, full_state_dict
    from mapperatorinator_tpu_torch.train.optim import build_optimizer
    from mapperatorinator_tpu_torch.train.step import TrainState, make_train_step, named_flax_params, to_device

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    cuda = torch.device("cuda")
    card = card_line()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"parallel: compute mode {mode} ({card})")
    if "exclusive" in mode.lower():
        raise AssertionError(f"the card's compute mode is {mode}: a second process cannot share it")
    ors, work = tmp / "ors", tmp / "parallel"
    ors_data = data_overrides(ors)
    work.mkdir()
    record = {"card": card, "compute_mode": mode, "part_s": {}}
    report["parallel"] = record
    zero = {k: 0 for k in attention_launches()}

    def lap(part: str) -> None:
        record["part_s"][part] = time.perf_counter() - started - sum(record["part_s"].values())
    main_launches, check_launches = dict(zero), dict(zero)

    def add(into: dict, launches: dict) -> None:
        for k in into:
            into[k] += launches[k]

    def bf16_launches(micro_steps: int, per_step: int = ATTN_PER_STEP) -> dict:
        return {**zero, "flash_attention_fwd_sm90": per_step * micro_steps,
                "flash_attention_bwd_sm90": per_step * micro_steps}

    # the fixed batch: one update, twice without a process group
    check_args = load_train_config("v32", data_overrides(ors) + [
        "optim.grad_acc=1", "dataloader.num_workers=0", "dataloader.balancer_buffer_size=0",
        f"optim.batch_size={PARALLEL_CHECK_BATCH}"])
    vocab = build_vocabulary(check_args)
    random.seed(0)
    np.random.seed(0)
    fixed = next(iter(train_main.make_batch_factory(check_args, BeatmapParser(check_args, vocab), vocab)(False)))

    def one_update(ddp: bool) -> tuple[dict, float]:
        # plain attention: C adds dq with atomics, in no fixed order, so two updates through the kernels differ
        model, _, _ = train_main.build_model_and_data(check_args, cuda)
        set_flash(model, False)
        state = TrainState(0, model, build_optimizer(check_args, named_flax_params(model)),
                           replica=replicate(model, cuda) if ddp else None, group=dist.group.WORLD if ddp else None)
        reset_attention_launches()
        state, metrics = make_train_step()(state, fixed)
        loss = metrics["loss"].item()
        if attention_launches() != zero:
            raise AssertionError(f"parallel: the fixed-batch update launched {attention_launches()}")
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        del state, model
        gc.collect()
        torch.cuda.empty_cache()
        return params, loss

    plain, plain_loss = one_update(False)
    lap("fixed batch, the update without a group")

    def run_main(label: str, overrides: list) -> tuple:
        steps = []
        random.seed(0)
        np.random.seed(0)
        logs = work / f"{label}_logs"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_attention_launches()
        t0 = time.perf_counter()
        with timed_steps(train_main, "make_train_step", steps):
            state = train_main.main(["-cn", "v32", *overrides], log_dir=str(logs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = attention_launches()
        if launches != bf16_launches(PARALLEL_STEPS, PARALLEL_ATTN_PER_STEP) or state.step != PARALLEL_STEPS \
                or state.optimizer.count != PARALLEL_STEPS:
            raise AssertionError(f"parallel ({label}): {state.step} micro-steps, {state.optimizer.count} updates, "
                                 f"launched {launches}")
        add(main_launches, launches)
        logged = metrics_steps(logs)
        if not all(math.isfinite(r["train/loss"]) for r in logged):
            raise AssertionError(f"parallel ({label}): a loss is not finite: {logged}")
        run = {"wall_s": wall, "backend": dist.get_backend(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
               "steps": steps, "losses": [r["train/loss"] for r in logged], "launches": launches}
        print(f"parallel ({label}): {PARALLEL_STEPS} micro-steps of {PARALLEL_BATCH} rows on backend {run['backend']} "
              f"in {wall:.1f} s (build, data and the checkpoint included), s a micro-step "
              f"{[round(s['s'], 3) for s in steps]}, peak {run['peak_gib']:.2f} GiB, losses "
              f"{[round(x, 4) for x in run['losses']]}, launches {launches} ({card})")
        return state, run

    port = free_port()
    group = [f"parallel.coordinator_address=127.0.0.1:{port}", "parallel.num_processes=1", "parallel.process_id=0"]
    state, record["a"] = run_main("a, DDP, 1 rank", train_overrides(ors_data, work / "a_ckpt", PARALLEL_BATCH, 1,
                                                                   PARALLEL_STEPS) + group + PARALLEL_CUT)
    if record["a"]["backend"] != "nccl" or state.replica is None:
        raise AssertionError(f"parallel (a): backend {record['a']['backend']}, replica {type(state.replica)}")
    after_a = {n: p.detach().float().cpu() for n, p in state.model.named_parameters()}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lap("a")

    ddp, ddp_loss = one_update(True)
    equal = all(torch.equal(ddp[n], plain[n]) for n in plain)
    off = max((ddp[n].float() - plain[n].float()).abs().max().item() for n in plain)
    record["fixed_batch"] = {"rows": PARALLEL_CHECK_BATCH, "bit_equal": equal, "ddp_vs_plain_max_abs": off,
                             "loss_plain": plain_loss, "loss_ddp": ddp_loss}
    print(f"parallel: one update on a fixed batch of {PARALLEL_CHECK_BATCH} rows, plain attention (C adds dq with "
          f"atomics, in no fixed order, so updates through the kernels differ run to run), under DDP (NCCL, 1 rank) "
          f"against the same without a process group: bit-equal {equal} (largest difference {off:.3e}), loss "
          f"{ddp_loss:.6f} vs {plain_loss:.6f}")
    if not equal:
        raise AssertionError(f"parallel: DDP's update differs from the one without a process group by {off}")
    del plain, ddp
    lap("fixed batch, the update under DDP")

    state, record["c"] = run_main("c, FSDP, 1 rank", train_overrides(ors_data, work / "c_ckpt", PARALLEL_BATCH, 1,
                                                                    PARALLEL_STEPS) + group + PARALLEL_CUT
                                  + ["parallel.fsdp_axis=data"])
    if not any_sharded(state.model.parameters()):
        raise AssertionError("parallel (c): no parameter is sharded")
    gathered_c = {n: t.detach().float().cpu() for n, t in full_state_dict(state.model).items()}
    overall, matrices, vectors = relative_differences(gathered_c, after_a)
    (worst, name) = matrices[0]
    record["c"]["vs_a"] = {"overall": overall, "worst_matrix": matrices[:3], "worst_vector": vectors[:3],
                           "tol": PARALLEL_PARAM_TOL}
    del state
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    args = load_train_config("v32", train_overrides(ors_data, work / "c_ckpt", PARALLEL_BATCH, 1, PARALLEL_STEPS)
                             + PARALLEL_CUT)
    fresh, _, _ = train_main.build_model_and_data(args, cuda)
    restored = CheckpointManager(work / "c_ckpt").restore(TrainState(0, fresh, build_optimizer(
        args, named_flax_params(fresh))))
    same = all(torch.equal(p.detach().float().cpu(), gathered_c[n]) for n, p in restored.model.named_parameters())
    print(f"parallel (c): the gathered parameters after {PARALLEL_STEPS} updates against (a)'s, relative in norm "
          f"(tol {PARALLEL_PARAM_TOL:g}; the key biases' key parts aside, whose exact gradient is 0): all together "
          f"{overall:.3e}, the worst matrix {worst:.3e} ({name}); the worst vector {vectors[0][0]:.3e} "
          f"({vectors[0][1]}; reported, not held: AdamW's normalisation makes a step of either sign of a gradient "
          f"entry that rounding decides, and C adds dq in no fixed order); the checkpoint restored "
          f"unsharded in one process: step {restored.step}, parameters equal {same}")
    if overall > PARALLEL_PARAM_TOL or worst > PARALLEL_PARAM_TOL or not same or restored.step != PARALLEL_STEPS:
        raise AssertionError(f"parallel (c): {record['c']['vs_a']}, restored equal {same}")
    del fresh, restored, after_a, gathered_c
    gc.collect()
    torch.cuda.empty_cache()
    lap("c, 1 rank, and its restore")

    # (e) one NCCL rank with a tensor axis of 1: the graphed decode captures the regions' all-reduces
    ckpt, inputs = tmp / "v32-checkpoint", tmp / "tensor_decode.npz"
    loaded, decode_vocab = load_checkpoint(ckpt)
    single = tensor_decode(copy.deepcopy(loaded), decode_vocab, inputs)
    maybe_initialize(types.SimpleNamespace(coordinator_address=f"127.0.0.1:{free_port()}", num_processes=1,
                                           process_id=0), "cuda")
    e = tensor_decode(loaded, decode_vocab, inputs, mesh=tensor_mesh(1), count=True)
    del loaded
    record["e"] = {k: v for k, v in e.items() if k not in ("tokens", "scores")}
    record["e"].update(backend=dist.get_backend(), tokens_equal=bool(np.array_equal(e["tokens"], single["tokens"])),
                       single_end=single["end"], single_seconds=single["seconds"])
    dist.destroy_process_group()
    add(main_launches, e["launches"])
    per_step = TENSOR_REDUCES_PER_STEP * e["captures"]
    print(f"parallel (e, a tensor axis of 1 on one NCCL rank): {e['end'] - e['prompt']} greedy steps of request 3's "
          f"first window (fp32) in {e['seconds']:.2f} s against {single['seconds']:.2f} s whole; {e['captures']} graph"
          f"(s) captured with {e['reduces']['captured']} all-reduces (want {per_step}: {TENSOR_REDUCES_PER_STEP} a "
          f"step), {e['reduces']['eager']} eager; tokens equal the ungrouped engine's: "
          f"{record['e']['tokens_equal']} (ends {e['end']}, {single['end']}); B {e['launches']} at heads "
          f"{e['heads']} ({card})")
    if not (record["e"]["tokens_equal"] and e["end"] == single["end"] and e["graphed"] and e["captures"] > 0
            and e["reduces"]["captured"] == per_step and record["e"]["backend"] == "nccl"):
        raise AssertionError(f"parallel (e): {record['e']}")
    lap("e, decode on a tensor axis of 1")

    # (b), (c) and (d) on two ranks sharing the card, the four processes at once: (b)'s ranks run (f) after it, (c)'s
    # ranks (d); (c) at PARALLEL_FSDP_RANK_BATCH rows a rank, so that (b)'s 2 x 21.4 GiB and (c)'s 2 x ~11 GiB fit
    # the card together
    runs = {"b": ([], PARALLEL_RANK_BATCH, PARALLEL_RANK_STEPS, PARALLEL_GRAD_ACC),
            "c2": (["parallel.fsdp_axis=data"], PARALLEL_FSDP_RANK_BATCH, PARALLEL_FSDP_RANK_STEPS, PARALLEL_GRAD_ACC),
            "d": (['parallel.axis_names=["tensor"]', f"parallel.mesh_shape=[{PARALLEL_RANKS}]",
                   "parallel.tensor_axis=tensor"], TENSOR_ROWS, TENSOR_STEPS, TENSOR_GRAD_ACC)}

    def global_rows(label: str) -> int:  # the tensor ranks feed the same rows
        _, rows, _, _ = runs[label]
        return rows if label == "d" else PARALLEL_RANKS * rows

    def overrides(label: str) -> list:
        _, _, micro_steps, grad_acc = runs[label]
        return (train_overrides(ors_data, work / f"{label}_ckpt", global_rows(label), grad_acc, micro_steps)
                + (PARALLEL_CUT if label != "d" else []))

    ports = {label: free_port() for label in ("b", "c2", "d", "f")}

    def train_job(label: str, rank: int) -> dict:
        return {"kind": "train", "label": label, "log_dir": str(work / f"{label}_logs"),
                "first_update": str(work / "d_first_update.pt") if label == "d" else None,
                "argv": ["-cn", "v32", *overrides(label), f"parallel.coordinator_address=127.0.0.1:{ports[label]}",
                         f"parallel.num_processes={PARALLEL_RANKS}", f"parallel.process_id={rank}", *runs[label][0]]}

    def decode_job(rank: int) -> dict:
        return {"kind": "decode", "label": "f", "address": f"127.0.0.1:{ports['f']}", "world": PARALLEL_RANKS,
                "rank": rank, "checkpoint": str(ckpt), "inputs": str(inputs), "scores": str(work / "f_scores.npy")}

    # the four processes start first; the one-process references below run beside them
    t0 = time.perf_counter()
    jobs = {"b": lambda rank: [train_job("b", rank), decode_job(rank)],
            "c2": lambda rank: [train_job("c2", rank), train_job("d", rank)]}
    started_ranks = {label: start_ranks(f"parallel_{label}", jobs[label], work, probe=label == "c2")
                     for label in jobs}
    try:
        # one process's loss on each run's first global batch (the ranks' rows together); for (d) also its first
        # update (TENSOR_GRAD_ACC micro-steps, the schedule stretched by the process count, as train.main's); the
        # calls of (c)'s 8 rows, whose first 6 heads are a rank's calls at B 8
        model = None
        one_loss, calls = {}, {}
        for label in runs:
            args = load_train_config("v32", data_overrides(ors) + ["dataloader.num_workers=0",
                                                                   "dataloader.balancer_buffer_size=0",
                                                                   f"optim.batch_size={global_rows(label)}"]
                                     + (PARALLEL_CUT if label != "d" else []))
            random.seed(0)
            np.random.seed(0)
            batches = iter(train_main.make_batch_factory(args, BeatmapParser(args, vocab), vocab)(False))
            first = next(batches)
            if label in ("b", "d"):  # (b) and (c) at the cut depth, (d) at v32's
                del model
                gc.collect()
                torch.cuda.empty_cache()
                model, _, _ = train_main.build_model_and_data(args, cuda)
                model.train()
            reset_attention_launches()
            with torch.no_grad(), (capture_flash_calls(calls) if label == "c2" else contextlib.nullcontext()):
                one_loss[label] = model(**to_device(first, cuda))[1].item()
            add(check_launches, attention_launches())
            if label == "d":
                d_args = load_train_config("v32", overrides("d") + runs["d"][0])
                state = TrainState(0, model, build_optimizer(d_args, named_flax_params(model),
                                                             num_processes=PARALLEL_RANKS))
                reset_attention_launches()
                step = make_train_step()
                for batch in [first] + [next(batches) for _ in range(TENSOR_GRAD_ACC - 1)]:
                    step(state, batch)
                add(check_launches, attention_launches())
                d_one = {n: p.detach().float().cpu() for n, p in model.named_parameters()}
                del state
        del model
        gc.collect()
        torch.cuda.empty_cache()
        collected = {label: collect_ranks(f"parallel ({label})", procs) for label, procs in started_ranks.items()}
    finally:
        for procs in started_ranks.values():
            stop_ranks(procs)
    wall = time.perf_counter() - t0
    lap("b then f, c2 then d: 2 ranks each, at once, beside the one-process references")
    if collected["c2"] is None:
        raise AssertionError("parallel (f): gloo does not take CUDA tensors on this machine: no tensor-parallel "
                             "decode over gloo")
    results = {**collected["b"], **collected["c2"]}
    for label in ("b", "c2", "d"):
        extra, rows, micro_steps, grad_acc = runs[label]
        ranks = results[label]
        add(main_launches, check_ranks(f"parallel ({label})", ranks, micro_steps, micro_steps // grad_acc, "gloo",
                                       ATTN_PER_STEP if label == "d" else PARALLEL_ATTN_PER_STEP))
        losses = [r["train/loss"] for r in metrics_steps(work / f"{label}_logs")]
        rel = abs(losses[0] - one_loss[label]) / abs(one_loss[label])
        same = True
        if label in ("b", "d"):  # rank 0's checkpoint, restored here unsharded
            ckpt_args = load_train_config("v32", overrides(label))
            fresh, _, _ = train_main.build_model_and_data(ckpt_args, cuda)
            restored = CheckpointManager(work / f"{label}_ckpt").restore(TrainState(0, fresh, build_optimizer(
                ckpt_args, named_flax_params(fresh))))
            same = param_checksums(restored.model) == ranks[0]["final"]
            del fresh, restored
            gc.collect()
            torch.cuda.empty_cache()
            lap(f"{label}'s restore")
        record[label] = {"wall_s": wall, "ranks": ranks, "losses": losses, "one_process_loss": one_loss[label],
                         "relative": rel, "restored_equal": same, "rows": rows}
        kind = {"b": "DDP", "c2": "FSDP", "d": "tensor parallel"}[label]
        rows_text = f"{rows} rows, the same on both ranks" if label == "d" else f"{rows} rows a rank"
        print(f"parallel ({label}, {kind}, {PARALLEL_RANKS} ranks sharing the card over gloo, beside the other "
              f"run's two): {micro_steps} micro-steps of {rows_text} at grad_acc {grad_acc}, the runs in {wall:.1f} s "
              f"(start, build, data and the checkpoints included), parameters bit-equal across ranks after every "
              f"update, losses {[round(x, 4) for x in losses]}; the first against one process on the same "
              f"{global_rows(label)} rows {one_loss[label]:.4f} (relative {rel:.2e}, bar {BF16_LOSS_REL:g})"
              + (f"; rank 0's checkpoint restored equal {same}" if label in ("b", "d") else ""))
        for r in ranks:
            print(f"  rank {r['rank']}: backend {r['backend']}, s a micro-step {[round(s['s'], 3) for s in r['steps']]}"
                  f", peak {r['peak_gib']:.2f} GiB, launches {r['launches']} at heads {r['heads']} ({card})")
        if rel > BF16_LOSS_REL or not same:
            raise AssertionError(f"parallel ({label}): loss {losses[0]} against {one_loss[label]}, restored equal "
                                 f"{same}")
    # (d): every covered call of each rank at its 6 heads, and the parameters after the first update
    d_ranks = results["d"]
    if any(r["heads"] != [TENSOR_HEADS] or r["sharded"] == 0 for r in d_ranks):
        raise AssertionError(f"parallel (d): heads {[r['heads'] for r in d_ranks]}, sharded "
                             f"{[r['sharded'] for r in d_ranks]}")
    d_ranks_first = torch.load(work / "d_first_update.pt", weights_only=True)
    overall, matrices, vectors = relative_differences(d_ranks_first, d_one)
    record["d"]["vs_one_process"] = {"overall": overall, "worst_matrix": matrices[:3], "worst_vector": vectors[:3],
                                     "tol": PARALLEL_PARAM_TOL}
    print(f"parallel (d): the gathered parameters after the first update against one process's update on the same "
          f"{TENSOR_GRAD_ACC} x {TENSOR_ROWS} rows, relative in norm (tol {PARALLEL_PARAM_TOL:g}; the key biases' key "
          f"parts aside): all "
          f"together {overall:.3e}, the worst matrix {matrices[0][0]:.3e} ({matrices[0][1]}); the worst vector "
          f"{vectors[0][0]:.3e} ({vectors[0][1]}; reported, not held)")
    if overall > PARALLEL_PARAM_TOL or matrices[0][0] > PARALLEL_PARAM_TOL:
        raise AssertionError(f"parallel (d): {record['d']['vs_one_process']}")
    del d_ranks_first, d_one

    # (f): two gloo ranks at tensor 2, eager, against (e) and the whole engine
    f_ranks = results["f"]
    scores = np.load(work / "f_scores.npy")
    want = single["scores"]
    finite = np.isfinite(want)
    score_err = float(np.abs(scores[finite] - want[finite]).max()) if finite.any() else 0.0
    score_tol = ENC_TOL * float(np.abs(want[finite]).max())
    agree = [float(np.mean(np.asarray(r["tokens"]) == e["tokens"])) for r in f_ranks]
    record["f"] = {"ranks": [{k: v for k, v in r.items() if k != "tokens"} for r in f_ranks], "agree_with_e": agree,
                   "scores_err": score_err, "scores_tol": score_tol,
                   "same_mask": bool(np.array_equal(np.isfinite(scores), finite))}
    for r in f_ranks:
        add(main_launches, r["launches"])
    print(f"parallel (f, a tensor axis of 2 on two gloo ranks, eager): {f_ranks[0]['end'] - e['prompt']} greedy "
          f"steps in {[round(r['seconds'], 2) for r in f_ranks]} s a rank; tokens agree with (e)'s at {agree}; the "
          f"first {TENSOR_LOGIT_STEPS} steps' scores against the whole engine's: largest difference {score_err:.3e} "
          f"(tol {score_tol:.3e}: {ENC_TOL:g} x the largest); B {f_ranks[0]['launches']} a rank at heads "
          f"{f_ranks[0]['heads']}, graphed {f_ranks[0]['graphed']} ({card})")
    if any(r["graphed"] or r["backend"] != "gloo" or r["heads"] != [TENSOR_HEADS] for r in f_ranks) \
            or f_ranks[0]["tokens"] != f_ranks[1]["tokens"] or score_err > score_tol or not record["f"]["same_mask"]:
        raise AssertionError(f"parallel (f): {record['f']}")

    # (g) adafactor, one process at v32's recipe batch
    g_steps = []
    random.seed(0)
    np.random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_attention_launches()
    with timed_steps(train_main, "make_train_step", g_steps):
        state = train_main.main(["-cn", "v32", *train_overrides(ors_data, work / "g_ckpt", PARALLEL_BATCH, 2,
                                                                 ADAFACTOR_STEPS), "optim.name=adafactor"],
                                log_dir=str(work / "g_logs"))
    torch.cuda.synchronize()
    g_launches = attention_launches()
    g_losses = [r["train/loss"] for r in metrics_steps(work / "g_logs")]
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    muon_peak = report.get("training", {}).get("peak_mem_gib")
    record["g"] = {"steps": g_steps, "losses": g_losses, "peak_gib": g_peak, "muon_peak_gib": muon_peak,
                   "launches": g_launches}
    inner = state.optimizer
    while hasattr(inner, "inner"):
        inner = inner.inner
    record["g"]["optimizer"] = type(inner).__name__
    add(main_launches, g_launches)
    print(f"parallel (g, adafactor on one card): {ADAFACTOR_STEPS} micro-steps of {PARALLEL_BATCH} rows at grad_acc "
          f"2, s a micro-step {[round(x['s'], 3) for x in g_steps]}, losses {[round(x, 4) for x in g_losses]}, peak "
          f"{g_peak:.2f} GiB against Muon's {muon_peak if muon_peak is None else round(muon_peak, 2)} GiB (the bf16 "
          f"training phase, the same batch), launches {g_launches} ({card})")
    if g_launches != bf16_launches(ADAFACTOR_STEPS) or state.step != ADAFACTOR_STEPS or state.optimizer.count != 1 \
            or record["g"]["optimizer"] != "Adafactor" or not all(math.isfinite(x) for x in g_losses):
        raise AssertionError(f"parallel (g): {record['g']}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    lap("g, adafactor")

    # B and C at a rank's 6 heads of the calls of (c)'s 8 rows (the one-process forward's inputs, its first 6 heads)
    rank_calls = {(T, S, TENSOR_HEADS, *rest): tuple(x if x is None or x.dim() < 4
                                                     else x[:, :, :TENSOR_HEADS].contiguous() for x in tensors)
                  for (T, S, _, *rest), tensors in calls.items()}
    fwd_rows, bwd_rows = backbone_attention("tensor-parallel v32 (a rank's heads)", rank_calls)
    lap("B and C at a rank's heads")
    record["phase_s"] = time.perf_counter() - started
    print(f"parallel phase: {record['phase_s']:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in record['part_s'].items())}"
          f"), launches {main_launches} (fixed-batch checks {check_launches})")
    return main_launches, check_launches, fwd_rows, bwd_rows


# the single-card tools (tools_phase), at full width on the artifacts earlier phases wrote: the eval harness
# (test.main) on request 3's v32 weights under a config that picks the fused mel, at v32's recipe batch of 32 with
# eval.steps 2 (of 1 000) in each of its two passes; the DiT toy probe at 16 predictions and TOOLS_DIT_STEPS
# sampling steps (of 100) on the auxiliary trainers' DiT-B; the web UI's jobs on a 4 s song
TOOLS_BATCH, TOOLS_EVAL_STEPS = 32, 2
TOOLS_DIT_PREDICTIONS, TOOLS_DIT_STEPS = 16, 25
TOOLS_AUDIO_SECONDS = 4.0
TOOLS_JOB_S = 300  # a web UI job must stream to its end within this
# kernel B at the eval harness's calls (fp32, H 12, D 64, batch 32): (label, B, T, S, causal, key mask)
TOOLS_ATTENTION = [("eval harness encoder self", TOOLS_BATCH, 1024, 1024, False, False),
                   ("eval harness decoder self", TOOLS_BATCH, 2560, 2560, True, True),
                   ("eval harness cross", TOOLS_BATCH, 2560, 1024, False, False)]


def kernel_launches() -> dict:
    """Every kernel's launch count in this process, by kernels-line name."""
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm

    return {**attention_launches(), "fused_mel": fused_mel.launches, "qmm": qmm.launches_gemv,
            "qmm_tc": qmm.launches_tc}


def ui_counted_worker(worker: str, form: dict, q, log_path=None) -> None:
    """The web UI's worker ``web_ui.<worker>``, run in its own process; its
    kernel launches are written beside its log when it ends. (Module-level,
    under ``functools.partial``, so that a spawned process can unpickle it.)"""
    from mapperatorinator_tpu_torch import web_ui

    try:
        getattr(web_ui, worker)(form, q, log_path)
    finally:
        Path(f"{log_path}.launches.json").write_text(json.dumps(kernel_launches()))


def ui_job(url: str, route: str, form: dict) -> dict:
    """POST ``form`` to ``route``, read the job's event stream to its end
    (raising on an ``__ERROR__``), then its worker's launches; returns the
    wall time, the streamed lines, the suggestions and the launches."""
    import urllib.parse
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url + route, data=urllib.parse.urlencode(form).encode(), method="POST")
    with urllib.request.urlopen(req) as resp:
        job = json.loads(resp.read())
    if job.get("status") != "success":
        raise AssertionError(f"{route}: {job}")
    lines, suggestions, done = [], [], False
    with urllib.request.urlopen(f"{url}/stream_output?job_id={job['job_id']}", timeout=TOOLS_JOB_S) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if not line.startswith("data: "):
                continue
            line = line[len("data: "):]
            lines.append(line)
            if line.startswith("__SUGGESTION__"):
                suggestions.append(json.loads(line[len("__SUGGESTION__"):]))
            elif line.startswith("__ERROR__"):
                raise AssertionError(f"{route}: the worker failed: " + "\n".join(lines[-30:]))
            elif line == "__DONE__":
                done = True
                break
    launches_file = Path(f"{job['log_path']}.launches.json")
    deadline = time.perf_counter() + 60
    while not launches_file.exists() and time.perf_counter() < deadline:
        time.sleep(0.2)
    if not (done and launches_file.exists()):
        raise AssertionError(f"{route}: the stream ended without the worker's end: " + "\n".join(lines[-30:]))
    return {"wall_s": time.perf_counter() - t0, "lines": len(lines), "suggestions": suggestions,
            "launches": json.loads(launches_file.read_text()), "log": lines[-3:]}


def tools_phase(tmp: Path, report: dict) -> tuple[dict, list[dict]]:
    """The single-card tools through their entry points on the card, on what
    earlier phases wrote (request 3's v32 checkpoint, the auxiliary trainers'
    DiT-B bundle, the eval phase's CM3P, train_phase's ``ors`` set, requests
    1 and 2's maps and the 20 s song):

    * (a) ``test.main``, the held-out eval harness: v32 (d 768, 12 + 12
      layers, 2 048 frames / 2 560 tokens) from a checkpoint whose config
      picks the fused mel, at batch ``TOOLS_BATCH``, both passes of
      ``TOOLS_EVAL_STEPS`` batches: 36 B launches and one A a batch, then the
      first batch's loss and logits through the kernels against plain
      attention within ``ENC_TOL``;
    * (b) ``dataloading`` ``stats`` over 64 windows and ``audition``;
    * (c) ``push_to_hub --stage-dir`` on the checkpoint with a ``gamemode=1``
      subfolder and one removed mapper: every staged tensor read back equal
      to its source but that mapper's token row, which is 0;
    * (d) ``utils/print_ckpt`` on the staged checkpoint and the DiT bundle;
    * (e) ``utils/dit_test_toy`` (12 B launches a sampling step),
      ``plot_embeddings`` (PCA), ``find_similar_beatmaps`` and
      ``distance_distance``;
    * (f) ``utils/plot_self_similarity`` with CM3P (B launches);
    * (g) ``plot_difficulties`` over the ``ors`` set;
    * (h) the web UI served from a thread: a v32 generation job on a 4 s
      song, then a MaiMod job on its map, each in a spawned worker on the
      card, which must write an ``.osu`` and stream suggestions.

    Then B at the harness's calls (``TOOLS_ATTENTION``). Returns the
    launches (a main path) and B's rows."""
    from mapperatorinator_tpu_torch import dataloading, plot_difficulties, push_to_hub, web_ui
    from mapperatorinator_tpu_torch import test as harness
    from mapperatorinator_tpu_torch.models.io import load_checkpoint
    from mapperatorinator_tpu_torch.models.params import flax_layout, flax_paths
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap
    from mapperatorinator_tpu_torch.train.step import make_eval_step
    from mapperatorinator_tpu_torch.utils import (distance_distance, dit_test_toy, find_similar_beatmaps,
                                                  plot_embeddings, plot_self_similarity, print_ckpt)

    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    work, record, ors, source = tmp / "tools", {}, tmp / "ors", tmp / "v32-checkpoint"
    work.mkdir()
    print(f"tools cuts: the eval harness at eval.steps {TOOLS_EVAL_STEPS} (of 1 000) a pass, the DiT toy probe at "
          f"{TOOLS_DIT_STEPS} sampling steps (of 100); batches, widths and the DiT's 16 predictions as published")

    # (a) the eval harness, on request 3's weights under a config that picks the fused mel (files linked)
    fused = work / "v32-fused-mel"
    fused.mkdir()
    config = json.loads((source / "model_config.json").read_text())
    if config["backbone"]["dtype"] != "float32":
        raise AssertionError(f"request 3's checkpoint computes in {config['backbone']['dtype']}, not fp32")
    config["spectrogram_implementation"] = "pallas"
    (fused / "model_config.json").write_text(json.dumps(config))
    for name in ("params.msgpack", "tokenizer.json"):
        (fused / name).symlink_to(source / name)
    first, make = {}, harness.make_eval_step

    def capturing():
        step = make()

        def eval_step(model, batch):
            first.setdefault("model", model)
            first.setdefault("batch", batch)
            return step(model, batch)

        return eval_step

    argv = ["-cn", "v32", f"checkpoint_path={fused}", *data_overrides(ors), f"optim.batch_size={TOOLS_BATCH}",
            f"eval.steps={TOOLS_EVAL_STEPS}", "optim.grad_acc=1", "dataloader.num_workers=0"]
    harness.make_eval_step = capturing
    torch.cuda.reset_peak_memory_stats()
    fused_mel.launches = 0
    try:
        with contextlib.chdir(work), contextlib.redirect_stdout(io.StringIO()):  # its report tables
            results = counted("test", lambda: harness.main(argv), record)
    finally:
        harness.make_eval_step = make
    record["test"]["launches"]["fused_mel"] = fused_mel.launches
    record["test"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    batches = 2 * TOOLS_EVAL_STEPS
    saved = json.loads((work / "test_results.json").read_text())
    losses = [v for r in results.values() for k, v in r["stats"].items() if k.endswith("/loss")]
    want = {"flash_attention_fwd": ATTN_PER_STEP * batches, "flash_attention_bwd": 0, "flash_attention_fwd_sm90": 0,
            "flash_attention_bwd_sm90": 0, "fused_mel": batches}
    if set(saved) != {"test_noise", "test"} or not losses or not np.isfinite(losses).all() \
            or record["test"]["launches"] != want or first["batch"]["frames"].shape[0] != TOOLS_BATCH:
        raise AssertionError(f"the eval harness: {sorted(saved)}, losses {losses}, launches "
                             f"{record['test']['launches']} (want {want})")
    model, batch = first.pop("model"), first.pop("batch")
    step = make_eval_step()
    loss, logits = step(model, batch)
    set_flash(model, False)
    plain_loss, plain_logits = step(model, batch)
    del model
    err, tol = (logits - plain_logits).abs().max().item(), ENC_TOL * plain_logits.abs().max().item()
    loss_err, loss_tol = abs(loss.item() - plain_loss.item()), ENC_TOL * max(1.0, abs(plain_loss.item()))
    record["test"].update(logits_shape=list(logits.shape), max_abs_err=err, tol=tol, loss_err=loss_err,
                          loss_tol=loss_tol, losses=losses)
    del logits, plain_logits
    torch.cuda.empty_cache()
    print(f"tools (a) test.main: {batches} batches of {TOOLS_BATCH} in {record['test']['wall_s']:.2f} s, peak "
          f"{record['test']['peak_gib']:.2f} GiB, launches {record['test']['launches']}; the first batch through "
          f"the kernels vs plain attention: logits {record['test']['logits_shape']} max_abs_err {err:.3e} (tol "
          f"{tol:.3e} = {ENC_TOL:g} x the largest |logit|), loss {loss_err:.3e} (tol {loss_tol:.3e}); losses "
          + ", ".join(f"{v:.4f}" for v in losses))
    if not (err <= tol and loss_err <= loss_tol):
        raise AssertionError(f"the eval harness's first batch through the kernels disagrees: {err}, {loss_err}")

    # (b) dataloading
    t0 = time.perf_counter()
    loader = ["-cn", "v32", *data_overrides(ors)]
    with contextlib.chdir(work), contextlib.redirect_stdout(io.StringIO()):
        lengths = dataloading.main([*loader, "--mode", "stats", "--limit", "64"])
        auditioned = dataloading.main([*loader, "--mode", "audition"])
    record["dataloading"] = {"wall_s": time.perf_counter() - t0, "windows": len(lengths),
                             "tokens": sum(lengths), "auditioned": len(auditioned)}
    if len(lengths) != 64 or min(lengths) <= 0 or len(auditioned) != 5 \
            or any(wave.open(str(work / p)).getnframes() <= 0 for p in auditioned):
        raise AssertionError(f"dataloading: {lengths}, {auditioned}")
    print(f"tools (b) dataloading: stats over {len(lengths)} windows ({sum(lengths)} tokens, median "
          f"{sorted(lengths)[32]}), {len(auditioned)} auditions in {record['dataloading']['wall_s']:.2f} s")

    # (c) push_to_hub --stage-dir: the checkpoint and a gamemode=1 subfolder (both linked), one removed mapper
    t0 = time.perf_counter()
    hub = work / "hub"
    (hub / "gamemode=1").mkdir(parents=True)
    for name in ("model_config.json", "params.msgpack", "tokenizer.json"):
        (hub / name).symlink_to(source / name)
        (hub / "gamemode=1" / name).symlink_to(source / name)
    source_model, vocab = load_checkpoint(source)
    user = sorted(vocab.mapper_idx)[0]
    row = vocab.encode_mapper_id(user)
    removed_users = push_to_hub.load_removed_users
    push_to_hub.load_removed_users = lambda path=None: [user]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            staged = push_to_hub.main(["-cn", "v32", f"model_path={hub}", "--stage-dir", str(work / "staged")])
    finally:
        push_to_hub.load_removed_users = removed_users
    stage_s = time.perf_counter() - t0
    paths, state = flax_paths(source_model), source_model.state_dict()
    nulled, compared = 0, 0
    for sub in (staged, staged / "gamemode=1"):
        staged_model, staged_vocab = load_checkpoint(sub)
        got = staged_model.state_dict()
        if user in staged_vocab.mapper_idx or set(got) != set(state):
            raise AssertionError(f"{sub}: mapper {user} still indexed, or the tensors differ in name")
        for name, tensor in state.items():
            want_t = flax_layout(tensor, paths[name]).clone()
            if any(s in paths[name] for s in push_to_hub.TOKEN_ROWS):
                if not want_t[row].any():
                    raise AssertionError(f"{paths[name]} row {row} was 0 before staging")
                want_t[row] = 0
                nulled += 1
            if not torch.equal(flax_layout(got[name], paths[name]), want_t):
                raise AssertionError(f"{sub}: {paths[name]} staged unequal")
            compared += 1
        del staged_model
    del source_model
    record["push_to_hub"] = {"stage_s": stage_s, "wall_s": time.perf_counter() - t0, "compared": compared,
                             "nulled_tensors": nulled, "removed_user": user, "row": row}
    if nulled != 2:
        raise AssertionError(f"push_to_hub: {nulled} token tables nulled, not 2")
    print(f"tools (c) push_to_hub: two checkpoints staged in {stage_s:.2f} s, then read back: all {compared} "
          f"tensors equal to the source but mapper {user}'s token row {row}, 0 in both decoder tables "
          f"({record['push_to_hub']['wall_s']:.2f} s)")

    # (d) print_ckpt on the staged checkpoint and the DiT bundle
    t0 = time.perf_counter()
    dit = tmp / "aux" / "dit" / "final"
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for target in (staged, dit):
            if print_ckpt.main([str(target)]) != 0:
                raise AssertionError(f"print_ckpt {target}")
    summaries = [line for line in out.getvalue().splitlines() if line.startswith("[")]
    record["print_ckpt"] = {"wall_s": time.perf_counter() - t0, "summaries": summaries}
    if len(summaries) != 2 or not all(line.startswith("[native]") for line in summaries):
        raise AssertionError(f"print_ckpt: {summaries}")
    print(f"tools (d) print_ckpt in {record['print_ckpt']['wall_s']:.2f} s: " + "; ".join(summaries))

    # (e) the DiT tools on the auxiliary trainers' DiT-B
    with contextlib.redirect_stdout(io.StringIO()):
        toy = counted("dit_test_toy", lambda: dit_test_toy.run(dit_test_toy.parse_args(
            ["--ckpt", str(dit), "--num-predictions", str(TOOLS_DIT_PREDICTIONS),
             "--num-sampling-steps", str(TOOLS_DIT_STEPS), "--seed", "0"])), record)
    record["dit_test_toy"]["results"] = toy
    want = {"flash_attention_fwd": DIT_CALLS * TOOLS_DIT_STEPS, "flash_attention_bwd": 0,
            "flash_attention_fwd_sm90": 0, "flash_attention_bwd_sm90": 0}
    if record["dit_test_toy"]["launches"] != want or not all(np.isfinite(r["mean_err_px"]) for r in toy):
        raise AssertionError(f"dit_test_toy: {toy}, launches {record['dit_test_toy']['launches']} (want {want})")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        points = plot_embeddings.run(plot_embeddings.parse_args(
            ["--ckpt", str(dit), "--method", "pca", "--out", str(work / "embeddings.png")]))
        neighbours = find_similar_beatmaps.run(find_similar_beatmaps.parse_args(["--ckpt", str(dit), "--idx", "0",
                                                                                 "-k", "5"]))
    embed_s = time.perf_counter() - t0
    real = Path(report["requests"][0]["osu_path"])
    other = Path(report["requests"][1]["osu_path"])
    (work / "distance").mkdir()
    (work / "distance" / "request2.osu").write_text(other.read_text())
    (work / "distance" / "request1.osu").write_text(real.read_text())
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        distances = distance_distance.run(types.SimpleNamespace(ref_beatmap=str(real),
                                                                beatmap=str(work / "distance"), out_dir=str(work)))
    record["dit_tools"] = {"embed_s": embed_s, "distance_s": time.perf_counter() - t0, "points": list(points.shape),
                           "neighbours": neighbours, "distances": {r["name"]: (r["mse"], r["mae"]) for r in distances},
                           "distance_lines": out.getvalue().splitlines()}
    dist = [d for _, d in neighbours]
    if points.shape[1] != 2 or not np.isfinite(points).all() or len(neighbours) != 5 or dist != sorted(dist) \
            or len(distances) not in (1, 2) or min(r["mse"] for r in distances) != 0.0 \
            or not np.isfinite([r["mse"] for r in distances]).all():
        raise AssertionError(f"the DiT tools: {points.shape}, {neighbours}, {record['dit_tools']['distances']}")
    print(f"tools (e) dit_test_toy: {toy[0]['toy']} at {TOOLS_DIT_PREDICTIONS} predictions, "
          f"{TOOLS_DIT_STEPS} steps: mean error {toy[0]['mean_err_px']} px (random weights: meaningless), "
          f"{record['dit_test_toy']['wall_s']:.2f} s, B launches {want['flash_attention_fwd']}; plot_embeddings "
          f"{points.shape[0]} classes to 2-D by PCA and find_similar_beatmaps {neighbours[:2]}... in {embed_s:.2f} s; "
          f"distance_distance from request 1's map: " + "; ".join(record["dit_tools"]["distance_lines"]))

    # (f) plot_self_similarity with CM3P: request 1's map and the map calc_fid took as its generation, the song
    generated, generated_source = eval_generation(tmp, report)
    with contextlib.redirect_stdout(io.StringIO()):
        ssm = counted("plot_self_similarity", lambda: plot_self_similarity.main(
            [str(real), str(generated), str(tmp / "song.wav"), "--cm3p", str(tmp / "cm3p")]), record)
    launched = record["plot_self_similarity"]["launches"]
    record["plot_self_similarity"].update(ssm_rmse=ssm["ssm_rmse"], windows=[len(ssm["real"]), len(ssm["generated"])],
                                          generated=generated_source)
    if not (np.isfinite(ssm["ssm_rmse"]) and launched["flash_attention_fwd"] > 0
            and launched["flash_attention_fwd"] == sum(launched.values())):
        raise AssertionError(f"plot_self_similarity: {ssm['ssm_rmse']}, launches {launched}")
    print(f"tools (f) plot_self_similarity with CM3P on request 1's map and {generated_source}: "
          f"{record['plot_self_similarity']['windows']} windows, ssm_rmse {ssm['ssm_rmse']:.4f}, "
          f"{record['plot_self_similarity']['wall_s']:.2f} s, B launches {launched['flash_attention_fwd']}")

    # (g) plot_difficulties over the ors set
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        stars = plot_difficulties.main([str(ors), "0", str(ORS_TRACKS)])
    record["plot_difficulties"] = {"wall_s": time.perf_counter() - t0, "maps": len(stars),
                                   "stars": [min(stars), float(np.median(stars)), max(stars)]}
    if len(stars) != ORS_TRACKS * ORS_MAPS or not all(s > 0 for s in stars):
        raise AssertionError(f"plot_difficulties: {stars}")
    print(f"tools (g) plot_difficulties: {len(stars)} maps, stars {min(stars)}-{max(stars)} in "
          f"{record['plot_difficulties']['wall_s']:.2f} s")

    # (h) the web UI on the card: a generation job, then MaiMod on its map, each in a spawned worker
    ui_wav = write_wav(work / "ui.wav", TOOLS_AUDIO_SECONDS, seed=3)
    (work / "ui").mkdir()
    inner = web_ui._inference_worker, web_ui._mai_mod_worker
    web_ui._inference_worker, web_ui._mai_mod_worker = (functools.partial(ui_counted_worker, name)
                                                        for name in ("_inference_worker", "_mai_mod_worker"))
    server = web_ui.serve(0)  # no --device: each worker takes the presets' own, the card
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        generation = ui_job(url, "/start_inference", {
            "model": "v32", "model_path": str(fused), "audio_path": str(ui_wav), "output_path": str(work / "ui"),
            "gamemode": "0", "seed": "0", "title": "UI", "artist": "chip_smoke", "creator": "port", "version": "v32"})
        written = sorted((work / "ui").glob("*.osu"))
        if len(written) != 1 or Beatmap.from_path(written[0]).title != "UI":
            raise AssertionError(f"the UI's generation job wrote {written}")
        osu, osu_source = maimod_map(work, str(written[0]), "the UI job", TOOLS_AUDIO_SECONDS)
        analysis = ui_job(url, "/start_mai_mod", {"model": "v32", "model_path": str(fused), "beatmap_path": osu,
                                                  "audio_path": str(ui_wav), "surprisal_threshold": "0"})
    finally:
        server.shutdown()
        server.server_close()
        web_ui._inference_worker, web_ui._mai_mod_worker = inner
    with web_ui.JOBS_LOCK:
        left = list(web_ui.JOBS.values())
    for job in left:  # a job whose stream was not read to its end
        job["process"].kill()
        job["process"].join()
    if left:
        raise AssertionError(f"{len(left)} web UI jobs were left running")
    suggestions = analysis.pop("suggestions")
    record["web_ui"] = {"generation": generation, "mai_mod": {**analysis, "suggestions": len(suggestions),
                                                              "map": osu_source}}
    gen_launches, mod_launches = generation["launches"], analysis["launches"]
    if not suggestions or not all(s["edit_link"].startswith("osu://edit/") for s in suggestions) \
            or not gen_launches["flash_attention_fwd"] or not gen_launches["fused_mel"] \
            or mod_launches["flash_attention_fwd"] % ATTN_PER_STEP or not mod_launches["flash_attention_fwd"]:
        raise AssertionError(f"the web UI's jobs: {len(suggestions)} suggestions, launches {gen_launches}, "
                             f"{mod_launches}")
    print(f"tools (h) web UI: the generation job (spawned worker, fused-mel v32) wrote {written[0].name} in "
          f"{generation['wall_s']:.2f} s, launches {gen_launches}; MaiMod on {osu_source}: {len(suggestions)} "
          f"suggestions in {analysis['wall_s']:.2f} s, launches {mod_launches}")

    launches = {name: sum(r["launches"].get(name, 0) for r in (record["test"], record["dit_test_toy"],
                                                                record["plot_self_similarity"],
                                                                generation, analysis))
                for name in kernel_launches()}
    gc.collect()
    torch.cuda.empty_cache()  # the plain version at 2 560² takes about 57 GiB
    rows = eval_attention(report, TOOLS_ATTENTION, H=12, key="attention_tools", seed=23)
    record["phase_s"] = time.perf_counter() - started
    report["tools"] = record
    print(f"tools phase: {record['phase_s']:.1f} s, launches {launches}")
    return launches, rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU", file=sys.stderr)
        return 2
    started = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from mapperatorinator_tpu_torch.ops import _build
    from mapperatorinator_tpu_torch.train.loop import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report = {"attention_cases": [], "attention_sm90_cases": [], "qmm_cases": [], "qmm_cold_cases": [],
              "requests": []}
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    phase_s, last = {}, [started]

    def mark(name: str) -> None:  # each phase's seconds, for PERF.md's breakdown of the run
        now = time.perf_counter()
        phase_s[name], last[0] = now - last[0], now
        print(f"chip_smoke: {name} took {phase_s[name]:.1f} s ({now - started:.1f} s from the start)", flush=True)

    t0 = time.perf_counter()
    logs = _build.build("flash_attention", "flash_attention_sm90", "fused_mel", "qmm", "difficulty")
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = logs
    print(f"built flash_attention.cu, flash_attention_sm90.cu, fused_mel.cu and qmm.cu for sm_90a and "
          f"difficulty.cpp in {report['build_s']:.1f} s")

    mark("build")
    check_attention(report)
    kernels = [*time_attention_fp32(report), check_mel(report), time_qmm_cold(report), check_qmm(report),
               *check_attention_sm90(report)]
    mark("kernel checks")
    configured, config_row = config_phase(report)
    mark("config")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = write_wav(tmp / "song.wav", AUDIO_SECONDS)
        first = serve("1-v32-default", tmp, wav, [], report, check_encoder=True)
        mark("request 1")
        second = serve("2-greedy-fused-mel", tmp, wav,
                       ["do_sample=false", "train.model.spectrogram.implementation=pallas"],
                       report, check_encoder=False)
        mark("request 2")
        third = int8_request(tmp, wav, report)
        mark("request 3 and its checks")
        if first["flash_attention_fwd"] == 0 or second["flash_attention_fwd"] == 0 or second["fused_mel"] == 0 \
                or third["qmm"] == 0 or third["qmm_tc"] == 0 or third["flash_attention_fwd"] == 0:
            raise AssertionError(f"a kernel of the serving path never launched: {first}, {second}, {third}")
        tokens = [r["tokens"] for r in report["requests"]]
        print(f"serving: the three requests generated {tokens} tokens (seeded random weights, greedy decoding "
              f"with near-ties: a count is a property of the seed and the kernels' rounding)")
        maimod = maimod_phase(tmp, wav, report["requests"][1]["osu_path"], report)
        mark("maimod")
        super_timing = super_timing_phase(tmp, wav, report)
        mark("super timing")
        server = server_phase(tmp, wav, report)
        mark("server")
        v31 = v31_phase(tmp, wav, report)
        mark("v31")
        dit, dit_rows = dit_phase(tmp, wav, report)
        mark("dit")
        whisper, whisper_entries = whisper_phase(tmp, report)
        mark("whisper")
        t5, t5_entries = t5_phase(tmp, report)
        mark("t5")
        ngpt, ngpt_entries = ngpt_phase(tmp, report)
        mark("ngpt")
        moonshine, moonshine_entries, moonshine_bwd_rows = moonshine_phase(tmp, report)
        mark("moonshine")
        evaluated, eval_rows = eval_phase(tmp, wav, report)
        mark("eval")
        parquet_phase(report)
        mark("parquet")
        trained, trained_fp32, checked = train_phase(tmp, report)
        mark("train")
        finetuned, lora_served = finetune_phase(tmp, report)
        mark("finetune")
        aux_trained, aux_checked, aux_fwd_rows, aux_bwd_rows = aux_train_phase(tmp, report)
        mark("aux train")
        backbone_trained, backbone_checked, backbone_fwd_rows, backbone_bwd_rows = backbone_train_phase(tmp, report)
        mark("backbone train")
        parallel_trained, parallel_checked, parallel_fwd_rows, parallel_bwd_rows = parallel_phase(tmp, report)
        mark("parallel")
        tools, tools_rows = tools_phase(tmp, report)
        mark("tools")
    # kernel B's entry gains the DiT's, the evaluation models', the auxiliary trainers' and the eval harness's
    # shapes and their errors; C's fp32 entry the auxiliary trainers'
    fwd = next(entry for entry in kernels if entry["name"] == "flash_attention_fwd")
    fwd["shapes"] += dit_rows + eval_rows + aux_fwd_rows + tools_rows
    fwd["max_abs_err"] = max(fwd["max_abs_err"], *(e for row in dit_rows + eval_rows + aux_fwd_rows + tools_rows
                                                   for e in row["max_abs_err"].values()))
    bwd = next(entry for entry in kernels if entry["name"] == "flash_attention_bwd")
    bwd["shapes"] += aux_bwd_rows
    bwd["max_abs_err"] = max(bwd["max_abs_err"], *(e for row in aux_bwd_rows for e in row["max_abs_err"].values()))
    checked = {name: checked.get(name, 0) + aux_checked.get(name, 0) + backbone_checked.get(name, 0)
               + parallel_checked.get(name, 0)
               for name in set(checked) | set(aux_checked) | set(backbone_checked) | set(parallel_checked)}
    # kernel C's entries gain moonshine's head dim; the bf16 pair's entries every other backbone family's training
    # calls (T5's and nGPT's at sm_scale 1.0, moonshine's at D 36 padded to 64) and their errors
    for entry in kernels:
        if entry["name"] in ("flash_attention_bwd", "flash_attention_bwd_sm90"):
            route = "fp32" if entry["name"] == "flash_attention_bwd" else "sm90"
            entry.setdefault("shapes", []).extend(row for row in moonshine_bwd_rows if row["route"] == route)
        rows = {"flash_attention_fwd_sm90": backbone_fwd_rows + parallel_fwd_rows,
                "flash_attention_bwd_sm90": backbone_bwd_rows + parallel_bwd_rows}.get(entry["name"], [])
        if rows:
            entry.setdefault("shapes", []).extend(rows)
            entry["max_abs_err"] = max(entry["max_abs_err"], *(e for row in rows for e in row["max_abs_err"].values()))
    serving_paths = (first, second, third, maimod, super_timing, server, v31, dit, whisper, t5, ngpt, moonshine,
                     lora_served)
    served = {k: sum(path.get(k, 0) for path in serving_paths) for k in first}
    # each kernel's launches on the main paths that run it: serving (fp32),
    # fp32 training, bf16 training, the LoRA fine-tune, the evaluation tools,
    # the auxiliary trainers, the other backbone families' training,
    # multi-process training (every rank's), the single-card tools, the
    # config phase's mel front end; the gradient checks' are listed apart
    launches = {k: served.get(k, 0) + trained_fp32.get(k, 0) + trained.get(k, 0) + finetuned.get(k, 0)
                + evaluated.get(k, 0) + aux_trained.get(k, 0) + backbone_trained.get(k, 0)
                + parallel_trained.get(k, 0) + tools.get(k, 0) + configured.get(k, 0)
                for k in served}
    report["launches_by_path"] = {"config (the v32 front end at hop 256)": configured,
                                  "serving": served, "int8 serving (request 3)": third, "maimod": maimod,
                                  "super-timing": super_timing, "server": server,
                                  "v31 (two requests and MaiMod's fallback)": v31,
                                  "DiT refinement (the dense song and a v32 request)": dit,
                                  "whisper_abs (a v29 and an int8 v28 request)": whisper,
                                  "T5 (a published checkpoint's request and MaiMod, an int8 legacy one)": t5,
                                  "nGPT (NWhisper-base: a fp32 and an int8-KV request)": ngpt,
                                  "moonshine (moonshine-tiny: a fp32 and an int8 request)": moonshine,
                                  "LoRA serving (two requests)": lora_served,
                                  "evaluation (classify, calc_fid, classifier_test, rcomplexion)": evaluated,
                                  "training, fp32 micro-steps": trained_fp32, "training, bf16 micro-steps": trained,
                                  "LoRA fine-tune, bf16 micro-steps": finetuned,
                                  "auxiliary training (DiT-B, the classifier, OsuR)": aux_trained,
                                  "backbone training (v29, v28, T5-base, NWhisper-base, moonshine-tiny; bf16)":
                                      backbone_trained,
                                  "multi-process training and serving (v32 bf16: DDP and FSDP on one NCCL rank, DDP, "
                                  "FSDP and the tensor axis on two gloo ranks sharing the card; fp32 decode on a "
                                  "tensor axis of 1 (NCCL) and 2 (gloo); adafactor on one card; every rank's)":
                                      parallel_trained,
                                  "single-card tools (the eval harness, dit_test_toy, plot_self_similarity, the "
                                  "web UI's generation and MaiMod jobs)": tools,
                                  "gradient checks (v32 fp32 and bf16, DiT-B and the classifier fp32, the five "
                                  "backbones bf16 and their memory probes, the parallel phase's fixed-batch updates "
                                  "and one-process loss; not a main path)": checked}
    next(entry for entry in kernels if entry["name"] == "fused_mel")["config_hop256"] = config_row
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in checked:
            entry["gradient_check_launches"] = checked[entry["name"]]
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} never launched on the paths it serves: {report['launches_by_path']}")
    # B and D at the whisper shapes, B, A and D at T5's, B at nGPT's and moonshine's: their launches are those
    # phases'
    kernels += whisper_entries + t5_entries + ngpt_entries + moonshine_entries

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
    if loaded:
        raise AssertionError(f"the port's path imported {loaded}")
    report["card"] = card
    report["kernels"] = kernels
    report["phase_s"] = phase_s
    report["total_s"] = time.perf_counter() - started
    print(f"chip_smoke: {report['total_s']:.1f} s from start to here (the build included)")
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
