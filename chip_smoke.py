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
   a float64 reference beside them and two calls bit-equal, at one v32 window
   and at two (CFG), each timed beside its plain version and its bounds. A
   device time is the sum of the profiler's device kernels only
   (``device_kernels``), so a kernel launched through an op counts once.
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
   checkpoint. Request 3's engine then runs ``forward_stats``,
   ``generate_forced`` and ``generate_beams`` against ``forward`` and
   ``generate``.
5. Training: ``mapperatorinator_tpu_torch.train.main`` on the same
   full-width model with Muon, bf16 mixed precision, batch 32 and grad_acc 2
   for 6 micro-steps (3 updates) on a synthesized ``ors`` dataset, then a
   checkpoint. First, on the first batch in fp32 at batch 2, the loss and
   every gradient through the kernels must match the plain attention path;
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
6. Prints per-phase figures, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and as its last line
   ``{"ok": true, "device": {...}}``. Any failed check raises; the run fails
   if jax, flax, yaml, optax, msgpack or the JAX package was imported.

Details (compiler logs, all numbers) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import itertools
import json
import math
import statistics
import sys
import tempfile
import time
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
QMM_SHAPES = [  # (rows, K, N): decode steps; an encoder window's fc1, qkv and out; init_cache; a prefill; ragged
    (1, 768, 2304), (1, 768, 768), (1, 768, 3072), (1, 3072, 768), (2, 768, 768), (4, 768, 3072), (3, 200, 128),
    (1024, 768, 3072), (1024, 768, 2304), (1024, 768, 768), (1024, 768, 1536), (256, 3072, 768)]
# a decode step's products on the GEMV path (rows <= 4): self-attention qkv,
# the 768-wide ones (self out, cross q and out), fc1, fc2; and out with CFG
QMM_DECODE = [(1, 768, 2304), (1, 768, 768), (1, 768, 3072), (1, 3072, 768), (2, 768, 768)]
QMM_TIMED = {"qmm": (1, 768, 3072),  # the GEMV path at a decode step's fc1, cold L2
             "qmm_tc": (1024, 768, 3072)}  # the tensor-core path at an encoder window's fc1
# cold L2: a decode step streams every decoder layer's weights (about 99 MB of
# int8), twice the 50 MB L2, so each timed GEMV call reads the next of enough
# weight copies to hold together at least this many bytes
COLD_BYTES = 2**26
# the profiler's names of kernel D's kernels (csrc/qmm.cu), by path
QMM_KERNELS = {"qmm_gemv": "qmm_gemv_cluster_kernel", "qmm_tc": "qmm_tc_kernel"}
INT8_BARS = (0.06, 0.8)  # int8 vs fp logits: relative max error, argmax agreement (test_quantize_checkpoint.py:58-59)
ENGINE_STEPS = 64
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
ORS_TRACKS, ORS_MAPS, ORS_SECONDS = 8, 4, 60.0
BLOCKED = ("jax", "jaxlib", "flax", "yaml", "optax", "msgpack", "mapperatorinator_tpu")


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


def attended_pairs(B: int, T: int, S: int, causal: bool, mask) -> float:
    """The (query, key) pairs of one head that the function needs: those the
    causal and key masks leave, in each row with a live key; a row with none
    averages v over all S keys. The masked pairs that a kernel computes
    anyway are wasted work, not throughput."""
    live = torch.ones((T, S), dtype=torch.bool, device="cuda")
    if causal:
        live = live.tril()
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


# the fp32 route's timed calls: (label, B, T, S, causal + key mask); serving
# is B's only, the three training calls of the fp32 micro-steps both kernels'
FP32_SHAPES = [("serving encoder", 1, 1024, 1024, False), ("training encoder", FP32_TRAIN_BATCH, 1024, 1024, False),
               ("training decoder self", FP32_TRAIN_BATCH, 2560, 2560, True),
               ("training cross", FP32_TRAIN_BATCH, 2560, 1024, False)]


def attention_cases(gen, B: int):
    """(label, T, S, causal, window, key mask) of the checks: the training
    calls, a ragged cross call, and a batch row whose keys are all masked."""
    key_mask = torch.rand((B, 2560), generator=gen, device="cuda") > 0.1
    all_masked = torch.ones((B, 1024), dtype=torch.bool, device="cuda")
    all_masked[0] = False  # every query row of batch 0 sees no key
    return [
        ("encoder self T1024", 1024, 1024, False, 0, None),
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
    paths (``FP32_SHAPES``: B at all four, C at the three of training)
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
    for label, B, T, S, causal in FP32_SHAPES:
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
        if label != "serving encoder":
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


def mel_frames(batch: int):
    """``batch`` items of one v32 window of seeded audio (a 440 Hz tone and
    noise, 2047 hops of 128 samples) on the card, reflect-padded and framed as
    ``MelSpectrogram`` frames them: (frames, padded signal)."""
    n = 2047 * 128
    t = np.arange(n) / 16000
    rng = np.random.default_rng(0)
    audio = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal((batch, n))).astype(np.float32)
    x = torch.from_numpy(audio).cuda()
    padded = torch.nn.functional.pad(x[:, None], (512, 512), mode="reflect")[:, 0]
    return padded.unfold(1, 1024, 128)[:, :2048], padded


def check_mel(report: dict) -> dict:
    """Kernel A against both its plain versions (``mel_plain_tf32x3``, which
    rounds as it does, and ``mel_plain``) at ``MEL_TC_TOL`` and at the
    reference's ``MEL_TOL``, with a float64 reference beside them, two calls
    bit-equal, at one v32 window (request 2's call) and two (CFG, batch 2);
    each timed beside its plain version, by CUDA events and by the profiler's
    device kernels, and set against ``fp32_bounds``. Returns the kernels-line
    entry at one window."""
    from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain, mel_plain_tf32x3

    mel = MelSpectrogram("pallas", True, 16000, 1024, 128, 128, 20, 8000, "reflect").cuda()
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    n_fft, n_bins, n_mels = mel.w_re.shape[0], mel.w_re.shape[1], mel.fbanks.shape[1]
    cases = []
    for batch in (1, 2):
        frames, padded = mel_frames(batch)
        got = fused_mel(frames, *args)
        want, want3 = mel_plain(frames, *args), mel_plain_tf32x3(frames, *args)
        fd = frames.double()
        re, im = fd @ mel.w_re.double(), fd @ mel.w_im.double()
        truth = torch.log1p((re * re + im * im) @ mel.fbanks.double())
        torch.cuda.synchronize()

        def excess(ref, tol):  # the largest |got - ref| - tol |ref|: at most tol passes rtol = atol = tol
            return ((got - ref).abs() - tol * ref.abs()).max().item()

        case = {"batch": batch, "shape": list(got.shape), "max_abs_err": (got - want).abs().max().item(),
                "max_abs_err_tf32x3": (got - want3).abs().max().item(),
                "max_abs_err_fp64": {"kernel": (got.double() - truth).abs().max().item(),
                                     "plain": (want.double() - truth).abs().max().item(),
                                     "plain_tf32x3": (want3.double() - truth).abs().max().item()},
                "repeat_bit_equal": torch.equal(got, fused_mel(frames, *args)),
                "finite": bool(torch.isfinite(got).all())}
        label = f"fused_mel batch {batch} x 2048 frames, 1024 -> {n_bins} -> {n_mels}, log1p"
        print(f"{label}: max_abs_err {case['max_abs_err']:.3e} against mel_plain, {case['max_abs_err_tf32x3']:.3e} "
              f"against mel_plain_tf32x3 (rtol = atol = {MEL_TC_TOL:g}; the reference's {MEL_TOL:g}); against "
              f"float64: kernel {case['max_abs_err_fp64']['kernel']:.3e}, mel_plain "
              f"{case['max_abs_err_fp64']['plain']:.3e}, mel_plain_tf32x3 {case['max_abs_err_fp64']['plain_tf32x3']:.3e}; "
              f"a second call bit-equal {case['repeat_bit_equal']}")
        if (got.shape != (batch, 2048, n_mels) or not case["finite"] or not case["repeat_bit_equal"]
                or not excess(want, MEL_TOL) <= MEL_TOL or not excess(want, MEL_TC_TOL) <= MEL_TC_TOL
                or not excess(want3, MEL_TC_TOL) <= MEL_TC_TOL):
            raise AssertionError(f"{label} disagrees with its plain versions: {case}")
        ms, plain_ms, _ = paired_ms(lambda: fused_mel(frames, *args), lambda: mel_plain(frames, *args))
        case.update(ms=ms, plain_ms=plain_ms,
                    device_ms={"kernel": device_ms(lambda: fused_mel(frames, *args)),
                               "plain": device_ms(lambda: mel_plain(frames, *args))},
                    **fp32_bounds(*mel_work(batch, 2048, n_fft, n_bins, n_mels, padded.numel())))
        print(f"{label}: kernel {ms:.4f} ms (device {fmt_ms(case['device_ms']['kernel'])}), plain {plain_ms:.4f} ms "
              f"(device {fmt_ms(case['device_ms']['plain'])}); bound {case['bound_ms']:.4f} ms ({case['bound_by']}: "
              f"fp32 FMAs {case['fma_ms']:.4f}, three TF32 products {case['tf32x3_ms']:.4f}, bytes "
              f"{case['bytes_ms']:.4f}); no single PyTorch call computes the mel")
        cases.append(case)
    report["mel_cases"] = cases
    one = cases[0]
    return {"name": "fused_mel", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/fused_mel.cu",
            "replaces": "mapperatorinator_tpu/ops/mel_kernel.py:72", "max_abs_err": one["max_abs_err"],
            "max_abs_err_tf32x3": one["max_abs_err_tf32x3"], "tol": MEL_TC_TOL, "ms": one["ms"],
            "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
            "bound_fma_ms": one["fma_ms"], "bound_tf32x3_ms": one["tf32x3_ms"], "library_ms": None,
            "device_ms": one["device_ms"], "timed_shape": f"N2048 1024->{n_bins}->{n_mels} log1p fp32",
            "cfg_batch2": {k: cases[1][k] for k in ("ms", "plain_ms", "device_ms", "bound_ms", "max_abs_err",
                                                     "max_abs_err_tf32x3")}}


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
    """Kernel D against its plain version at the v32 shapes in fp32 and bf16;
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
    return {"name": "qmm_tc", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
            "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80", "max_abs_err": timed["max_abs_err"],
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
    from mapperatorinator_tpu_torch.models.transformer import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.use_flash = on


def set_qmm(model, on: bool) -> None:
    from mapperatorinator_tpu_torch.models.transformer import QDense

    for m in model.modules():
        if isinstance(m, QDense):
            m.use_kernel = on


def window0(args):
    from mapperatorinator_tpu_torch.infer import Preprocessor

    pre = Preprocessor(args, parallel=args.parallel)
    return pre.segment(pre.load(args.audio_path))[0][:1]


def serve(label: str, tmp: Path, wav: Path, overrides: list[str], report: dict, check_encoder: bool,
          after=None) -> dict:
    """One request; ``after(engine, args, vocab, first)`` runs more checks on
    the engine before it is freed, ``first`` holding the first decode call's
    prompt, tokens and end."""
    from mapperatorinator_tpu_torch import inference
    from mapperatorinator_tpu_torch.config import load_config
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm
    from mapperatorinator_tpu_torch.osu.beatmap import Beatmap

    (tmp / label).mkdir()
    # no model_path: seeded random weights at the v32 shapes
    args = load_config("v32", ["model_path=", "seed=0", f"audio_path={wav}", f"output_path={tmp / label}",
                               "gamemode=0", *overrides])

    engine, vocab = inference.load_model(args)
    inference.compile_args(args, vocab, verbose=False)
    b = engine.model.cfg.backbone
    if (b.d_model, b.encoder_layers, b.decoder_layers, b.decoder_heads, b.encoder_ffn) != (768, 12, 12, 12, 3072):
        raise AssertionError(f"not the full-width v32 backbone: {b}")
    generation_config, beatmap_config = inference.get_config(args)

    stats = {"tokens": 0, "decode_s": 0.0, "windows": 0}
    first = {}
    inner = engine.generate

    def counted(encoder_states, ids, *a, **kw):
        t0 = time.perf_counter()
        tokens, end = inner(encoder_states, ids, *a, **kw)
        if not first:
            first.update(ids=ids, tokens=tokens, end=end)
        stats["decode_s"] += time.perf_counter() - t0
        stats["tokens"] += int((tokens != vocab.pad_id).sum() - (ids != vocab.pad_id).sum())
        stats["windows"] += 1
        return tokens, end

    engine.generate = counted
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
    engine.generate = inner
    peak = torch.cuda.max_memory_allocated()

    beatmap = Beatmap.from_path(path)
    if beatmap.mode != args.gamemode or beatmap.title != args.title or "[HitObjects]" not in text:
        raise AssertionError(f"{label}: {path} does not read back as the requested beatmap")
    result = {
        "label": label, "wall_s": wall, "decode_s": stats["decode_s"], "windows": stats["windows"],
        "tokens": stats["tokens"], "tok_per_s": stats["tokens"] / wall, "decode_tok_per_s":
        stats["tokens"] / stats["decode_s"] if stats["decode_s"] else 0.0, "peak_mem_gb": peak / 2**30,
        "launches": launches, "hit_objects": len(beatmap.hit_objects()), "timing_points": len(beatmap.timing_points),
        "osu_bytes": len(text.encode()),
    }
    print(f"request {label}: wall {wall:.2f} s, {stats['windows']} windows, {stats['tokens']} tokens generated, "
          f"{result['tok_per_s']:.1f} tok/s ({result['decode_tok_per_s']:.1f} tok/s in decode), "
          f"peak memory {result['peak_mem_gb']:.2f} GiB, {result['hit_objects']} hit objects, "
          f"{result['timing_points']} timing points, launches {launches}")

    if check_encoder:
        frames = window0(args)
        with_kernel = engine.encode_with_cond(frames)
        set_flash(engine.model, False)
        plain = engine.encode_with_cond(frames)
        set_flash(engine.model, True)
        torch.cuda.synchronize()
        err = (with_kernel - plain).abs().max().item()
        finite = bool(torch.isfinite(with_kernel).all())
        print(f"request {label}, window 0: encoder states {tuple(with_kernel.shape)} through the flash kernel vs "
              f"plain attention: max_abs_err {err:.3e} (tol {ENC_TOL:g})")
        result["encoder_check"] = {"shape": list(with_kernel.shape), "max_abs_err": err, "tol": ENC_TOL}
        if with_kernel.shape != (1, 1024, 768) or not finite or not err <= ENC_TOL:
            raise AssertionError(f"encoder states disagree: shape {tuple(with_kernel.shape)}, finite {finite}, "
                                 f"error {err}")
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


def profile_decode(engine, enc, ids, pipeline, eos, int8: bool, steps: int = 48) -> dict:
    """Greedy decode steps on ``engine``: host ms a step without the profiler,
    then, profiled, device ms and kernel launches a step and the device time
    of kernel D's launches (the GEMV path's, and the tensor-core path's in
    the generate call's ``init_cache``), all from device kernels only, found
    by the names in ``QMM_KERNELS``. An ``int8`` engine's profile that holds
    no GEMV kernel raises: a renamed kernel would otherwise read 0."""
    from torch.profiler import ProfilerActivity, profile

    P = ids.shape[1]
    engine.generate(enc, ids, pipeline, eos, max_length=P + 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, end = engine.generate(enc, ids, pipeline, eos, max_length=P + steps)
    torch.cuda.synchronize()
    n = end - P
    wall = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(enc, ids, pipeline, eos, max_length=P + steps)
        torch.cuda.synchronize()
    kernels = device_kernels(prof.key_averages())
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    paths = {path: [e for e in kernels if name in e.key] for path, name in QMM_KERNELS.items()}
    if int8 and not paths["qmm_gemv"]:
        raise AssertionError(f"the int8 decode steps' profile holds no {QMM_KERNELS['qmm_gemv']}: "
                             f"{sorted(e.key[:60] for e in kernels)}")
    out = {"steps": n, "host_ms_per_step": wall, "device_ms_per_step": device / n,
           "kernels_per_step": sum(e.count for e in kernels) / n,
           "qmm_device_ms_per_step": sum(e.self_device_time_total for es in paths.values() for e in es) / 1e3 / n}
    for path, events in paths.items():
        calls = sum(e.count for e in events)
        out[f"{path}_calls"] = calls
        out[f"{path}_device_us_per_call"] = sum(e.self_device_time_total for e in events) / max(calls, 1)
    return out


def int8_checks(ckpt: Path):
    """Request 3's checks on its int8 engine, window 0."""

    def checks(engine, args, vocab, first) -> dict:
        from mapperatorinator_tpu_torch import inference
        from mapperatorinator_tpu_torch.config import load_config
        from mapperatorinator_tpu_torch.decode.engine import _bucket
        from mapperatorinator_tpu_torch.decode.logits import build_logits_pipeline, get_eos_token_ids
        from mapperatorinator_tpu_torch.models.transformer import QDense
        from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm

        model, out = engine.model, {}
        n_qdense = sum(isinstance(m, QDense) for m in model.modules())
        if n_qdense != 133 or not model.cfg.backbone.quantized_kv:
            raise AssertionError(f"the int8 model has {n_qdense} QDense modules (want 133), "
                                 f"quantized_kv {model.cfg.backbone.quantized_kv}")
        frames = window0(args)
        enc = engine.encode_with_cond(frames)
        # the first prompt with the tokens it generated, teacher-forced: 512 rows
        # keep every decoder QDense but fc2 under the qmm gate
        seq = first["tokens"][:1, :min(int(first["end"]), 512)]
        before = qmm.launches
        with_kernel = engine.forward(enc, seq)
        if qmm.launches == before:
            raise AssertionError("the teacher-forced check did not run kernel D")
        set_qmm(model, False)
        plain = engine.forward(enc, seq)
        set_qmm(model, True)
        err, tol = float(np.abs(with_kernel - plain).max()), ENC_TOL * float(np.abs(plain).max())
        print(f"request 3, window 0: teacher-forced logits {with_kernel.shape} through kernel D vs qmm_plain: "
              f"max_abs_err {err:.3e} (tol {tol:.3e} = {ENC_TOL:g} x the largest |logit|)")
        out["qmm_logits_check"] = {"shape": list(with_kernel.shape), "max_abs_err": err, "tol": tol}
        if not (np.isfinite(with_kernel).all() and err <= tol):
            raise AssertionError(f"logits through kernel D disagree with qmm_plain: {err} above {tol}")

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
        greedy_chain = (build_logits_pipeline(vocab, do_sample=False), get_eos_token_ids(vocab))
        steps = {"int8": profile_decode(engine, enc, first["ids"][:1], *greedy_chain, int8=True),
                 "fp32": profile_decode(fp_engine, fp_enc, first["ids"][:1], *greedy_chain, int8=False)}
        for name, st in steps.items():
            print(f"request 3 decode steps, {name} weights and KV: {st['host_ms_per_step']:.2f} ms a step on the host "
                  f"clock; profiled, {st['device_ms_per_step']:.3f} ms of device kernels and "
                  f"{st['kernels_per_step']:.0f} launches a step, kernel D {st['qmm_device_ms_per_step']:.3f} ms "
                  f"(GEMV {st['qmm_gemv_calls']} calls, {st['qmm_gemv_device_us_per_call']:.2f} us a call; tensor "
                  f"cores {st['qmm_tc_calls']} calls, {st['qmm_tc_device_us_per_call']:.2f} us a call)")
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


def write_ors(root: Path) -> Path:
    """An ``ors`` track-folder dataset made from a seed: ``ORS_TRACKS``
    tracks of ``ORS_SECONDS`` s of audio, each with ``ORS_MAPS`` maps whose
    hit objects, one every 50 ms, fill the 2560-token target of a window."""
    rng = np.random.default_rng(0)
    for track_i in range(ORS_TRACKS):
        track = root / f"Track{track_i:05d}"
        (track / "beatmaps").mkdir(parents=True)
        write_wav(track / "audio.wav", ORS_SECONDS, seed=track_i, freq=220.0 + 30 * track_i)
        metadata = {"Beatmaps": {}}
        for bm_i in range(ORS_MAPS):
            objects = "\n".join(
                f"{int(rng.integers(50, 450))},{int(rng.integers(50, 330))},{500 + k * 50},"
                f"{5 if k % 8 == 0 else 1},0,0:0:0:0:" for k in range(int((ORS_SECONDS - 1) * 20)))
            bid = track_i * 10 + bm_i
            (track / "beatmaps" / f"map{bm_i}.osu").write_text(OSU_TEMPLATE.format(i=bm_i, bid=bid, objects=objects))
            metadata["Beatmaps"][f"map{bm_i}"] = {"BeatmapId": bid, "Index": track_i * ORS_MAPS + bm_i,
                                                  "StandardStarRating": {"0": 5.0, "64": 6.2}, "RankedYear": 2020}
        (track / "metadata.json").write_text(json.dumps(metadata))
    return root


def data_overrides(ors: Path) -> list[str]:
    # v32 streams the web dataset; the port trains on local track folders,
    # which read the descriptor table from the repo's csv
    return ["data.dataset_type=ors", "data.descriptors_path=datasets/beatmap_descriptors.csv",
            f"data.train_dataset_path={ors}", "data.train_dataset_start=0", f"data.train_dataset_end={ORS_TRACKS}",
            f"data.test_dataset_path={ors}", "data.test_dataset_start=0", f"data.test_dataset_end={ORS_TRACKS}"]


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

    def worst(grads: dict, ref: dict) -> tuple[float, str]:
        """The largest error relative to the reference tensor's largest entry, and its tensor."""
        errs = {n: ((grads[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item() for n, g in ref.items()}
        name = max(errs, key=errs.get)
        return errs[name], name

    model, _, make_batches = build("no")
    batch = to_device({k: v[:2] for k, v in next(iter(make_batches(test=False))).items()}, "cuda")
    weights = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_k, grads_k, fp32_launches = with_kernels(model, batch, ("flash_attention_fwd", "flash_attention_bwd"))
    loss_ref, ref = loss_and_grads(model, batch, False)
    err, name = worst(grads_k, ref)
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
    (err_k, name_k), (err_p, name_p), (err_kp, _) = worst(grads_k, ref), worst(grads_p, ref), worst(grads_k, grads_p)
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


def train_overrides(ors: Path, ckpt: Path, batch: int, grad_acc: int, steps: int) -> list[str]:
    return data_overrides(ors) + [
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
    overrides = train_overrides(ors, tmp / "ckpt_fp32", FP32_TRAIN_BATCH, 1, FP32_TRAIN_STEPS)
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

    t0 = time.perf_counter()
    ors = write_ors(tmp / "ors")
    print(f"ors dataset: {ORS_TRACKS} tracks x {ORS_MAPS} maps, {ORS_SECONDS:g} s of audio each, written in "
          f"{time.perf_counter() - t0:.1f} s")
    report["training"] = {}
    check_launches = check_gradients(ors, report)
    fp32_launches = train_fp32(tmp, ors, report)

    ckpt, logs = tmp / "ckpt", tmp / "logs"
    overrides = train_overrides(ors, ckpt, TRAIN_BATCH, TRAIN_GRAD_ACC, TRAIN_MICRO_STEPS)
    print(f"training cuts: {TRAIN_MICRO_STEPS} micro-steps ({TRAIN_MICRO_STEPS // TRAIN_GRAD_ACC} updates) of v32's "
          f"batch {TRAIN_BATCH} x grad_acc {TRAIN_GRAD_ACC}; no eval; token balancer off (its 2048-sample buffer "
          "outlasts the run); width and depth as published")
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
    tokens = batch_tokens(shapes)
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

    t0 = time.perf_counter()
    logs = _build.build("flash_attention", "flash_attention_sm90", "fused_mel", "qmm", "difficulty")
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = logs
    print(f"built flash_attention.cu, flash_attention_sm90.cu, fused_mel.cu and qmm.cu for sm_90a and "
          f"difficulty.cpp in {report['build_s']:.1f} s")

    check_attention(report)
    kernels = [*time_attention_fp32(report), check_mel(report), time_qmm_cold(report), check_qmm(report),
               *check_attention_sm90(report)]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = write_wav(tmp / "song.wav", AUDIO_SECONDS)
        first = serve("1-v32-default", tmp, wav, [], report, check_encoder=True)
        second = serve("2-greedy-fused-mel", tmp, wav,
                       ["do_sample=false", "train.model.spectrogram.implementation=pallas"],
                       report, check_encoder=False)
        third = int8_request(tmp, wav, report)
        if first["flash_attention_fwd"] == 0 or second["flash_attention_fwd"] == 0 or second["fused_mel"] == 0 \
                or third["qmm"] == 0 or third["qmm_tc"] == 0 or third["flash_attention_fwd"] == 0:
            raise AssertionError(f"a kernel of the serving path never launched: {first}, {second}, {third}")
        tokens = [r["tokens"] for r in report["requests"]]
        print(f"serving: the three requests generated {tokens} tokens (seeded random weights, greedy decoding "
              f"with near-ties: a count is a property of the seed and the kernels' rounding)")
        trained, trained_fp32, checked = train_phase(tmp, report)
    served = {k: first[k] + second[k] + third[k] for k in first}
    # each kernel's launches on the main paths that run it: serving (fp32),
    # fp32 training, bf16 training; the gradient check's are listed apart
    launches = {k: served.get(k, 0) + trained_fp32.get(k, 0) + trained.get(k, 0) for k in served}
    report["launches_by_path"] = {"serving": served, "int8 serving (request 3)": third,
                                  "training, fp32 micro-steps": trained_fp32, "training, bf16 micro-steps": trained,
                                  "gradient check (fp32 and bf16, first batch; not a main path)": checked}
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        if entry["name"] in checked:
            entry["gradient_check_launches"] = checked[entry["name"]]
        if entry["launches"] == 0:
            raise AssertionError(f"{entry['name']} never launched on the paths it serves: {report['launches_by_path']}")

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
    if loaded:
        raise AssertionError(f"the port's path imported {loaded}")
    report["card"] = card
    report["kernels"] = kernels
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
