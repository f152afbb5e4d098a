#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

1. Exits non-zero when no CUDA device is visible; there is no CPU path.
2. Builds the port's kernels from ``mapperatorinator_tpu_torch/csrc`` (one
   compiler per source, in parallel): the flash-attention forward and
   backward, the fused mel, the int8 matrix product, and the host
   star-rating library.
3. Holds each kernel against its plain PyTorch version on the card at the
   v32 shapes, printing the largest absolute error beside its tolerance and
   the median times of the kernel, the plain version and, where one PyTorch
   call computes the same function, that call.
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
6. Prints per-phase figures, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and as its last line
   ``{"ok": true, "device": {...}}``. Any failed check raises; the run fails
   if jax, flax, yaml, optax, msgpack or the JAX package was imported.

Details (compiler logs, all numbers) go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
ENC_TOL = 2e-4  # model-level bar, test_model.py:77
# qmm: the reference's 1e-5 (test_qmm_kernel.py:30) in fp32, 2e-2 in bf16, each
# times the largest |reference output|, at least 1
QMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
QMM_SHAPES = [  # (rows, K, N): decode steps, an encoder window, a prefill, a ragged case
    (1, 768, 2304), (1, 768, 3072), (1, 3072, 768), (2, 768, 768),
    (1024, 768, 3072), (1024, 768, 1536), (256, 3072, 768), (3, 200, 128)]
QMM_TIMED = (1, 768, 3072)  # the decode step's fc1, the kernels line's shape
QMM_PROFILED = (QMM_TIMED, (1024, 768, 3072))  # also timed by the profiler: a decode step's and an encoder window's fc1
INT8_BARS = (0.06, 0.8)  # int8 vs fp logits: relative max error, argmax agreement (test_quantize_checkpoint.py:58-59)
ENGINE_STEPS = 64
STATS_TOL = 1e-4  # forward_stats vs the host reduction, test_decode.py:424
GRAD_TOL = 2e-4  # the model bar, times each gradient tensor's largest entry

# the card's published rates (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # fp32 outside the tensor cores; bf16
PEAK_BYTES = 3.35e12

# training: v32's batch and accumulation; a cut would be printed here
TRAIN_BATCH, TRAIN_GRAD_ACC, TRAIN_MICRO_STEPS = 32, 2, 6
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


def paired_ms(kernel, plain, library=None, reps: int = 20) -> tuple[float, float, float | None]:
    """Median ms of each, timed in turns (plain, kernel, kernel, plain), the
    median of the two rounds."""
    p1, k1 = median_ms(plain, reps), median_ms(kernel, reps)
    k2, p2 = median_ms(kernel, reps), median_ms(plain, reps)
    lib = statistics.median([median_ms(library, reps), median_ms(library, reps)]) if library else None
    return statistics.median([k1, k2]), statistics.median([p1, p2]), lib


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``, from the profiler: the summed time
    of the kernels it launches over ``reps`` calls, divided by ``reps``. At
    a decode shape the CUDA-event time of one call is mostly the host's
    enqueue time; this is the card's share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations over
    the peak rate for the inputs' type and the bytes over the memory rate."""
    by_ops, by_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sdpa_layout(*xs):
    """(B, T, H, D) -> contiguous (B, H, T, D), the layout SDPA takes."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def check_attention(report: dict) -> dict:
    from mapperatorinator_tpu_torch.ops.attention_kernel import attention_plain, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    H, D = 12, 64
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 2):
            key_mask = torch.rand((B, 1024), generator=gen, device="cuda") > 0.2
            all_masked = key_mask.clone()
            all_masked[0] = False  # every query row of batch 0 sees no key
            cases += [
                (dtype, B, 1024, 1024, {}, "none"),
                (dtype, B, 1024, 1024, {"causal": True}, "causal"),
                (dtype, B, 1024, 1024, {"window": 128, "kv_mask": key_mask}, "window128+keymask"),
                (dtype, B, 1024, 1024, {"kv_mask": all_masked}, "all-keys-masked row"),
                (dtype, B, 300, 1024, {"kv_mask": key_mask}, "cross T300 S1024"),
            ]
    worst = 0.0
    for dtype, B, T, S, kw, label in cases:
        q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        mask = kw.pop("kv_mask", None)
        got = flash_attention(q, k, v, mask, **kw)
        want = attention_plain(q, k, v, mask, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        print(f"flash_attention {str(dtype)[6:]} B{B} T{T} S{S} {label}: max_abs_err {err:.3e} (tol {tol:g})")
        report["attention_cases"].append({"dtype": str(dtype), "B": B, "T": T, "S": S, "case": label,
                                          "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"flash_attention {label} {dtype} B{B}: error {err} above {tol}")
        if dtype == torch.float32:
            worst = max(worst, err)

    # the serving path's call: one window's encoder self-attention, fp32, no mask
    B, T = 1, 1024
    q, k, v = (torch.randn((B, T, H, D), generator=gen, device="cuda") for _ in range(3))
    qs, ks, vs = sdpa_layout(q, k, v)
    ms, plain_ms, library_ms = paired_ms(lambda: flash_attention(q, k, v), lambda: attention_plain(q, k, v),
                                         lambda: torch.nn.functional.scaled_dot_product_attention(qs, ks, vs))
    bound_ms, bound_by = bound(4.0 * B * H * T * T * D, 4 * B * T * H * D * 4, torch.float32)
    print(f"flash_attention fp32 B1 T1024 S1024 H12 D64: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "mapperatorinator_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mapperatorinator_tpu/ops/attention_kernel.py:88",
            "max_abs_err": worst, "tol": ATTN_TOL[torch.float32], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "timed_shape": "B1 T1024 S1024 H12 D64 fp32"}


def check_attention_bwd(report: dict) -> dict:
    """Kernel C against its plain version at the training shapes, batch 2,
    fp32 and bf16; then timed at the encoder self-attention of the training
    batch in bf16."""
    from mapperatorinator_tpu_torch.ops.attention_kernel import (
        attention_backward_plain,
        flash_attention_bwd,
        flash_attention_fwd,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    H, D, B = 12, 64, 2
    key_mask = torch.rand((B, 2560), generator=gen, device="cuda") > 0.1
    all_masked = torch.ones((B, 1024), dtype=torch.bool, device="cuda")
    all_masked[0] = False
    cases = [  # (label, T, S, causal, window, key mask)
        ("encoder self T1024", 1024, 1024, False, 0, None),
        ("decoder self local T2560 causal window128 keymask", 2560, 2560, True, 128, key_mask),
        ("decoder self global T2560 causal keymask", 2560, 2560, True, 0, key_mask),
        ("cross T2560 S1024", 2560, 1024, False, 0, None),
        ("all-keys-masked row T1024", 1024, 1024, False, 0, all_masked),
    ]
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for label, T, S, causal, window, mask in cases:
            q = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
            k, v = (torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype) for _ in range(2))
            do = torch.randn((B, T, H, D), generator=gen, device="cuda").to(dtype)
            scale = D**-0.5
            out, lse = flash_attention_fwd(q, k, v, mask, causal, window, scale, with_lse=True)
            got = flash_attention_bwd(q, k, v, mask, out, lse, do, causal, window, scale)
            want = attention_backward_plain(q, k, v, mask, do, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
            # the reference's bar, scaled by the largest reference gradient:
            # gradients grow with the length, and dq is summed with atomics
            tol = ATTN_TOL[dtype] * max(1.0, max(w.float().abs().max().item() for w in want))
            print(f"flash_attention_bwd {str(dtype)[6:]} B{B} {label}: max_abs_err {err:.3e} (tol {tol:.3e})")
            report["attention_bwd_cases"].append({"dtype": str(dtype), "B": B, "T": T, "S": S, "case": label,
                                                  "max_abs_err": err, "tol": tol})
            if not err <= tol:
                raise AssertionError(f"flash_attention_bwd {label} {dtype}: error {err} above {tol}")
            if mask is all_masked and (got[0][0].abs().max().item() or got[1][0].abs().max().item()):
                raise AssertionError("flash_attention_bwd: a row with no live key gave dq or dk a gradient")
            if dtype == torch.float32:
                worst = max(worst, err)

    # the training path's call: encoder self-attention of the training batch, bf16
    Bt, T, dtype = TRAIN_BATCH, 1024, torch.bfloat16
    q, k, v, do = (torch.randn((Bt, T, H, D), generator=gen, device="cuda").to(dtype) for _ in range(4))
    scale = D**-0.5
    out, lse = flash_attention_fwd(q, k, v, None, False, 0, scale, with_lse=True)
    qs, ks, vs = (x.requires_grad_() for x in sdpa_layout(q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs)
    do_s = do.transpose(1, 2).contiguous()
    ms, plain_ms, library_ms = paired_ms(
        lambda: flash_attention_bwd(q, k, v, None, out, lse, do, False, 0, scale),
        lambda: attention_backward_plain(q, k, v, None, do),
        lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), do_s, retain_graph=True), reps=10)
    el = Bt * T * H * D
    # 5 products of T x S x D per (batch, head): the recomputed logits, dP,
    # dV, dK, dQ; q, k, v, O, dO and lse read once, dq, dk, dv written once
    flops, nbytes = 10.0 * Bt * H * T * T * D, 8 * el * 2 + Bt * H * T * 4
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    simt_ms = flops / PEAK_FLOPS[torch.float32] * 1e3
    print(f"flash_attention_bwd bf16 B{Bt} T1024 S1024 H12 D64: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention backward {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
          f"bf16 peak; {simt_ms:.3f} ms at the fp32 SIMT peak)")
    report["attention_bwd_timing"] = {"simt_bound_ms": simt_ms, "shape": f"B{Bt} T1024 S1024 H12 D64 bf16"}
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "mapperatorinator_tpu_torch/csrc/flash_attention.cu",
            "replaces": "mapperatorinator_tpu/ops/attention_kernel.py:197",
            "max_abs_err": worst, "tol": "2e-5 x max(1, max |reference gradient|), fp32",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "timed_shape": f"B{Bt} T1024 S1024 H12 D64 bf16"}


def check_mel(report: dict) -> dict:
    from mapperatorinator_tpu_torch.audio.mel import MelSpectrogram
    from mapperatorinator_tpu_torch.ops.mel_kernel import fused_mel, mel_plain

    # one v32 window: 2047 hops of 128 samples -> 2048 frames, 1024 -> 128 mels
    n = 2047 * 128
    t = np.arange(n) / 16000
    rng = np.random.default_rng(0)
    audio = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    mel = MelSpectrogram("pallas", True, 16000, 1024, 128, 128, 20, 8000, "reflect").cuda()
    x = torch.from_numpy(audio)[None].cuda()
    padded = torch.nn.functional.pad(x[:, None], (512, 512), mode="reflect")[:, 0]
    frames = padded.unfold(1, 1024, 128)[:, :2048]
    args = (mel.w_re, mel.w_im, mel.fbanks, True)
    got = fused_mel(frames, *args)
    want = mel_plain(frames, *args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    excess = ((got - want).abs() - MEL_TOL * want.abs()).max().item()
    print(f"fused_mel N2048 1024->128 log1p: max_abs_err {err:.3e} (rtol = atol = {MEL_TOL:g})")
    report["mel"] = {"max_abs_err": err, "tol": MEL_TOL, "shape": list(got.shape)}
    if got.shape != (1, 2048, 128) or not excess <= MEL_TOL:
        raise AssertionError(f"fused_mel disagrees: max error {err}, shape {tuple(got.shape)}")
    ms, plain_ms, _ = paired_ms(lambda: fused_mel(frames, *args), lambda: mel_plain(frames, *args))
    n_fft, n_bins, n_mels = 1024, mel.w_re.shape[-1], 128
    flops = 2.0 * 2048 * n_fft * n_bins * 2 + 2.0 * 2048 * n_bins * n_mels
    # the padded signal (the frames overlap in it), the two DFT matrices and
    # the filterbank read once, the mels written once
    nbytes = 4 * (padded.numel() + 2 * n_fft * n_bins + n_bins * n_mels + 2048 * n_mels)
    bound_ms, bound_by = bound(flops, nbytes, torch.float32)
    print(f"fused_mel N2048: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          "no single PyTorch call computes the mel")
    return {"name": "fused_mel", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/fused_mel.cu",
            "replaces": "mapperatorinator_tpu/ops/mel_kernel.py:72", "max_abs_err": err, "tol": MEL_TOL,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "timed_shape": "N2048 1024->513->128 log1p fp32"}


def check_qmm(report: dict) -> dict:
    """Kernel D against its plain version at the v32 shapes in fp32 and bf16,
    each timed beside ``F.linear`` on the weight dequantized in advance."""
    from mapperatorinator_tpu_torch.models.transformer import quantize_weight
    from mapperatorinator_tpu_torch.ops.qmm_kernel import qmm, qmm_plain

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
            w_lin = (wq.float() * scale).T.contiguous().to(dtype)  # (N, K), what F.linear takes
            ms, plain_ms, library_ms = paired_ms(lambda: qmm(x, wq, scale), lambda: qmm_plain(x, wq, scale),
                                                 lambda: torch.nn.functional.linear(x, w_lin))
            esize = x.element_size()
            # the int8 weight, x and the scale read once, the output written once
            bound_ms, bound_by = bound(2.0 * rows * k * n, k * n + rows * k * esize + rows * n * esize + 4 * n, dtype)
            label = f"qmm {str(dtype)[6:]} rows{rows} K{k} N{n}"
            print(f"{label}: max_abs_err {err:.3e} (tol {tol:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"F.linear {library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
            case = {"dtype": str(dtype), "rows": rows, "K": k, "N": n, "max_abs_err": err, "tol": tol, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
            if (rows, k, n) in QMM_PROFILED:
                case["device_ms"] = {"kernel": device_ms(lambda: qmm(x, wq, scale)),
                                     "plain": device_ms(lambda: qmm_plain(x, wq, scale)),
                                     "library": device_ms(lambda: torch.nn.functional.linear(x, w_lin))}
                print(f"{label}, device time per call (profiler): kernel {case['device_ms']['kernel']:.4f} ms, "
                      f"plain {case['device_ms']['plain']:.4f} ms, F.linear {case['device_ms']['library']:.4f} ms")
            report["qmm_cases"].append(case)
            if got.shape != (rows, n) or got.dtype != dtype or not err <= tol:
                raise AssertionError(f"{label}: error {err} above {tol}, or shape {tuple(got.shape)} {got.dtype}")
            if dtype == torch.float32 and (rows, k, n) == QMM_TIMED:
                timed = case
    return {"name": "qmm", "route": "cuda", "source": "mapperatorinator_tpu_torch/csrc/qmm.cu",
            "replaces": "mapperatorinator_tpu/ops/qmm_kernel.py:80", "max_abs_err": timed["max_abs_err"],
            "tol": timed["tol"], "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"], "library_ms": timed["library_ms"], "device_ms": timed["device_ms"],
            "timed_shape": "rows1 K768 N3072 fp32 (a decode step's fc1)"}


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
    from mapperatorinator_tpu_torch.ops.attention_kernel import flash_attention
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
    flash_attention.launches = fused_mel.launches = qmm.launches = 0
    t0 = time.perf_counter()
    text, path = inference.generate(args, generation_config=generation_config, beatmap_config=beatmap_config,
                                    engine=engine, vocab=vocab, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention.launches, "fused_mel": fused_mel.launches,
                "qmm": qmm.launches}
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


def profile_decode(engine, enc, ids, pipeline, eos, steps: int = 48) -> dict:
    """Greedy decode steps on ``engine``: host ms a step without the profiler,
    then, profiled, device ms and kernel launches a step and the device time
    of kernel D's launches."""
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
    kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device = sum(e.self_device_time_total for e in kernels) / 1e3
    qmm_events = [e for e in kernels if "qmm_" in e.key]
    qmm_calls = sum(e.count for e in qmm_events)
    return {"steps": n, "host_ms_per_step": wall, "device_ms_per_step": device / n,
            "kernels_per_step": sum(e.count for e in kernels) / n,
            "qmm_device_ms_per_step": sum(e.self_device_time_total for e in qmm_events) / 1e3 / n,
            "qmm_device_us_per_call": sum(e.self_device_time_total for e in qmm_events) / max(qmm_calls, 1)}


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
        steps = {"int8": profile_decode(engine, enc, first["ids"][:1], *greedy_chain),
                 "fp32": profile_decode(fp_engine, fp_enc, first["ids"][:1], *greedy_chain)}
        for name, st in steps.items():
            print(f"request 3 decode steps, {name} weights and KV: {st['host_ms_per_step']:.2f} ms a step on the host "
                  f"clock; profiled, {st['device_ms_per_step']:.3f} ms of device kernels and "
                  f"{st['kernels_per_step']:.0f} launches a step, kernel D {st['qmm_device_ms_per_step']:.3f} ms "
                  f"({st['qmm_device_us_per_call']:.2f} us a call)")
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


def check_gradients(ors: Path, report: dict) -> None:
    """On the first training batch, in fp32 at batch 2: the loss and every
    parameter gradient through the kernels (B forward, C backward) against
    the plain attention path."""
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.ops.attention_kernel import flash_attention, flash_attention_bwd
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.step import to_device

    args = load_train_config("v32", data_overrides(ors) + ["mixed_precision=no", "dataloader.num_workers=0"])
    model, _, make_batches = train_main.build_model_and_data(args, torch.device("cuda"))
    batch = to_device({k: v[:2] for k, v in next(iter(make_batches(test=False))).items()}, "cuda")

    def loss_and_grads(flash: bool):
        set_flash(model, flash)
        model.zero_grad(set_to_none=True)
        _, loss = model(**batch)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}

    fwd, bwd = flash_attention.launches, flash_attention_bwd.launches
    loss_k, grads_k = loss_and_grads(True)
    if flash_attention.launches == fwd or flash_attention_bwd.launches == bwd:
        raise AssertionError("the fp32 gradient check did not run through kernels B and C")
    loss_p, grads_p = loss_and_grads(False)
    worst = max(((grads_k[n] - g).abs().max() / g.abs().max().clamp(min=1e-30)).item() for n, g in grads_p.items())
    print(f"training gradients, first batch, fp32, B2, kernels B+C vs plain attention: loss {loss_k:.6f} vs "
          f"{loss_p:.6f}, {len(grads_p)} gradient tensors, largest error relative to the tensor's largest entry "
          f"{worst:.3e} (tol {GRAD_TOL:g})")
    report["training"]["gradient_check"] = {"loss_kernels": loss_k, "loss_plain": loss_p, "tensors": len(grads_p),
                                            "worst_relative": worst, "tol": GRAD_TOL}
    if sorted(grads_k) != sorted(grads_p) or len(grads_p) != len(list(model.parameters())):
        raise AssertionError("the two paths reached different parameters")
    if not (math.isfinite(loss_k) and abs(loss_k - loss_p) <= GRAD_TOL * abs(loss_p) and worst <= GRAD_TOL):
        raise AssertionError(f"gradients through the kernels disagree: loss {loss_k} vs {loss_p}, worst {worst}")
    del model, grads_k, grads_p, batch
    torch.cuda.empty_cache()


def train_phase(tmp: Path, report: dict) -> dict:
    from mapperatorinator_tpu_torch.config import load_train_config
    from mapperatorinator_tpu_torch.ops.attention_kernel import flash_attention, flash_attention_bwd
    from mapperatorinator_tpu_torch.train import main as train_main
    from mapperatorinator_tpu_torch.train.loop import CheckpointManager, batch_tokens, card_line
    from mapperatorinator_tpu_torch.train.optim import build_optimizer
    from mapperatorinator_tpu_torch.train.step import TrainState, make_train_step, named_flax_params

    t0 = time.perf_counter()
    ors = write_ors(tmp / "ors")
    print(f"ors dataset: {ORS_TRACKS} tracks x {ORS_MAPS} maps, {ORS_SECONDS:g} s of audio each, written in "
          f"{time.perf_counter() - t0:.1f} s")
    report["training"] = {}
    check_gradients(ors, report)

    ckpt, logs = tmp / "ckpt", tmp / "logs"
    overrides = data_overrides(ors) + [
        f"optim.batch_size={TRAIN_BATCH}", f"optim.grad_acc={TRAIN_GRAD_ACC}", f"optim.total_steps={TRAIN_MICRO_STEPS}",
        "dataloader.balancer_buffer_size=0", "eval.every_steps=0", "checkpoint.every_steps=1000000",
        f"checkpoint_path={ckpt}", "logging.every_steps=1", "logging.log_with=none"]
    print(f"training cuts: {TRAIN_MICRO_STEPS} micro-steps ({TRAIN_MICRO_STEPS // TRAIN_GRAD_ACC} updates) of v32's "
          f"batch {TRAIN_BATCH} x grad_acc {TRAIN_GRAD_ACC}; no eval; token balancer off (its 2048-sample buffer "
          "outlasts the run); width and depth as published")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    state = train_main.main(["-cn", "v32", *overrides], log_dir=str(logs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention_fwd": flash_attention.launches, "flash_attention_bwd": flash_attention_bwd.launches}

    b = state.model.cfg.backbone
    if (b.d_model, b.encoder_layers, b.decoder_layers, b.decoder_heads, b.encoder_ffn, b.dtype) != \
            (768, 12, 12, 12, 3072, torch.bfloat16):
        raise AssertionError(f"not the full-width bf16 v32 backbone: {b}")
    records = [json.loads(line) for line in (logs / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "train/loss" in r]
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
    if launches["flash_attention_fwd"] == 0 or launches["flash_attention_bwd"] == 0:
        raise AssertionError(f"an attention kernel never launched in training: {launches}")
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
    events = [e for e in prof.key_averages() if e.device_time_total > 0 and not e.key.startswith(
        ("autograd::", "FlashAttention", "aten::", "Memcpy", "Memset"))]
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mapperatorinator_tpu_torch.ops import _build
    from mapperatorinator_tpu_torch.train.loop import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(exist_ok=True)
    report = {"attention_cases": [], "attention_bwd_cases": [], "qmm_cases": [], "requests": []}
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")

    t0 = time.perf_counter()
    logs = _build.build("flash_attention", "fused_mel", "qmm", "difficulty")
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = logs
    print(f"built flash_attention.cu, fused_mel.cu and qmm.cu for sm_90a and difficulty.cpp in "
          f"{report['build_s']:.1f} s")

    kernels = [check_attention(report), check_mel(report), check_attention_bwd(report), check_qmm(report)]

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = write_wav(tmp / "song.wav", AUDIO_SECONDS)
        first = serve("1-v32-default", tmp, wav, [], report, check_encoder=True)
        second = serve("2-greedy-fused-mel", tmp, wav,
                       ["do_sample=false", "train.model.spectrogram.implementation=pallas"],
                       report, check_encoder=False)
        third = int8_request(tmp, wav, report)
        if first["flash_attention_fwd"] == 0 or second["flash_attention_fwd"] == 0 or second["fused_mel"] == 0 \
                or third["qmm"] == 0 or third["flash_attention_fwd"] == 0:
            raise AssertionError(f"a kernel of the serving path never launched: {first}, {second}, {third}")
        trained = train_phase(tmp, report)
    served = {k: first[k] + second[k] + third[k] for k in first}
    launches = {"fused_mel": served["fused_mel"], "qmm": served["qmm"],
                "flash_attention_fwd": served["flash_attention_fwd"] + trained["flash_attention_fwd"],
                "flash_attention_bwd": trained["flash_attention_bwd"]}
    report["launches_by_path"] = {"serving": served, "int8 serving (request 3)": third, "training": trained}
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
    if loaded:
        raise AssertionError(f"the port's path imported {loaded}")
    report["card"] = card
    report["kernels"] = kernels
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
