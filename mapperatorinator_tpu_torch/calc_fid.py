"""The generation-quality harness on the port (``calc_fid.py``): regenerates
the beatmaps of a held-out set and compares the distributions: FID over the
classifier's feature vectors and over CM3P's beatmap embeddings (each with
the self-similarity RMSE), rhythm precision, recall and F1 against the real
maps, and the drain, BPM and star-rating mean squared errors.

    python -m mapperatorinator_tpu_torch.calc_fid dataset_path=... dataset_start=.. dataset_end=.. \\
        inference.model_path=... [classifier_ckpt=DIR] [cm3p_ckpt=DIR] [skip_generation=true] \\
        [num_processes=N] [inference.device=cpu]

Generation runs through the port's ``inference.generate``: inline where
``num_processes`` <= 0, else in spawned workers that each load the engine
on the card (``inference.device``). The classifier and CM3P run on the
device ``inference.device`` selects. The dataset scan reads ``ors`` track
folders or an ``mmrs`` root (its ``metadata.parquet`` through the port's
parquet reader). The host code is the JAX script's
(``tests/test_torch_nojax.py`` holds it to it).
"""

from __future__ import annotations

import json
import multiprocessing
import sys
from pathlib import Path

import numpy as np
import torch

from .audio.io import load_audio_file
from .classifier_classify import create_example
from .config import load_config, load_fid_config, select_device
from .eval import (
    calculate_f1,
    calculate_precision,
    calculate_recall,
    calculate_rhythm_stats,
    compute_fid_from_features,
    get_rhythm,
)
from .inference import compile_args, generate, get_config, load_model
from .models.classifier import load_classifier_bundle
from .models.cm3p import extract_cm3p_features, load_cm3p
from .native import calculate_difficulty
from .osu import Beatmap, BeatmapParser
from .utils.batched_apply import batched_apply

def get_beatmap_paths(args) -> list[Path]:
    """Flat path list over all requested gamemodes."""
    return [p for paths in get_beatmap_paths_by_gamemode(args).values() for p in paths]


def get_beatmap_paths_by_gamemode(args) -> dict[int, list[Path]]:
    """Dataset scan grouped by gamemode with year/difficulty filters
    (reference: calc_fid.py:288-356). ORS reads Mode from each .osu; MMRS
    filters the parquet metadata."""
    root = Path(args.dataset_path)
    by_gm: dict[int, list[Path]] = {}

    if args.dataset_type == "mmrs":
        from .train.data.mmrs import (
            filter_mmrs_metadata,
            load_mmrs_metadata,
        )

        df = load_mmrs_metadata(root)
        df = filter_mmrs_metadata(
            df,
            start=args.dataset_start,
            end=args.dataset_end,
            gamemodes=list(args.gamemodes),
            min_year=args.min_year,
            max_year=args.max_year,
            min_difficulty=args.min_difficulty,
            max_difficulty=args.max_difficulty,
        )
        for _, item in df.iterrows():
            gm = int(item["ModeInt"])
            by_gm.setdefault(gm, []).append(
                root / "data" / item["BeatmapSetFolder"] / item["BeatmapFile"]
            )
    elif args.dataset_type == "ors":
        for i in range(args.dataset_start, args.dataset_end):
            beatmaps = root / f"Track{i:05d}" / "beatmaps"
            if not beatmaps.is_dir():
                continue
            for p in sorted(beatmaps.glob("*.osu")):
                try:
                    bm = Beatmap.from_path(p)
                except Exception:
                    continue
                if bm.mode in args.gamemodes:
                    by_gm.setdefault(bm.mode, []).append(p)
    else:
        raise ValueError(f"Unknown dataset type: {args.dataset_type}")

    return dict(sorted(by_gm.items()))


def test_training_set_overlap(beatmap_paths: list[Path], training_set_ids_path) -> dict:
    """Report how many held-out maps leak from the training set
    (reference: calc_fid.py:758-779)."""
    if not training_set_ids_path:
        return {}
    path = Path(training_set_ids_path)
    if not path.exists():
        print(f"training set IDs file {path} does not exist")
        return {}
    with open(path, encoding="utf-8") as f:
        ids = {int(line.strip()) for line in f if line.strip()}
    in_set = out_set = 0
    for p in beatmap_paths:
        try:
            bm = Beatmap.from_path(p)
        except Exception:
            continue
        if bm.beatmap_id in ids:
            in_set += 1
        else:
            out_set += 1
    total = in_set + out_set
    ratio = in_set / total if total else 0.0
    print(f"In training set: {in_set}, not in training set: {out_set}, ratio: {ratio:.2f}")
    return {"training_set_overlap": {"in": in_set, "out": out_set, "ratio": ratio}}


def generate_beatmaps(beatmap_paths, args, engine, vocab, logger=None) -> dict:
    """Regenerate each beatmap with metadata autofill from the original."""

    results = {}
    for path in beatmap_paths:
        i_args = load_config("v32")
        # copy user inference settings
        for field in ("model_path", "seed", "cfg_scale", "temperature", "top_p", "parallel"):
            setattr(i_args, field, getattr(args.inference, field))
        i_args.beatmap_path = str(path)
        audio_candidates = list(path.parents[1].glob("audio.*"))  # ORS layout
        if audio_candidates:
            i_args.audio_path = str(audio_candidates[0])
        i_args.output_path = str(_generated_dir(path, args))
        i_args.train = args.inference.train
        compile_args(i_args, vocab, verbose=False)
        generation_config, beatmap_config = get_config(i_args)
        try:
            result, result_path = generate(
                i_args,
                generation_config=generation_config,
                beatmap_config=beatmap_config,
                engine=engine,
                vocab=vocab,
                verbose=False,
            )
            results[str(path)] = str(result_path)
        except Exception as e:

            traceback.print_exc()
            print(f"generation failed for {path}: {e}")
    return results


def rhythm_report(pairs: list[tuple[Path, Path]]) -> dict:
    """Active and passive rhythm P/R/F1 (reference: calc_fid.py:733-755)."""
    results = {}
    for name, passive in (("active", False), ("passive", True)):
        totals = {"true_positives": 0, "false_positives": 0, "false_negatives": 0}
        for real_path, gen_path in pairs:
            real = get_rhythm(Beatmap.from_path(real_path), passive=passive)
            gen = get_rhythm(Beatmap.from_path(gen_path), passive=passive)
            stats = calculate_rhythm_stats(real, gen)
            for k in totals:
                totals[k] += stats[k]
        results[f"{name}_rhythm_precision"] = calculate_precision(totals)
        results[f"{name}_rhythm_recall"] = calculate_recall(totals)
        results[f"{name}_rhythm_f1"] = calculate_f1(totals)
    return results


def drain_time_seconds(beatmap: Beatmap, break_threshold_seconds: float = 8.0) -> float:
    """First-to-last hit object span minus gaps over the break threshold
    (reference: calc_fid.py:42-64)."""
    times = sorted(int(h.time) for h in beatmap.hit_objects(stacking=False))
    if len(times) < 2 or times[-1] <= times[0]:
        return 0.0
    thresh = break_threshold_seconds * 1000
    breaks = sum(b - a for a, b in zip(times, times[1:]) if b - a > thresh)
    return max(0.0, (times[-1] - times[0] - breaks) / 1000.0)


def _bpm_segments(beatmap: Beatmap) -> list[tuple[float, float]]:
    """Piecewise-constant BPM from redlines (reference: calc_fid.py:85-111)."""
    segs = []
    for tp in sorted(beatmap.timing_points, key=lambda t: t.offset):
        if tp.bpm:
            segs.append((tp.offset / 1000.0, float(tp.bpm)))
    if not segs:
        return [(0.0, 0.0)]
    deduped: list[tuple[float, float]] = []
    for s, bpm in segs:
        if deduped and abs(deduped[-1][0] - s) < 1e-12:
            deduped[-1] = (s, bpm)
        else:
            deduped.append((s, bpm))
    return deduped


def bpm_mse_for_pair(real: Beatmap, gen: Beatmap) -> tuple[float, float]:
    """(integral of squared BPM difference over time, length) — exact over
    the union of change points (reference: calc_fid.py:126-148)."""

    def song_len(bm):
        times = [h.time / 1000.0 for h in bm.hit_objects(stacking=False)]
        return max(times) if times else 0.0

    def bpm_at(segs, t):
        current = segs[0][1]
        for s, bpm in segs:
            if s <= t + 1e-12:
                current = bpm
            else:
                break
        return current

    length = max(song_len(real), song_len(gen))
    if length <= 0:
        return 0.0, 0.0
    r_segs, g_segs = _bpm_segments(real), _bpm_segments(gen)
    cps = sorted(
        {0.0, length}
        | {s for s, _ in r_segs if 0 <= s <= length}
        | {s for s, _ in g_segs if 0 <= s <= length}
    )
    integrated = 0.0
    for a, b in zip(cps, cps[1:]):
        if b <= a:
            continue
        mid = (a + b) / 2
        diff = bpm_at(r_segs, mid) - bpm_at(g_segs, mid)
        integrated += diff * diff * (b - a)
    return integrated, length


def extra_stats(pairs: list[tuple[Path, Path]]) -> dict:
    """Drain MSE, time-integrated BPM MSE, and star-rating MSE (via the
    native difficulty calculator; reference uses rosu — calc_fid.py:600-712)."""

    drain_se, drain_n = 0.0, 0
    bpm_integ, bpm_len = 0.0, 0.0
    sr_se, sr_n = 0.0, 0
    for real_path, gen_path in pairs:
        real = Beatmap.from_path(real_path)
        gen = Beatmap.from_path(gen_path)
        drain_se += (drain_time_seconds(real) - drain_time_seconds(gen)) ** 2
        drain_n += 1
        integ, length = bpm_mse_for_pair(real, gen)
        bpm_integ += integ
        bpm_len += length
        real_sr = calculate_difficulty(path=real_path)
        gen_sr = calculate_difficulty(path=gen_path)
        if real_sr is not None and gen_sr is not None:
            sr_se += (real_sr - gen_sr) ** 2
            sr_n += 1
    out = {}
    if drain_n:
        out["drain_mse"] = drain_se / drain_n
    if bpm_len > 0:
        out["bpm_mse"] = bpm_integ / bpm_len
    if sr_n:
        out["sr_mse"] = sr_se / sr_n
    return out


def load_classifier(args):
    """Load a classifier bundle exported by classifier_train.py: params +
    classifier_config.json + tokenizer.json, on the device that
    ``args.inference.device`` selects. Returns None (with a warning) when
    the checkpoint is missing (reference: calc_fid.py:579-601)."""
    path = Path(args.classifier_ckpt)
    if not (path / "params.msgpack").exists():
        print(f"classifier checkpoint {path} not found; skipping FID")
        return None
    model, clf_args, clf_vocab = load_classifier_bundle(path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return model.to(select_device(args.inference)).eval(), clf_args, clf_vocab


def extract_features(beatmap_path: Path, audio, classifier_bundle, batch_size: int) -> np.ndarray:
    """Mean-pooled projector features for every audio window of a beatmap
    (reference: calc_fid.py:620-680), on the classifier's device."""
    model, clf_args, clf_vocab = classifier_bundle
    parser = BeatmapParser(clf_args, clf_vocab)
    beatmap = Beatmap.from_path(beatmap_path)
    events, event_times = parser.parse(beatmap, 1.0, None, (False, False))

    sr = clf_args.model.spectrogram.sample_rate
    samples_per_seq = (clf_args.data.src_seq_len - 1) * clf_args.model.spectrogram.hop_length
    seq_s = samples_per_seq / sr
    times = np.arange(0, max(len(audio) / sr - seq_s, seq_s / 2), seq_s)

    examples = [create_example(events, event_times, audio, float(t), clf_args, clf_vocab) for t in times]
    device = next(model.parameters()).device

    def apply_fn(batch):
        with torch.inference_mode():
            out = model(*(torch.as_tensor(batch[k], device=device)
                          for k in ("frames", "decoder_input_ids", "decoder_attention_mask")))
        return out["feature_vector"].float().cpu().numpy()

    return batched_apply(examples, batch_size, apply_fn)


def compute_self_similarity(features: np.ndarray, similarity: str = "cosine") -> np.ndarray:
    """Window-feature self-similarity matrix (reference: calc_fid.py:159-170)."""
    if similarity == "dot":
        return features @ features.T
    norms = np.clip(np.linalg.norm(features, axis=1, keepdims=True), 1e-12, None)
    normalized = features / norms
    return normalized @ normalized.T


def _resize_matrix(matrix: np.ndarray, target: int) -> np.ndarray:
    """Bilinear resize to (target, target) (reference: calc_fid.py:192-198;
    torch interpolate replaced with scipy zoom)."""
    if matrix.shape == (target, target):
        return matrix.astype(np.float32)

    factor = target / matrix.shape[0]
    out = zoom(matrix.astype(np.float32), factor, order=1)
    return out[:target, :target]


def ssm_rmse_for_pair(real_features, generated_features, similarity: str = "cosine"):
    """Self-similarity RMSE between real and generated feature sequences
    (reference: calc_fid.py:201-229). Returns None on empty features."""
    if real_features is None or generated_features is None:
        return None
    if real_features.size == 0 or generated_features.size == 0:
        return None
    real = np.clip((compute_self_similarity(real_features, similarity) + 1) / 2, 0, 1)
    gen = np.clip((compute_self_similarity(generated_features, similarity) + 1) / 2, 0, 1)
    target = max(real.shape[0], gen.shape[0])
    real = _resize_matrix(real, target)
    gen = _resize_matrix(gen, target)
    return float(np.sqrt(np.mean((real - gen) ** 2)))


def classifier_fid(pairs, classifier_bundle, args) -> dict:
    """FID between real and generated maps' classifier feature distributions
    (reference: calc_fid.py:579-713)."""
    if classifier_bundle is None:
        return {}

    sr = classifier_bundle[1].model.spectrogram.sample_rate
    real_feats, gen_feats, ssm_errs = [], [], []
    for real_path, gen_path in pairs:
        audio_candidates = list(real_path.parents[1].glob("audio.*"))
        if not audio_candidates:
            continue
        audio = load_audio_file(audio_candidates[0], sr)
        rf = extract_features(real_path, audio, classifier_bundle, args.classifier_batch_size)
        gf = extract_features(gen_path, audio, classifier_bundle, args.classifier_batch_size)
        real_feats.append(rf)
        gen_feats.append(gf)
        err = ssm_rmse_for_pair(rf, gf)
        if err is not None:
            ssm_errs.append(err)
    if not real_feats:
        return {}
    real = np.concatenate(real_feats)
    gen = np.concatenate(gen_feats)
    results = {"fid": compute_fid_from_features(real, gen)}
    if ssm_errs:
        results["ssm_rmse"] = float(np.mean(ssm_errs))
    return results


def cm3p_fid(pairs, args) -> dict:
    """CM3P (audio-beatmap contrastive model) feature FID + self-similarity
    RMSE (reference: calc_fid.py:579-713). Runs when ``args.cm3p_ckpt``
    points at a loadable local checkpoint (native or converted torch dual
    tower — see models/cm3p.py); skips with a clear message otherwise (the
    published hub checkpoint needs network access)."""

    bundle = load_cm3p(args.cm3p_ckpt, select_device(args.inference))
    if bundle is None:
        return {}
    _, config, vocab = bundle
    if vocab is None:
        print(f"CM3P checkpoint {args.cm3p_ckpt} has no tokenizer.json; skipping fid_cm3p")
        return {}

    real_feats, gen_feats, ssm_errs = [], [], []
    for real_path, gen_path in pairs:
        audio_candidates = list(real_path.parents[1].glob("audio.*"))  # ORS layout
        if not audio_candidates:
            continue
        audio = load_audio_file(audio_candidates[0], config.sample_rate)
        rf = extract_cm3p_features(Beatmap.from_path(real_path), audio, bundle,
                                   batch_size=args.cm3p_batch_size)
        gf = extract_cm3p_features(Beatmap.from_path(gen_path), audio, bundle,
                                   batch_size=args.cm3p_batch_size)
        if rf.size == 0 or gf.size == 0:
            continue
        real_feats.append(rf)
        gen_feats.append(gf)
        err = ssm_rmse_for_pair(rf, gf)
        if err is not None:
            ssm_errs.append(err)
    if not real_feats:
        return {}
    results = {"fid_cm3p": compute_fid_from_features(np.concatenate(real_feats),
                                                     np.concatenate(gen_feats))}
    if ssm_errs:
        results["ssm_rmse_cm3p"] = float(np.mean(ssm_errs))
    return results


def _generation_worker(chunk, args, gamemode: int, idx: int) -> None:
    """One fan-out worker: loads the (gamemode-resolved) model on the device
    ``args.inference.device`` selects and regenerates its chunk (reference:
    calc_fid.py:496-578). Results land in <dataset>/generated/<stem>.osu, so
    workers are restart-safe."""
    args.inference.gamemode = gamemode
    engine, vocab = load_model(args.inference)
    generate_beatmaps(chunk, args, engine, vocab)


def _fan_out_generation(paths_by_gm: dict, args) -> None:
    """Per-gamemode round-robin fan-out over num_processes workers
    (reference: calc_fid.py:800-836). num_processes <= 0 runs inline."""

    gamemode_names = {0: "std", 1: "taiko", 2: "catch", 3: "mania"}
    for gm, gm_paths in paths_by_gm.items():
        pending = [p for p in gm_paths if not _already_generated(p, args)]
        print(f"=== Generating {gamemode_names.get(gm, gm)}: "
              f"{len(pending)} of {len(gm_paths)} maps pending ===")
        if not pending:
            continue
        n = max(args.num_processes, 1)
        chunks = [pending[i::n] for i in range(n)]
        if args.num_processes <= 0:
            _generation_worker(chunks[0], args, gm, 0)
            continue

        ctx = multiprocessing.get_context("spawn")
        procs = [
            ctx.Process(target=_generation_worker, args=(chunk, args, gm, i))
            for i, chunk in enumerate(chunks) if chunk
        ]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join()
        failed = [proc.exitcode for proc in procs if proc.exitcode]
        if failed:
            print(f"warning: {len(failed)} generation workers exited nonzero")


def _generated_dir(path: Path, args) -> Path:
    """Per-map output dir. Keyed on set folder + stem: bare stems collide
    across tracks/sets that reuse the same .osu filename."""
    set_name = path.parent.parent.name if path.parent.name == "beatmaps" else path.parent.name
    return Path(args.dataset_path) / "generated" / f"{set_name}_{path.stem}"


def _already_generated(path: Path, args) -> bool:
    out = _generated_dir(path, args)
    return out.is_dir() and any(out.glob("*.osu"))


def _generated_for(path: Path, args):
    out = _generated_dir(path, args)
    found = sorted(out.glob("*.osu")) if out.is_dir() else []
    return found[0] if found else None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    overrides = list(argv)
    args = load_fid_config("calc_fid", overrides)

    paths_by_gm = get_beatmap_paths_by_gamemode(args)
    beatmap_paths = [p for paths in paths_by_gm.values() for p in paths]
    print(f"Evaluating {len(beatmap_paths)} beatmaps across gamemodes {sorted(paths_by_gm)}")

    results = {}
    results.update(test_training_set_overlap(beatmap_paths, args.training_set_ids_path))

    if not args.skip_generation:
        _fan_out_generation(paths_by_gm, args)
    generated = {
        str(p): str(g) for p in beatmap_paths if (g := _generated_for(p, args)) is not None
    }

    pairs = [(Path(r), Path(g)) for r, g in generated.items() if Path(g).exists()]
    if args.rhythm_stats and pairs:
        results.update(rhythm_report(pairs))
    if args.extra_stats and pairs:
        results.update(extra_stats(pairs))
    if args.fid and pairs:
        classifier_bundle = load_classifier(args)
        results.update(classifier_fid(pairs, classifier_bundle, args))
    if args.fid_cm3p and pairs:
        results.update(cm3p_fid(pairs, args))

    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
