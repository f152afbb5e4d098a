"""Distance-delta comparison between a reference beatmap and generated
variants, on the port (the repo's ``utils/distance_distance.py``): per-map
MSE/MAE of consecutive-object distances, and a delta histogram saved where
matplotlib is installed. Accepts a single ``.osu`` or a directory of them.

    python -m mapperatorinator_tpu_torch.utils.distance_distance --ref-beatmap original.osu \\
        --beatmap generated_dir_or_file [--out-dir plots/]

It runs on the host, on the port's copies of ``diffusion/data.py`` and
``osu/beatmap.py``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..diffusion.data import beatmap_to_sequence, calc_distances
from ..osu.beatmap import Beatmap


def compare(ref_path: str, gen_path: str) -> dict | None:

    ref_d = calc_distances(beatmap_to_sequence(Beatmap.from_path(ref_path)))
    beatmap = Beatmap.from_path(gen_path)
    gen_d = calc_distances(beatmap_to_sequence(beatmap))
    if len(gen_d) != len(ref_d):
        return None  # reference semantics: silently skip length mismatches
    delta = ref_d - gen_d
    return {
        "name": beatmap.version or Path(gen_path).stem,
        "mse": float(np.mean(np.square(delta))),
        "mae": float(np.mean(np.abs(delta))),
        "delta": delta,
    }


def run(args) -> list:
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None
        print("matplotlib is not installed: the histograms are not drawn")

    target = Path(args.beatmap)
    paths = sorted(target.glob("*.osu")) if target.is_dir() else [target]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    results = []
    for path in paths:
        r = compare(args.ref_beatmap, str(path))
        if r is None:
            print(f"{path.name}: length mismatch, skipped")
            continue
        print(f"{r['name']}: MSE = {r['mse']:.3f}, MAE = {r['mae']:.3f}")
        if plt is not None:
            fig, ax = plt.subplots()
            ax.hist(r["delta"], bins=np.linspace(-20, 20, 42), alpha=0.75, color="b", edgecolor="k")
            ax.set_xlabel("Distance")
            ax.set_ylabel("Frequency")
            ax.set_title(f"Distance similarity gen. beatmap [{r['name']}]")
            ax.grid(True)
            out = out_dir / f"distance_{path.stem}.png"
            fig.savefig(out, dpi=120, bbox_inches="tight")
            plt.close(fig)
            r["plot"] = str(out)
        results.append(r)
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ref-beatmap", type=str, required=True)
    p.add_argument("--beatmap", type=str, required=True, help=".osu file or directory of them")
    p.add_argument("--out-dir", type=str, default=".")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
