"""Star-rating histogram over a dataset, on the port (the repo's
``plot_difficulties.py``), computed with the port's native difficulty
calculator (``native/difficulty.py`` over ``csrc/difficulty.cpp``, which
``ops/_build.py`` builds with g++ on first use).

    python -m mapperatorinator_tpu_torch.plot_difficulties dataset_path [start] [end] [-o difficulties.png]

The histogram is printed; ``-o`` also draws it where matplotlib is
installed, and says so where it is not. It runs on the host.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from .native import calculate_difficulty


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = None
    if "-o" in argv:
        i = argv.index("-o")
        out = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    root = Path(argv[0])
    start = int(argv[1]) if len(argv) > 1 else 0
    end = int(argv[2]) if len(argv) > 2 else start + 100

    stars = []
    for i in range(start, end):
        beatmaps = root / f"Track{i:05d}" / "beatmaps"
        if not beatmaps.is_dir():
            continue
        for p in sorted(beatmaps.glob("*.osu")):
            s = calculate_difficulty(path=p)
            if s is not None:
                stars.append(s)
    if not stars:
        print("no beatmaps found")
        return []
    stars_arr = np.array(stars)
    print(f"{len(stars)} beatmaps: min {stars_arr.min():.2f} median {np.median(stars_arr):.2f} "
          f"mean {stars_arr.mean():.2f} max {stars_arr.max():.2f}")
    hist, edges = np.histogram(stars_arr, bins=20)
    for h, e in zip(hist, edges):
        print(f"{e:5.2f}* {'#' * int(50 * h / max(hist.max(), 1))}")
    if out:
        try:
            import matplotlib
        except ImportError:
            print(f"matplotlib is not installed: {out} not drawn")
            return stars
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        plt.hist(stars_arr, bins=40)
        plt.xlabel("star rating")
        plt.ylabel("beatmaps")
        plt.savefig(out)
        print(f"wrote {out}")
    return stars


if __name__ == "__main__":
    main()
