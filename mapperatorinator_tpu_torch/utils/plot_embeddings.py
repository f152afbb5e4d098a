"""2-D view of a DiT checkpoint's learned per-beatmap style embeddings, on
the port (the repo's ``utils/plot_embeddings.py``). The DiT embeds a one-hot
class vector through an MLP (``models/dit.py`` ``LabelEmbedder``), so the
per-beatmap table is the beatmap-style block, input rows ``[0,
num_classes)``, of the first Dense kernel, read from the bundle's
``params.msgpack`` without the ``msgpack`` package.

    python -m mapperatorinator_tpu_torch.utils.plot_embeddings --ckpt diffusion_checkpoints/final \\
        [--vocab tokenizer.json | --num-classes N] [--metadata beatmaps.parquet --title-col Title] \\
        [--method tsne|pca] [--out embeddings.png] [--annotate 20]

t-SNE needs ``sklearn``, and falls back to PCA without it; the plot needs
matplotlib, and a ``--metadata`` table pandas. Where one is missing the
tool says so and prints the 2-D points instead. It runs on the host.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import numpy as np

from ..diffusion.vocab import DiffusionVocab
from ..models.io import read_flax_msgpack
from ..train.data.parquet import as_python, read_table as read_parquet, table_row


def load_style_embeddings(ckpt: str, num_classes: int | None = None, vocab_path: str | None = None):
    """(num_classes, hidden) float32 rows of the y_embedder fc1 kernel."""
    tree = read_flax_msgpack(Path(ckpt) / "params.msgpack")
    params = tree.get("params", tree)
    kernel = np.asarray(params["y_embedder"]["fc1"]["kernel"])  # (class_size, hidden)

    if vocab_path:
        num_classes = DiffusionVocab.from_pretrained(vocab_path).num_classes
    if not num_classes:
        num_classes = kernel.shape[0]  # whole class vector when unspecified
    return kernel[:num_classes]


def reduce_2d(embeddings, method: str = "tsne", seed: int = 1):
    import numpy as np

    if method == "tsne":
        try:
            from sklearn.manifold import TSNE

            perplexity = min(30.0, max(2.0, embeddings.shape[0] / 4))
            return TSNE(n_components=2, random_state=seed, init="pca",
                        perplexity=perplexity).fit_transform(embeddings)
        except ImportError:
            print("sklearn unavailable; falling back to PCA")
    centered = embeddings - embeddings.mean(0, keepdims=True)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T


def read_table(path: str):
    """A parquet or csv table as a pandas DataFrame, or None (printed) where
    pandas is not installed."""
    try:
        import pandas as pd
    except ImportError:
        print(f"pandas is not installed: {path} not read")
        return None
    table = Path(path)
    return pd.read_parquet(table) if table.suffix == ".parquet" else pd.read_csv(table)


def metadata_table(path: str) -> tuple[list, list[dict]]:
    """(index labels, rows) of a beatmap table without pandas: a parquet
    file through the port's reader (the labels and cells as pandas gives
    them), a csv through the ``csv`` module (labels 0, 1, ...; cells as
    text)."""
    table = Path(path)
    if table.suffix == ".parquet":
        columns, index = read_parquet(table)
        return [as_python(label) for label in index], [table_row(columns, i) for i in range(len(index))]
    with open(table, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return list(range(len(rows))), rows


def run(args) -> np.ndarray:
    """The 2-D points, one a class; drawn to ``args.out`` where matplotlib is
    installed, printed where it is not."""
    emb = load_style_embeddings(args.ckpt, args.num_classes, args.vocab)
    pts = reduce_2d(emb, args.method, args.seed)
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {args.out} not drawn; the {len(pts)} points ({args.method}):")
        for i, (x, y) in enumerate(pts[: args.annotate]):
            print(f"{i:6d}  {x:+.4f}  {y:+.4f}")
        return pts
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(13, 9))
    ax.scatter(pts[:, 0], pts[:, 1], alpha=max(0.02, min(1.0, 2000 / len(pts))), s=6)
    ax.set_title(f"DiT style embeddings ({len(pts)} classes, {args.method})")

    df = read_table(args.metadata) if args.metadata else None
    if df is not None:
        n = min(args.annotate, len(df), len(pts))
        sample = df.sample(n, random_state=args.seed) if len(df) > n else df
        for idx, row in sample.iterrows():
            if 0 <= idx < len(pts):
                ax.annotate(str(row.get(args.title_col, idx))[:30], pts[idx], fontsize=7, alpha=0.8)

    out = Path(args.out)
    fig.savefig(out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {out} ({len(pts)} embeddings)")
    return pts


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--vocab", type=str, default=None, help="DiffusionVocab json (sets num_classes)")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--metadata", type=str, default=None, help="parquet/csv with per-idx labels")
    p.add_argument("--title-col", type=str, default="Title")
    p.add_argument("--annotate", type=int, default=20)
    p.add_argument("--method", choices=["tsne", "pca"], default="tsne")
    p.add_argument("--out", type=str, default="embeddings.png")
    p.add_argument("--seed", type=int, default=1)
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
