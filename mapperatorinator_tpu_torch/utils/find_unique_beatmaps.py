"""Beatmaps ranked by style distance from a mapper's body of work, on the
port (the repo's ``utils/find_unique_beatmaps.py``): the mean distance of
each row of the DiT checkpoint's ``y_embedder`` table
(:func:`.plot_embeddings.load_style_embeddings`) from the mapper's rows,
largest first. The mapper's maps are the rows of a
``create_beatmap_dataframe`` table whose ``Creator`` column names them,
read without pandas (:func:`.plot_embeddings.metadata_table`).

    python -m mapperatorinator_tpu_torch.utils.find_unique_beatmaps --ckpt diffusion_checkpoints/final \\
        --metadata beatmap_df.parquet --creator Sotarks [-k 10] [--nearest]

It runs on the host.
"""

from __future__ import annotations

import argparse

from .plot_embeddings import load_style_embeddings, metadata_table


def rank_by_mean_distance(embeddings, query_rows, k: int = 10, farthest: bool = True):
    import numpy as np

    query = embeddings[query_rows]                      # (Q, H)
    dist = np.linalg.norm(embeddings[:, None] - query[None], axis=-1).mean(1)
    order = np.argsort(dist)
    if farthest:
        order = order[::-1]
    return [(int(i), float(dist[i])) for i in order[:k]]


def run(args) -> list:
    """Prints and returns [(row, mean distance)], ``-k`` of them."""
    emb = load_style_embeddings(args.ckpt, args.num_classes, args.vocab)
    index, table = metadata_table(args.metadata)
    rows = [i for i, r in zip(index, table) if r.get("Creator") == args.creator and 0 <= i < len(emb)]
    if not rows:
        raise ValueError(f"no beatmaps by {args.creator!r} within the embedding table")
    print(f"Found {len(rows)} beatmaps by {args.creator}.")

    results = rank_by_mean_distance(emb, rows, args.k, farthest=not args.nearest)
    for i, d in results:
        row = table[i] if i < len(table) else {}
        print(f"{d:.4f}  {row.get('Title', '?')} [{row.get('BeatmapName', '?')}] "
              f"{row.get('BeatmapID', '?')}")
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--metadata", type=str, required=True)
    p.add_argument("--creator", type=str, required=True)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--nearest", action="store_true",
                   help="rank nearest instead of farthest (most typical maps)")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
