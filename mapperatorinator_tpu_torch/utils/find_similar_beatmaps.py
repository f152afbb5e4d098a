"""Nearest style-embedding neighbours of a beatmap, on the port (the repo's
``utils/find_similar_beatmaps.py``): distances over the DiT bundle's
``y_embedder`` table (:func:`.plot_embeddings.load_style_embeddings`) from a
query class. Annotates the results from a ``create_beatmap_dataframe``
table where one is given and pandas is installed.

    python -m mapperatorinator_tpu_torch.utils.find_similar_beatmaps --ckpt diffusion_checkpoints/final \\
        (--idx N | --beatmap-id ID --vocab tokenizer.json) [--metadata beatmap_df.parquet] [-k 10] [--num-classes N]

It runs on the host.
"""

from __future__ import annotations

import argparse

from ..diffusion.vocab import DiffusionVocab
from .plot_embeddings import load_style_embeddings, read_table


def nearest(embeddings, idx: int, k: int = 10):
    import numpy as np

    query = embeddings[idx]
    dist = np.linalg.norm(embeddings - query[None], axis=1)
    order = np.argsort(dist)
    return [(int(i), float(dist[i])) for i in order[: k + 1] if i != idx][:k]


def run(args) -> list:
    emb = load_style_embeddings(args.ckpt, args.num_classes, args.vocab)
    idx = args.idx
    if idx is None:
        if args.beatmap_id is None or not args.vocab:
            raise ValueError("pass --idx, or --beatmap-id together with --vocab")
        idx = DiffusionVocab.from_pretrained(args.vocab).beatmap_idx[args.beatmap_id]

    titles = {}
    df = read_table(args.metadata) if args.metadata else None
    if df is not None:
        titles = {i: f"{r.get('Title', '?')} [{r.get('BeatmapName', r.get('Version', '?'))}]"
                  for i, r in df.iterrows()}

    results = nearest(emb, idx, args.k)
    for i, d in results:
        print(f"{i:6d}  dist={d:.4f}  {titles.get(i, '')}")
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--idx", type=int, default=None, help="style-class index to query")
    p.add_argument("--beatmap-id", type=int, default=None)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("-k", type=int, default=10)
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
