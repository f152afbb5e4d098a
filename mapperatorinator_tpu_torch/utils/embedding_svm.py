"""Linear probe over a DiT checkpoint's style embeddings, on the port (the
repo's ``utils/embedding_svm.py``): fits a classifier on a labelled subset
of the ``y_embedder`` table (:func:`.plot_embeddings.load_style_embeddings`)
and scores every row, e.g. a "clean style" probe. Labels come from a
two-column csv ``idx,label`` (0/1).

    python -m mapperatorinator_tpu_torch.utils.embedding_svm --ckpt diffusion_checkpoints/final \\
        --labels labels.csv [--metadata beatmap_df.parquet] [--top 20]

With ``sklearn`` the probe is a calibrated linear SVM; without it (as on
the GPU machine) a least-squares fit with a logistic read-out. The
``--metadata`` table, which names the top rows, is read without pandas
(:func:`.plot_embeddings.metadata_table`). It runs on the host.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .plot_embeddings import load_style_embeddings, metadata_table


def fit_probe(embeddings, labeled: dict):
    """Returns (classifier, train_accuracy). Labeled: {row_index: 0/1}."""
    import numpy as np

    idx = np.asarray(sorted(labeled))
    x, y = embeddings[idx], np.asarray([labeled[i] for i in idx])
    try:
        from sklearn.calibration import CalibratedClassifierCV
        from sklearn.svm import LinearSVC

        base = LinearSVC()
        clf = CalibratedClassifierCV(base, cv=min(3, max(2, int(np.bincount(y).min()))))
        clf.fit(x, y)
        acc = float((clf.predict(x) == y).mean())
        return clf, acc
    except ImportError:  # least-squares fallback keeps the tool usable
        w, *_ = np.linalg.lstsq(
            np.concatenate([x, np.ones((len(x), 1))], 1), y * 2.0 - 1.0, rcond=None
        )

        class _LstSq:
            def predict_proba(self, e):
                s = np.concatenate([e, np.ones((len(e), 1))], 1) @ w
                p = 1.0 / (1.0 + np.exp(-s))
                return np.stack([1 - p, p], 1)

            def predict(self, e):
                return (self.predict_proba(e)[:, 1] > 0.5).astype(int)

        clf = _LstSq()
        acc = float((clf.predict(x) == y).mean())
        return clf, acc


def read_labels(path: str) -> dict:
    """{row index: 0/1} from an ``idx,label`` csv (a header and ``#`` lines
    skipped)."""
    labeled = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if not line or line.startswith("#") or line.lower().startswith("idx"):
            continue
        i, lab = line.split(",")[:2]
        labeled[int(i)] = int(lab)
    return labeled


def run(args) -> dict:
    """Fits the probe, prints the ``--top`` rows by probability; returns
    {"accuracy": train accuracy, "probs": every row's probability}."""
    emb = load_style_embeddings(args.ckpt, args.num_classes, args.vocab)
    labeled = read_labels(args.labels)
    clf, acc = fit_probe(emb, labeled)
    probs = clf.predict_proba(emb)[:, 1]
    print(f"probe fitted on {len(labeled)} labels, train accuracy {acc:.3f}")

    titles = {}
    if args.metadata:
        index, rows = metadata_table(args.metadata)
        titles = {i: str(r.get("Title", "")) for i, r in zip(index, rows)}
    order = np.argsort(probs)[::-1][: args.top]
    for i in order:
        print(f"{probs[i]:.3f}  idx={i}  {titles.get(int(i), '')}")
    return {"accuracy": acc, "probs": probs}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--labels", type=str, required=True, help="csv of idx,label (0/1)")
    p.add_argument("--metadata", type=str, default=None)
    p.add_argument("--vocab", type=str, default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--top", type=int, default=20)
    return p.parse_args(argv)


if __name__ == "__main__":
    run(parse_args())
