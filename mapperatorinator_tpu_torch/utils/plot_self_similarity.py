"""Self-similarity matrix heatmaps for real vs generated beatmaps, on the port
(the repo's ``utils/plot_self_similarity.py``). Embeds windows either with a
local CM3P checkpoint (``--cm3p``, :func:`..models.cm3p.extract_cm3p_features`)
or with the mapper classifier's window features (``--classifier``, the
extractor :mod:`..calc_fid` uses).

    python -m mapperatorinator_tpu_torch.utils.plot_self_similarity real.osu generated.osu audio.wav \\
        --cm3p /path/to/cm3p_ckpt [-o ssm.png] [--device cpu]
    python -m mapperatorinator_tpu_torch.utils.plot_self_similarity real.osu generated.osu audio.wav \\
        --classifier /path/to/classifier_ckpt/final [-o ssm.png] [--device cpu]

The model runs on the card unless ``--device cpu`` is given; there every
attention call of its windows takes kernel B. The RMSE is printed; ``-o``
also draws both matrices where matplotlib is installed, and says so where
it is not.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np

from ..audio.io import load_audio_file
from ..calc_fid import compute_self_similarity, extract_features, load_classifier, ssm_rmse_for_pair
from ..config import select_device
from ..models.cm3p import extract_cm3p_features, load_cm3p
from ..osu import Beatmap


def main(argv=None) -> dict:
    """{"ssm_rmse", "real", "generated"}: the RMSE and the two matrices as
    they are drawn, (cosine + 1) / 2 clipped to [0, 1]."""
    argv = sys.argv[1:] if argv is None else argv
    out = None
    classifier_ckpt = None
    cm3p_ckpt = None
    device = "auto"
    rest = []
    i = 0
    while i < len(argv):
        if argv[i] == "-o":
            out = argv[i + 1]
            i += 2
        elif argv[i] == "--classifier":
            classifier_ckpt = argv[i + 1]
            i += 2
        elif argv[i] == "--cm3p":
            cm3p_ckpt = argv[i + 1]
            i += 2
        elif argv[i] == "--device":
            device = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    real_path, gen_path, audio_path = (Path(p) for p in rest[:3])
    selected = types.SimpleNamespace(device=device)

    if cm3p_ckpt is not None:
        bundle = load_cm3p(cm3p_ckpt, select_device(selected))
        if bundle is None or bundle[2] is None:
            raise SystemExit("a loadable local CM3P checkpoint (with tokenizer.json) is required")
        audio = load_audio_file(audio_path, bundle[1].sample_rate)
        rf = extract_cm3p_features(Beatmap.from_path(real_path), audio, bundle, batch_size=8)
        gf = extract_cm3p_features(Beatmap.from_path(gen_path), audio, bundle, batch_size=8)
    else:
        if classifier_ckpt is None:
            raise SystemExit("a checkpoint is required (--cm3p or --classifier)")
        bundle = load_classifier(types.SimpleNamespace(classifier_ckpt=classifier_ckpt, inference=selected))
        if bundle is None:
            raise SystemExit("a checkpoint is required (--cm3p or --classifier)")
        sr = bundle[1].model.spectrogram.sample_rate
        audio = load_audio_file(audio_path, sr)
        rf = extract_features(real_path, audio, bundle, batch_size=8)
        gf = extract_features(gen_path, audio, bundle, batch_size=8)
    rmse = ssm_rmse_for_pair(rf, gf)
    print(f"windows: real={len(rf)} generated={len(gf)}  ssm_rmse={rmse:.4f}")
    result = {"ssm_rmse": rmse, "real": np.clip((compute_self_similarity(rf) + 1) / 2, 0, 1),
              "generated": np.clip((compute_self_similarity(gf) + 1) / 2, 0, 1)}

    if out:
        try:
            import matplotlib
        except ImportError:
            print(f"matplotlib is not installed: {out} not drawn")
            return result
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(10, 5))
        for ax, matrix, title in ((axes[0], result["real"], "real"), (axes[1], result["generated"], "generated")):
            ax.imshow(matrix, cmap="magma")
            ax.set_title(title)
        fig.suptitle(f"SSM RMSE = {rmse:.4f}")
        fig.savefig(out, dpi=120)
        print(f"wrote {out}")
    return result


if __name__ == "__main__":
    main()
