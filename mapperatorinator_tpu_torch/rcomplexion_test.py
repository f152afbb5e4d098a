"""OsuR's timing predictions on the port (``rcomplexion_test.py``): for each
input gap, the entropy contribution of each predicted next gap, summarised,
then drawn as a heatmap where matplotlib is installed.

    python -m mapperatorinator_tpu_torch.rcomplexion_test -cn inference_v1 model_path=DIR \
        [-o out.png] [device=cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .config import load_rcomplexion_config, parse_argv, select_device
from .osu.events import Event, EventType
from .rcomplexion import RTokenizer
from .rcomplexion_inference import load_osur


def entropy_grid(model, tokenizer: RTokenizer, args, device: torch.device) -> np.ndarray:
    """(max_shift + 1, vocab_size_out) entropy terms -p log2 p of the
    prediction after each gap repeated over the window (gap, circle, gap,
    ...)."""
    max_shift = int((args.data.max_time - args.data.min_time) * args.data.time_resolution)
    circle = tokenizer.encode(Event(EventType.CIRCLE))
    inputs = np.empty((max_shift + 1, args.data.src_seq_len), np.int32)
    for i in range(max_shift + 1):
        pair = [tokenizer.encode(Event(EventType.TIME_SHIFT, i)), circle]
        inputs[i] = (pair * (args.data.src_seq_len // 2 + 1))[: args.data.src_seq_len]
    with torch.inference_mode():
        logits = model(torch.as_tensor(inputs, device=device))["logits"]
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    return -probs * np.log2(np.clip(probs, 1e-12, 1))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    config_name, overrides, flags = parse_argv(argv, "inference_v1", {"-o": "rcomplexion_predictions.png"})
    out = flags["-o"]
    args = load_rcomplexion_config(config_name, overrides)
    device = select_device(args)
    tokenizer = RTokenizer(args)
    entropy_terms = entropy_grid(load_osur(args, tokenizer, device), tokenizer, args, device)
    print(f"prediction grid: {entropy_terms.shape}, total entropy "
          f"{entropy_terms.sum(axis=1).mean():.3f} bits/input")

    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {out} not drawn")
        return entropy_terms
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.imshow(entropy_terms, aspect="auto")
    plt.xlabel("Predicted time")
    plt.ylabel("Input time")
    plt.title("Model predictions")
    plt.colorbar()
    plt.savefig(out, dpi=120)
    print(f"wrote {out}")
    return entropy_terms


if __name__ == "__main__":
    main()
