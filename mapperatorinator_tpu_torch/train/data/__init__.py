"""The training data pipeline: copies of the JAX package's numpy-only
``train/data`` modules (``sequence``, ``batching``, ``ors``), which
``tests/test_torch_nojax.py`` holds byte for byte against their sources."""

from .batching import TokenBalancedBatcher, collate_batch, cycle_interleave, prefetch_iterator  # noqa: F401
from .ors import OrsDataset  # noqa: F401
from .sequence import SequenceProcessor  # noqa: F401


def build_dataset(args, parser, vocab, test: bool = False, shared=None, subset_ids=None):
    """Dispatch on ``args.dataset_type``. Only ``ors`` (local track folders)
    is ported: ``mmrs`` reads its metadata with pandas and ``web`` streams
    from the network, and the GPU machine has neither."""
    kind = getattr(args, "dataset_type", "ors")
    if kind == "ors":
        return OrsDataset(args, parser, vocab, test=test, shared=shared)
    if kind in ("mmrs", "web"):
        raise NotImplementedError(f"dataset_type={kind!r}: not ported yet (ROADMAP queue 1, item 15); "
                                  "use dataset_type=ors")
    raise NotImplementedError(f"Unknown dataset type {kind!r}")
