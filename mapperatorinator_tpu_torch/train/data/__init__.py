"""The training data pipeline: copies of the JAX package's numpy-only
``train/data`` modules (``sequence``, ``batching``, ``ors``), which
``tests/test_torch_nojax.py`` holds byte for byte against their sources,
and the ``mmrs`` and ``web`` backends, which read parquet through the port's
own reader (``parquet``)."""

from .batching import TokenBalancedBatcher, collate_batch, cycle_interleave, prefetch_iterator  # noqa: F401
from .mmrs import MmrsDataset  # noqa: F401
from .ors import OrsDataset  # noqa: F401
from .sequence import SequenceProcessor  # noqa: F401
from .web import WebDataset  # noqa: F401


def build_dataset(args, parser, vocab, test: bool = False, shared=None, subset_ids=None):
    """Dispatch on args.dataset_type (reference: model_utils.py:555-575)."""
    kind = getattr(args, "dataset_type", "ors")
    if kind == "ors":
        return OrsDataset(args, parser, vocab, test=test, shared=shared)
    if kind == "mmrs":
        return MmrsDataset(args, parser, vocab, subset_ids=subset_ids, test=test, shared=shared)
    if kind == "web":
        return WebDataset(args, parser, vocab, subset_ids=subset_ids, test=test, shared=shared)
    raise NotImplementedError(f"Unknown dataset type {kind!r}")
