"""The evaluation metrics: copies of the JAX package's numpy and scipy
``eval`` modules (``fid``, ``rhythm``), which ``tests/test_torch_nojax.py``
holds to their sources."""

from .fid import calculate_frechet_distance, compute_fid_from_features  # noqa: F401
from .rhythm import calculate_f1, calculate_precision, calculate_recall, calculate_rhythm_stats, get_rhythm  # noqa: F401
