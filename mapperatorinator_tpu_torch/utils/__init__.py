"""Host helpers: ``batched_apply``, a copy of the JAX package's, which
``tests/test_torch_nojax.py`` holds to its source."""

from .batched_apply import batched_apply  # noqa: F401
