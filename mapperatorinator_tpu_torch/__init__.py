"""PyTorch and CUDA port of ``mapperatorinator_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference: every module here keeps the
layout of its JAX counterpart, and the tests hold each one against it. The
port imports ``torch`` and never ``jax``, ``flax``, ``optax`` or ``yaml``,
nor anything of the JAX package: the host-side code it needs (``osu``,
``native``, the training data pipeline) is its own copy, which
``tests/test_torch_nojax.py`` holds byte for byte against its source. The
Pallas kernels on the v32 generation and training paths are CUDA kernels
here (``ops/``, sources in ``csrc/``).
"""

__version__ = "0.1.0"
