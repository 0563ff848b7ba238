"""UniAudio2 on PyTorch and CUDA: the port of `uniaudio2_tpu` (JAX on a
TPU) to an NVIDIA H100.

The package mirrors `uniaudio2_tpu`'s module paths so that each function
has a counterpart at the same place. Parameter trees are dicts of tensors
with the JAX package's key names and its ``(in, out)`` weight layout, so one
bridge (`convert/from_jax.py`) serves every parity test. The Pallas
kernels of the ported paths (the serving decode's four GEMV-shaped kernels
and the codec DiT's flash attention) are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(`ops/_cuda.py`). Entry points put their tensors on the card unless the
caller passes ``device="cpu"``.

This package imports ``torch`` and never ``jax`` or ``uniaudio2_tpu``.
"""

__version__ = "0.1.0"
