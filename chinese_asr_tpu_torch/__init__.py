"""PyTorch/CUDA port of the ``chinese_asr_tpu`` Mandarin LAS recognizer.

The JAX package stays the reference; this package imports ``torch`` and
numpy only (never ``jax``, never ``chinese_asr_tpu``).  Its layout mirrors
the JAX package module for module.  The three Pallas kernels of the
acoustic decode path are hand-written CUDA C++ for Hopper (``csrc/``),
each with a plain PyTorch twin beside its wrapper (``ops/cuda/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise.
"""

__all__ = ["resolve_device"]

from .utils.device import resolve_device
