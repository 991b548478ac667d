"""PyTorch/CUDA port of the ``chinese_asr_tpu`` Mandarin LAS recognizer.

The JAX package stays the reference; this package imports ``torch`` and
numpy only (never ``jax``, never ``chinese_asr_tpu``).  Its layout mirrors
the JAX package module for module.  The four Pallas kernels of the JAX
package are hand-written CUDA C++ for Hopper (``csrc/``), each with a
plain PyTorch twin beside its wrapper (``ops/cuda/``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise.

    from chinese_asr_tpu_torch import ASR
    asr = ASR(ckpt_path=..., lm_path=..., bw=16, vocab="dict.pkl")
    text = asr("utterance.wav")
"""

from .config import Config, DEFAULT_CONFIG
from .utils.device import resolve_device
from .vocab import Vocab

__all__ = ["ASR", "Config", "DEFAULT_CONFIG", "Vocab", "resolve_device"]


def __getattr__(name):
    # lazy: importing the package loads no model code
    if name == "ASR":
        from .api import ASR as _ASR
        return _ASR
    raise AttributeError(name)
