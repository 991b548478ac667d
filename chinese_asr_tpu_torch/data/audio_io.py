"""Host-side audio I/O: copies of ``chinese_asr_tpu/data/audio_io.py``
``read_wav``/``peak_scale`` and ``data/dataset.py`` ``round_up`` (the port
keeps its own copies rather than importing the JAX package).

Wav decode prefers libsndfile (soundfile) and falls back to the stdlib
``wave`` module for plain PCM.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

try:
    import soundfile as _sf
except ImportError:                                   # pragma: no cover
    _sf = None


def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def read_wav(path: str, expected_rate: Optional[int] = 16000,
             dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """Mono samples + sample rate.  Warns (does not resample) on rate
    mismatch, like the reference (data.py:119-120).

    dtype="float32": samples in [-1, 1].  dtype="int16": raw PCM — ship
    these to the device and let the featurizer do the /32768 conversion
    (identical numerics, half the host->device bytes)."""
    if dtype not in ("float32", "int16"):
        raise ValueError(f"dtype must be float32 or int16, got {dtype}")
    if _sf is not None:
        data, rate = _sf.read(path, dtype=dtype, always_2d=False)
    else:
        import wave
        with wave.open(path, "rb") as w:
            rate = w.getframerate()
            n = w.getnframes()
            width = w.getsampwidth()
            raw = w.readframes(n)
            if width == 2:
                data = np.frombuffer(raw, np.int16)
                if dtype == "float32":
                    data = data.astype(np.float32) / 32768.0
            elif width == 4:
                data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
            else:
                raise ValueError(f"unsupported sample width {width}")
            if w.getnchannels() > 1:
                data = data.reshape(-1, w.getnchannels())
    if data.ndim > 1:
        data = data.mean(axis=1)
        if dtype == "int16":
            data = data.astype(np.int16)
    if expected_rate is not None and rate != expected_rate:
        warnings.warn(f"{path}: sample rate {rate} != expected {expected_rate}")
    return np.ascontiguousarray(data, dtype), rate


def peak_scale(x: np.ndarray, db: float = -1.0) -> float:
    """The scalar ``sox --norm=-1`` peak normalization multiplies by, for
    applying it ON DEVICE to raw int16 PCM (same float32 math, half the
    host->device bytes).  For int16 input the peak is taken in [-1, 1]
    units (value/32768)."""
    if x.size == 0:
        return 1.0
    peak = float(np.abs(x).max())
    if np.issubdtype(x.dtype, np.integer):
        peak /= 32768.0
    if peak == 0.0:
        return 1.0
    return float(np.float32(10.0 ** (db / 20.0) / peak))
