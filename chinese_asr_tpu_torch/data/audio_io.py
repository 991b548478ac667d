"""Host-side audio I/O: a copy of ``chinese_asr_tpu/data/audio_io.py``
(reference data.py:109-121 fast_read, main.py:19-24 convert_audio) and of
``data/dataset.py`` ``round_up`` (the port keeps its own copies rather
than importing the JAX package).

Wav decode prefers libsndfile (soundfile) and falls back to the stdlib
``wave`` module for plain PCM.  Arbitrary-format ingest (``transcode``)
shells out to ffmpeg like the reference; for wav input the ``sox
--norm=-1`` peak normalization is reproduced in-process
(``peak_normalize``).
"""

from __future__ import annotations

import os
import shutil
import subprocess
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


def write_wav(path: str, data: np.ndarray, rate: int = 16000) -> None:
    """Float samples in [-1, 1] -> a 16-bit PCM mono wav."""
    if _sf is not None:
        _sf.write(path, data, rate, subtype="PCM_16")
        return
    import wave
    pcm = np.clip(np.asarray(data, np.float64) * 32767.0,
                  -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def peak_normalize(x: np.ndarray, db: float = -1.0) -> np.ndarray:
    """``sox --norm=-1`` equivalent (reference main.py:23): scale so the
    absolute peak sits at ``db`` dBFS."""
    peak = float(np.abs(x).max()) if x.size else 0.0
    if peak == 0.0:
        return x
    target = 10.0 ** (db / 20.0)
    return (x * (target / peak)).astype(np.float32)


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


def transcode(path: str, out_path: str, rate: int = 16000,
              norm_db: Optional[float] = -1.0) -> str:
    """ffmpeg -> 16 kHz s16 mono wav, then peak normalize (the reference's
    convert_audio, main.py:19-24), in-process instead of a second sox
    subprocess.  Without ffmpeg a ``.wav`` input is copied; any other
    input raises."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", path,
             "-ac", "1", "-ar", str(rate), "-sample_fmt", "s16", out_path],
            check=True)
    elif path.lower().endswith(".wav"):
        if os.path.abspath(path) != os.path.abspath(out_path):
            shutil.copy(path, out_path)
    else:
        raise RuntimeError("ffmpeg unavailable and input is not wav")
    if norm_db is not None:
        data, r = read_wav(out_path, expected_rate=rate)
        write_wav(out_path, peak_normalize(data, norm_db), r)
    return out_path
