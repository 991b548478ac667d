"""Build and bind the host C++ runtime (``runtime/cpp``) with ctypes.

A copy of ``chinese_asr_tpu/runtime/native.py`` for the port: the n-gram
LM (``ngram_lm.cpp``, bound in ``lm/ngram.py``), the edit distance
(``edit_distance.cpp``, used by ``ops/metrics.py``) and the ADPCM wire
encoder (``adpcm.cpp``, used by ``audio/features.py``) are compiled at
first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``chinese_asr_tpu_torch/_build/``, under a name that hashes the source,
the flags and the compiler's version, so a library built by another
toolchain is never loaded.  The build writes a temporary file and renames
it, so processes that build at once never load a half-written library.
Without a compiler every caller falls back to pure Python (ARPA text
only, for the LM; numpy for the ADPCM encoder).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import List, Optional

import numpy as np

CPP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib_holder = {"lib": None, "tried": False}


def _compiler_id() -> Optional[str]:
    try:
        out = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=30, check=True)
    except Exception:
        return None
    return out.stdout.splitlines()[0] if out.stdout else ""


def compile_source(name: str) -> Optional[str]:
    """``cpp/<name>.cpp`` -> path of its shared library, built on first
    use; None when no compiler is present or the build fails."""
    src = os.path.join(CPP_DIR, f"{name}.cpp")
    cxx = _compiler_id()
    if cxx is None:
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + cxx.encode())
    with open(src, "rb") as f:
        h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so_path)
    except Exception:
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


class _EditDistanceLib:
    def __init__(self, cdll):
        self._lib = cdll
        self._lib.edit_distance_i32.restype = ctypes.c_int32
        self._lib.edit_distance_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        self._lib.batch_cer_i32.restype = None
        self._lib.batch_cer_i32.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]

    @staticmethod
    def _codes(s: str) -> np.ndarray:
        return np.frombuffer(s.encode("utf-32-le"), dtype=np.int32)

    @staticmethod
    def _ptr(a: np.ndarray):
        if a.size:
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        return ctypes.cast(0, ctypes.POINTER(ctypes.c_int32))

    def edit_distance(self, pred: str, ref: str) -> int:
        a, b = self._codes(pred), self._codes(ref)
        return int(self._lib.edit_distance_i32(self._ptr(a), a.size,
                                               self._ptr(b), b.size))

    def batch_cer(self, preds: List[str], refs: List[str]) -> float:
        n = len(preds)
        if n == 0:
            return 0.0
        p_codes = [self._codes(s) for s in preds]
        r_codes = [self._codes(s) for s in refs]
        p_off = np.zeros(n + 1, np.int64)
        r_off = np.zeros(n + 1, np.int64)
        np.cumsum([c.size for c in p_codes], out=p_off[1:])
        np.cumsum([c.size for c in r_codes], out=r_off[1:])
        p_flat = np.concatenate(p_codes) if p_off[-1] else np.zeros(1, np.int32)
        r_flat = np.concatenate(r_codes) if r_off[-1] else np.zeros(1, np.int32)
        out = np.zeros(n, np.float64)
        self._lib.batch_cer_i32(
            p_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            p_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            r_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return float(out.mean())


def get() -> Optional[_EditDistanceLib]:
    """The edit-distance library, compiled on first use; None if
    unavailable."""
    with _lock:
        if not _lib_holder["tried"]:
            _lib_holder["tried"] = True
            so = compile_source("edit_distance")
            if so is not None:
                try:
                    _lib_holder["lib"] = _EditDistanceLib(ctypes.CDLL(so))
                except OSError:
                    _lib_holder["lib"] = None
        return _lib_holder["lib"]


_adpcm_holder = {"fn": None, "tried": False}


def get_adpcm():
    """A callable ``(x_int16, out_uint8) -> None`` wrapping the C++ ADPCM
    wire encoder (``cpp/adpcm.cpp``), compiled on first use; None if
    unavailable.  Byte-identical to the numpy encoder of
    ``audio/features.py`` ``adpcm_encode_flat``."""
    with _lock:
        if _adpcm_holder["tried"]:
            return _adpcm_holder["fn"]
        _adpcm_holder["tried"] = True
        so = compile_source("adpcm")
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
            lib.adpcm_encode_i16.restype = None
            lib.adpcm_encode_i16.argtypes = [
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]

            def encode(x: np.ndarray, out: np.ndarray) -> None:
                lib.adpcm_encode_i16(
                    x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                    ctypes.c_int64(x.size),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

            _adpcm_holder["fn"] = encode
        except OSError:
            _adpcm_holder["fn"] = None
        return _adpcm_holder["fn"]
