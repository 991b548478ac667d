"""Build the hand-written CUDA kernels (``chinese_asr_tpu_torch/csrc``) and
load them with ctypes.

``nvcc`` compiles every ``.cu`` source for ``sm_90a`` (one process per
source, all started together), then links the objects into one shared
library with a plain C interface.  The library is cached in
``chinese_asr_tpu_torch/_build/`` under a hash of the sources and flags,
so the first kernel call of a process builds it (seconds) and later ones
load it.  Nothing here runs at import time: a host without ``nvcc`` can
import every module and use the plain PyTorch twins on CPU tensors.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "cannot be built on this host")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libasr_kernels-{_digest()}.so")


def build() -> str:
    """Compile and link the kernels unless a library for these exact
    sources is already cached; returns its path.  ``nvcc``'s register and
    shared-memory report (``-Xptxas -v``) goes to ``build-<hash>.log``
    beside the library."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{_digest()}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{out}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        tmp = f"{so}.{os.getpid()}.tmp"
        link = subprocess.run(
            [nvcc, "-gencode=arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    with open(os.path.join(BUILD_DIR, f"build-{_digest()}.log"), "w") as f:
        f.write("\n".join(log))
    return so


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.asr_error_string.argtypes = [ctypes.c_int]
            lib.asr_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared; it
    returns a cudaError_t as int (0 = launched)."""
    fn = getattr(_library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def require(name: str, t, dtype, shape) -> None:
    """Validate a kernel operand before its pointer goes to C: a
    contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = _library().asr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
