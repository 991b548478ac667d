"""K3, the per-row top-k of the beam's first stage (``ops/cuda/topk.py``):
one read of the [R, V] float32 scores and one write of the k values
(float32) and indices (int32) a row.  Its compares (one an element) are
far below the bytes' time."""

from __future__ import annotations


def work(R: int, V: int, k: int):
    """(operations, bytes) of one launch."""
    return R * V, 4 * R * V + 8 * R * k
