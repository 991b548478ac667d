"""Roofline shares that several metric readers compute alike."""

from __future__ import annotations

from port_bench.lib import trace
from port_bench.roofline import common, k2, shapes


def encoder_share(rec, kernel: str, elem_bytes: int, precision: str):
    """``kernel``'s (K2 or K2-bf16) roofline bound over its device time in
    a traced offline call: one launch a layer a chunk, over the chunk's
    padded encoder frames, its operations over each row's own frames
    (``roofline/k2.py``); None where the trace holds no such kernel."""
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t:
        return None
    secs, n = trace.kernel_seconds(t, rec["kernels"][kernel]["names"])
    if not n:
        return None
    cfg = rec["cfg"]
    a, H = cfg["audio"], cfg["encoder"]["hidden_size"]
    bound = 0.0
    for c in t["work"]:
        T = shapes.frames(c["N"], a) // 3
        valid = sum(shapes.encoder_frames(m, a) for m in c["lens"])
        bound += cfg["encoder"]["num_layers"] * common.bound_s(
            *k2.work(T, len(c["lens"]), H, valid, elem_bytes), precision)
    return 100.0 * bound / secs
