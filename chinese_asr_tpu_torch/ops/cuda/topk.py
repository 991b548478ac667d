"""K3: exact row-wise top-k kernel (``csrc/topk.cu``) and its plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/topk.py`` ``top_k``: x [R, V] f32 ->
(values [R, k] f32, indices [R, k] int32), descending; ties go to the
lower column; NaN ranks above +inf and reads back as NaN (so does a
+inf input); an all -inf row yields its lowest columns in order.
``torch.topk`` promises none of the tie order, so the twin is a stable
descending sort.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0          # kernel launches (the twin never counts)

_P, _I = ctypes.c_void_p, ctypes.c_int
# one row is staged in shared memory: 227 KB per block on Hopper
MAX_V = 232448 // 4


def top_k_plain(x, k: int):
    key = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    srt, order = torch.sort(key, dim=-1, descending=True, stable=True)
    vals = srt[..., :k]
    vals = torch.where(vals == float("inf"),
                       torch.full_like(vals, float("nan")), vals)
    return vals, order[..., :k].to(torch.int32)


def top_k(x, k: int):
    """A CPU tensor takes the plain twin; a CUDA tensor launches the
    kernel (one block per row)."""
    if x.ndim != 2 or not 0 < k <= x.shape[1]:
        raise ValueError(f"top_k: need a 2-D input and 0 < k <= V, got "
                         f"shape {tuple(x.shape)}, k={k}")
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    R, V = x.shape
    if V > MAX_V:
        raise ValueError(f"top_k: V={V} rows do not fit shared memory "
                         f"(max {MAX_V})")
    build.require("top_k x", x, torch.float32, (R, V))
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    fn = build.kernel("asr_topk", [_P] * 3 + [_I] * 3 + [_P])
    rc = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, V, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("asr_topk", rc)
    global launches
    launches += 1
    return vals, idx
