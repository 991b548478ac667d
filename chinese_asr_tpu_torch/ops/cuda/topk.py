"""K3: exact row-wise top-k kernel, and K4: the same selection fused
behind the beam's logp transform (``csrc/topk.cu``), with their plain
twins.

K3 replaces ``chinese_asr_tpu/ops/pallas/topk.py`` ``top_k``: x [R, V] f32
-> (values [R, k] f32, indices [R, k] int32), descending; ties go to the
lower column; NaN ranks with +inf and reads back as NaN (so does a +inf
input); an all -inf row yields its lowest columns in order.
``torch.topk`` promises none of the tie order, so the twin is a stable
descending sort.

K4 replaces ``top_k_fused``: the top-k of ``logit / T - logsumexp(logit /
T) + bias`` without materialising the transformed [R, V] array; a NaN
key ranks first, and a -inf bias disables its whole row.

Both kernels read each row once into per-lane candidate lists and
extract from those exactly, falling back to a flat extraction on the rows
where a lane's list ran out; K4 first reads such a row again with its
candidates taken by the exact keys (``csrc/topk.cu`` explains the
scheme).  ``plan`` says how a launch spreads the rows over warps.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import observe
from . import build

launches = 0          # K3 kernel launches (the twin never counts)
fused_launches = 0    # K4 kernel launches (the twin never counts)
observe.register_counters(__name__, "launches", "fused_launches")

SLOTS = 8             # candidates a lane keeps (csrc/topk.cu S)
MAX_CAND_K = 32       # a larger k takes the flat extraction (KMAX)
ONE_WARP_ROWS = 1024  # from here one warp a row gives the H100 8 warps an SM

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def plan(R: int, V: int, k: int) -> dict:
    """How K3 and K4 launch at [R, V], k: warps per row (4 below
    ONE_WARP_ROWS rows when each of the 128 lanes still scans at least
    2 x SLOTS elements, else 1), rows and threads per block, blocks, and
    whether the per-lane candidates run (k <= MAX_CAND_K)."""
    W = 4 if R < ONE_WARP_ROWS and V >= 2 * SLOTS * 32 * 4 else 1
    rows = 4 if W == 1 else 1
    return dict(warps_per_row=W, rows_per_block=rows,
                threads=32 * W * rows, blocks=-(-R // rows), slots=SLOTS,
                candidates=k <= MAX_CAND_K)


def top_k_plain(x, k: int):
    key = torch.where(torch.isnan(x), torch.full_like(x, float("inf")), x)
    srt, order = torch.sort(key, dim=-1, descending=True, stable=True)
    vals = srt[..., :k]
    vals = torch.where(vals == float("inf"),
                       torch.full_like(vals, float("nan")), vals)
    return vals, order[..., :k].to(torch.int32)


def _check(name: str, x, k: int) -> None:
    if x.ndim != 2 or not 0 < k <= x.shape[1]:
        raise ValueError(f"{name}: need a 2-D input and 0 < k <= V, got "
                         f"shape {tuple(x.shape)}, k={k}")


def _counter_ptr(fallbacks) -> int:
    if fallbacks is None:
        return 0
    build.require("fallbacks", fallbacks, torch.int32, (2,))
    return fallbacks.data_ptr()


def top_k(x, k: int, fallbacks=None):
    """A CPU tensor takes the plain twin; a CUDA tensor launches the
    kernel.  ``fallbacks``: an optional int32 [2] CUDA tensor to which the
    kernel adds the rows that took its flat extraction ([0]) and, for K4,
    the rows it read again by their exact keys ([1])."""
    _check("top_k", x, k)
    if x.device.type == "cpu":
        return top_k_plain(x, k)
    R, V = x.shape
    build.require("top_k x", x, torch.float32, (R, V))
    vals = torch.empty((R, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=x.device)
    fn = build.kernel("asr_topk", [_P] * 3 + [_I] * 4 + [_P, _P])
    rc = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), R, V, k,
            plan(R, V, k)["warps_per_row"], _counter_ptr(fallbacks),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("asr_topk", rc)
    global launches
    launches += 1
    return vals, idx


def top_k_fused_plain(logit, bias, k: int, temp: float = 1.0):
    """The unfused composition, written out as the kernel computes it:
    x = logit / T, lse = m + log(sum exp(x - m)) with m the row max (a NaN
    or +inf logit makes lse NaN), key = x - lse + bias, -inf wherever the
    bias is -inf; then K3's twin, which ranks a NaN key first."""
    # a tensor divisor: torch's CUDA division by a host scalar multiplies
    # by its reciprocal, which is not the kernel's IEEE divide for T != 1
    x = logit.to(torch.float32)
    x = x / torch.full_like(x, temp)
    m = x.amax(dim=1, keepdim=True)
    lse = m + torch.log(torch.exp(x - m).sum(dim=1, keepdim=True))
    key = torch.where(bias == float("-inf"), bias, x - lse + bias)
    return top_k_plain(key, k)


def top_k_fused(logit, bias, k: int, temp: float = 1.0, fallbacks=None):
    """Top-k of ``logit / temp - logsumexp(logit / temp) + bias``: logit
    [R, V] f32, bias [R, 1] f32 (-inf disables a row).  A CPU tensor takes
    the plain twin; a CUDA tensor launches K4.  ``fallbacks`` as for
    ``top_k``."""
    _check("top_k_fused", logit, k)
    R, V = logit.shape
    if tuple(bias.shape) != (R, 1):
        raise ValueError(f"top_k_fused: bias must be [{R}, 1], got "
                         f"{tuple(bias.shape)}")
    if logit.device.type == "cpu":
        return top_k_fused_plain(logit, bias, k, temp)
    build.require("top_k_fused logit", logit, torch.float32, (R, V))
    build.require("top_k_fused bias", bias, torch.float32, (R, 1))
    vals = torch.empty((R, k), dtype=torch.float32, device=logit.device)
    idx = torch.empty((R, k), dtype=torch.int32, device=logit.device)
    fn = build.kernel("asr_topk_fused", [_P] * 4 + [_I] * 4 + [_F, _P, _P])
    rc = fn(logit.data_ptr(), bias.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), R, V, k, plan(R, V, k)["warps_per_row"],
            float(temp), _counter_ptr(fallbacks),
            torch.cuda.current_stream(logit.device).cuda_stream)
    build.check("asr_topk_fused", rc)
    global fused_launches
    fused_launches += 1
    return vals, idx
