"""K7: the Conformer and E-Branchformer encoders' dense products and the
beam decode step's (the output projection, the LSTM cell's gates), ``y =
x @ w + b`` in float32 on the tensor cores as 3xTF32 (``csrc/gemm.cu``),
with its plain twin.

x [..., K], w [K, N], b [N] or None, all float32 -> y [..., N] float32.
Each operand is split into TF32 words, hi = rna(v) and lo = rna(v - hi)
(``cvt.rna``: to nearest, ties away from zero), and lo(x) hi(w) + hi(x)
lo(w) + hi(x) hi(w) is summed in float32: float32's accuracy, where one
TF32 product keeps about three digits.

K7 replaces no TPU kernel: the JAX package leaves its products to XLA.
cuBLAS runs the port's float32 products with TF32 off on the CUDA cores
(SIMT sgemm); K7 runs them on the tensor cores at the same accuracy.  It
is bound by the tensor cores: three TF32 passes, 165 TFLOP/s of float32
work on the H100.

``linear`` launches K7 where ``takes`` holds: float32 operands on the
card with no gradient to record, K not a multiple of 8 on zero-padded
operands (a zero column adds 0 to every product).  The products K7 does
not compute (on the CPU, under autograd, in bf16) take the plain ``x @ w
+ b``, the expression its callers ran before K7 (bit for bit, forward and
backward), counted in ``fallbacks``; ``linear_pair`` does the same for
the LSTM cell's two gate products.  The weight's split
(``weight_split``) is computed once a weight and version and cached: [2,
N, K], the hi and lo words laid out K-major, as a TF32 wgmma reads its B
operand.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from ...utils import observe
from . import build

launches = 0          # K7 launches (the twin never counts)
fallbacks = 0         # products left to the plain ``x @ w (+ b)``
observe.register_counters(__name__, "launches", "fallbacks")

_P, _I = ctypes.c_void_p, ctypes.c_int

# id(w) -> [weakref to w, w._version, w.data_ptr(), the split [2, N, K]]
_splits: dict = {}


def round_tf32(t):
    """float32 rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32`` does for finite values: half a
    TF32 ulp added to the magnitude bits, the 13 bits below it cleared."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t):
    """(hi, lo): t = hi + lo + (what the split drops), both TF32, the
    kernel's own split of either operand."""
    hi = round_tf32(t)
    return hi, round_tf32(t - hi)


def _split(w):
    hi, lo = split_tf32(w.detach().reshape(-1, w.shape[-1]).t().contiguous())
    return torch.stack((hi, lo))


def _refresh(w, hit) -> None:
    """The split of ``w`` made again where its version or storage moved,
    in place: a captured graph holds the split's address."""
    if hit[1] != w._version or hit[2] != w.data_ptr():
        hit[3].copy_(_split(w))
        hit[1], hit[2] = w._version, w.data_ptr()


def weight_split(w):
    """w [K, N] -> [2, N, K] float32: its hi and lo TF32 words, K-major
    (w [..., N] is taken as [K, N], its leading dims flattened into K in
    order: K8's [3, 3, C, C] convolution weight as [9 C, C]).
    Cached a weight tensor and its version counter, so an update in place
    is never served stale (a CUDA graph's replay runs no Python: the
    decode programs call ``refresh`` before each, through
    ``build.refresh``, and the step programs count their writes into the
    version counters, ``utils/graphs.py``);
    an entry goes when its weight does.  A split made while a CUDA graph
    captures is not cached (its memory belongs to the graph's pool); the
    program's warm-up, which runs before every capture, fills the
    cache."""
    key = id(w)
    hit = _splits.get(key)
    if (hit is not None and hit[0]() is w
            and hit[3].shape == (2, w.shape[-1],
                                 w.numel() // max(1, w.shape[-1]))):
        _refresh(w, hit)
        return hit[3]
    hl = _split(w)
    if not (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        _splits[key] = [weakref.ref(w, lambda _, k=key: _splits.pop(k, None)),
                        w._version, w.data_ptr(), hl]
    return hl


def refresh() -> None:
    """Every cached split made again whose weight changed since: called
    before a graph replays K7 launches it captured."""
    for hit in list(_splits.values()):
        w = hit[0]()
        if w is not None:
            _refresh(w, hit)


build.on_replay(refresh)


def linear_plain(x, w, b=None):
    """The kernel's arithmetic in PyTorch: both operands split as the
    kernel splits them, lo*hi + hi*lo + hi*hi summed (in f32 products of
    TF32 values, which are exact), then the bias."""
    xh, xl = split_tf32(x)
    wh, wl = weight_split(w)
    y = xl @ wh.t() + xh @ wl.t() + xh @ wh.t()
    return y if b is None else y + b


def takes(x, w, b) -> bool:
    """Whether ``linear`` runs on K7: float32 CUDA operands on one device,
    of shapes that agree, and no autograd graph to record (the kernel has
    no backward)."""
    if not (x.is_cuda and x.dtype == torch.float32 and w.dim() == 2
            and w.dtype == torch.float32 and w.device == x.device
            and x.dim() >= 1 and x.shape[-1] == w.shape[0]):
        return False
    if b is not None and (b.dtype != torch.float32 or b.device != x.device
                          or tuple(b.shape) != (w.shape[1],)):
        return False
    return not (torch.is_grad_enabled() and (
        x.requires_grad or w.requires_grad
        or (b is not None and b.requires_grad)))


def linear(x, w, b=None):
    """y [..., N] = x [..., K] @ w [K, N] + b, the bias added in the
    product's epilogue.  One K7 launch where ``takes`` holds, its K
    padded to a multiple of 8 (at least 8) with zeros; otherwise ``x @ w
    + b`` (``x @ w`` without a bias), counted in ``fallbacks`` (it raises
    where the shapes disagree)."""
    global launches, fallbacks
    if not takes(x, w, b):
        fallbacks += 1
        return x @ w if b is None else x @ w + b
    K, N = w.shape
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return y.view(*x.shape[:-1], N)
    hl = weight_split(w)
    Kp = max(8, -(-K // 8) * 8)
    if Kp != K:
        x2, hl = F.pad(x2, (0, Kp - K)), F.pad(hl, (0, Kp - K))
    elif (x2.stride(1) != 1 or x2.stride(0) < K or x2.stride(0) % 4
            or x2.data_ptr() % 16):
        x2 = x2.clone(memory_format=torch.contiguous_format)
    bias = None if b is None else b.contiguous()
    fn = build.kernel("asr_gemm_tf32x3", [_P, _I, _P, _P, _P, _P, _I, _I, _I,
                                          _P])
    rc = fn(x2.data_ptr(), x2.stride(0), hl[0].data_ptr(), hl[1].data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(), M, N, Kp,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("asr_gemm_tf32x3", rc)
    launches += 1
    return y.view(*x.shape[:-1], N)


def linear_pair(x, w, h, u, b, c):
    """x @ w + h @ u + b + c, the LSTM cell's gates: two K7 launches where
    ``takes`` holds for both products, b + c added in the first one's
    epilogue; otherwise that expression as written, its two products
    counted in ``fallbacks``."""
    global fallbacks
    if takes(x, w, b) and takes(h, u, c):
        return linear(x, w, b + c) + linear(h, u)
    fallbacks += 2
    return x @ w + h @ u + b + c
