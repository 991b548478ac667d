"""K8: the Conformer's and the E-Branchformer's convolutional subsampling
(ESPnet's ``Conv2dSubsampling``, ``ops/conv.py`` ``conv2d_subsampling``)
without its linear map, in float32 on the tensor cores as 3xTF32
(``csrc/subsample.cu``), with its plain twin.

x [B, T, F] (padding zeroed), w1 [3, 3, 1, C], b1 [C], w2 [3, 3, C, C],
b2 [C], all float32 -> h [B, T2, C * F2] float32: relu(conv2(relu(conv1(x)
+ b1)) + b2), both valid 3x3 stride-2 convolutions, flattened
channel-major (feature c * F2 + f2), the layout the subsampling's linear
map reads; T2 = ((T - 1) // 2 - 1) // 2, F2 the same of F.

K8 replaces no TPU kernel: the JAX package leaves both convolutions to
XLA.  cuDNN ran them in float32 with TF32 off on the CUDA cores; K8 runs
the second as an implicit GEMM on K7's 3xTF32 pipeline (``gemm.py``)
and computes the first inside it, so that its [B, C, T1, F1]
intermediate never reaches device memory.  It is bound by the tensor
cores: 2 * 9 C^2 operations an output position at three TF32 passes,
165 TFLOP/s of float32 work on the H100.

``convs`` launches K8 where ``takes`` holds: float32 operands on one card
with no gradient to record, at the 3x3 shapes above with C a multiple of
32 up to 1024 and T and F of at least 7.  Where it does not (on the CPU,
under autograd, in other dtypes) it returns None, counted in
``fallbacks``, and the caller runs the two ``F.conv2d`` it ran before K8.
w2's split is K7's ``weight_split`` of the [9 C, C] matrix w2 already is
(k = (kt, kf, c_in)), cached a weight and version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import observe
from . import build
from . import gemm

launches = 0          # K8 launches (the twin never counts)
fallbacks = 0         # subsamplings left to the two F.conv2d
observe.register_counters(__name__, "launches", "fallbacks")

MAX_C = 1024          # the widest C whose w1 and b1 fit shared memory
                      # beside the ring (``csrc/subsample.cu``)

_P, _I = ctypes.c_void_p, ctypes.c_int


def out_size(n: int) -> int:
    """Positions along an axis of n after both convolutions."""
    return max(0, ((n - 1) // 2 - 1) // 2)


def takes(x, w1, b1, w2, b2) -> bool:
    """Whether ``convs`` runs on K8: float32 CUDA operands on one device,
    of the shapes the kernel is built for, and no autograd graph to
    record (the kernel has no backward)."""
    ops = (x, w1, b1, w2, b2)
    if not all(t.is_cuda and t.dtype == torch.float32
               and t.device == x.device for t in ops):
        return False
    C = w2.shape[-1] if w2.dim() == 4 else 0
    if not (x.dim() == 3 and tuple(w1.shape) == (3, 3, 1, C)
            and tuple(w2.shape) == (3, 3, C, C) and tuple(b1.shape) == (C,)
            and tuple(b2.shape) == (C,) and 0 < C <= MAX_C and C % 32 == 0
            and out_size(x.shape[1]) > 0 and out_size(x.shape[2]) > 0):
        return False
    return not (torch.is_grad_enabled()
                and any(t.requires_grad for t in ops))


def convs(x, w1, b1, w2, b2):
    """h [B, T2, C * F2] (module docstring) in one K8 launch over the
    whole batch where ``takes`` holds; otherwise None, counted in
    ``fallbacks``."""
    global launches, fallbacks
    if not takes(x, w1, b1, w2, b2):
        fallbacks += 1
        return None
    B, T, Fq = x.shape
    C = w2.shape[-1]
    T2, F2 = out_size(T), out_size(Fq)
    h = torch.empty((B, T2, C * F2), dtype=torch.float32, device=x.device)
    if B == 0:
        return h
    x, w1, b1, b2 = (t.contiguous() for t in (x, w1, b1, b2))
    hl = gemm.weight_split(w2)
    fn = build.kernel("asr_subsample_tf32x3", [_P, _P, _P, _P, _P, _P, _P,
                                               _I, _I, _I, _I, _P])
    rc = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), hl[0].data_ptr(),
            hl[1].data_ptr(), b2.data_ptr(), h.data_ptr(), B, T, Fq, C,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check("asr_subsample_tf32x3", rc)
    launches += 1
    return h


def convs_plain(x, w1, b1, w2, b2):
    """The kernel's arithmetic in PyTorch: conv1 with its bias and ReLU in
    float32, then conv2 as three products of the TF32 words, both
    operands split as the kernel splits them (lo*hi + hi*lo + hi*hi, each
    of products of TF32 values, which are exact in float32), its bias and
    ReLU, flattened channel-major."""
    h1 = F.conv2d(x[:, None], w1.permute(3, 2, 0, 1), b1, stride=2).relu()
    ah, al = gemm.split_tf32(h1)
    wh, wl = gemm.split_tf32(w2.permute(3, 2, 0, 1))
    h2 = (F.conv2d(al, wh, stride=2) + F.conv2d(ah, wl, stride=2)
          + F.conv2d(ah, wh, stride=2) + b2[:, None, None]).relu()
    # [B, C, T2, F2] -> [B, T2, C * F2]: feature c * F2 + f2
    return h2.transpose(1, 2).flatten(2)
