"""K6: the beam's additive-attention read (``csrc/attention.cu``), with
its plain twin.

    align[b, j, :] = softmax_L(mask[b, :] + sum_a tanh(keys[b, :, a]
                                                   + q[b, j, a]) * v[a])

mask [B, L] additive, q [B, k, a], keys [B, L, a], v [a], one dtype
(float32 or bfloat16) -> align [B, k, L] in that dtype.

K6 replaces no TPU kernel: the JAX package leaves the expression
(``models/attention.py`` ``attend_beam``) to XLA, which fuses it.  Written
in PyTorch it writes and reads a [B, k, L, a] tensor four times a decode
step, the largest device time outside the GEMMs in the offline beam
decode's trace; K6 never forms that tensor.  It is bound by its accurate
``tanhf`` arithmetic (B*k*L*a of them), not by its bytes.  ``plan`` says
how a launch spreads the work.  K6 reads a key row in 16-byte units, so
the wrapper runs a width off that grain at ``grain(a)``, with q, keys and
v padded by zero columns (each adds tanh(0 + 0) * 0 = 0 to a score), and
copies keys that start off a 16-byte boundary.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ...utils import observe
from . import build

launches = 0          # K6 kernel launches (the twin never counts)
observe.register_counters(__name__, "launches")

SMS = 132             # the H100's streaming multiprocessors
WARPS = 8             # warps a block at most (the kernel's launch bound)
TILE_BYTES = 72 * 1024        # the two key tiles' shared memory at most
SMEM = 227 * 1024 - 1024      # dynamic shared memory a block takes at most
                              # (the H100's 227 KB, less the static)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


def row_stride(row_bytes: int) -> int:
    """A key row's bytes in shared memory: an odd number of 16-byte units,
    so that 8 lanes reading 8 rows at one offset hit 32 distinct banks."""
    u = row_bytes // 16
    return 16 * (u + 1 + (u & 1))


def plan(B: int, k: int, L: int, a: int, dtype) -> dict:
    """How K6 launches at B samples, k beams, L frames, attention width a:

    * ``beams_per_block`` (kb) and ``blocks`` (B x ceil(k / kb)): a block a
      sample once B fills the card's SMs twice over, else the beams split
      into the fewest power-of-two groups that do (or one beam a block);
    * ``tile``: frames of keys a shared-memory buffer holds (32 a warp's
      stripe; as many stripes as keep the block's warps busy, within
      TILE_BYTES for both buffers), ``threads`` (32 per stripe and beam, at
      most 256);
    * ``split``: the kb x L float32 scores do not fit in shared memory
      beside the tiles, q and v, so they go to a scratch in device memory;
      ``smem``: the block's dynamic shared memory.

    Raises ValueError where a row of keys is not a whole number of 16-byte
    units (the bulk copies' grain) or the tiles alone overflow."""
    if dtype not in _ITEMSIZE:
        raise ValueError(f"K6 takes float32 or bfloat16, got {dtype}")
    row = a * _ITEMSIZE[dtype]
    if a <= 0 or row % 16:
        raise ValueError(f"K6 needs a key row of a multiple of 16 bytes, got "
                         f"a={a} in {dtype}")
    groups = 1
    while groups < k and B * groups < 2 * SMS:
        groups *= 2
    kb = -(-k // groups)
    sb = row_stride(row)
    stripes = max(1, WARPS // kb)
    while stripes > 1 and 2 * 32 * stripes * sb > TILE_BYTES:
        stripes //= 2
    tile = 32 * stripes
    fixed = 2 * tile * sb + 16 + 4 * a + 4 * kb * a
    if fixed > SMEM:
        raise ValueError(f"K6: a={a} in {dtype} leaves no room in shared "
                         f"memory ({fixed} bytes before the scores)")
    split = fixed + 4 * kb * L > SMEM
    return dict(beams_per_block=kb, blocks=B * -(-k // kb), tile=tile,
                threads=32 * min(WARPS, kb * stripes), split=split,
                smem=fixed + (0 if split else 4 * kb * L))


def grain(a: int, dtype) -> int:
    """The width K6 runs attention width ``a`` at: a key row rounded up
    to whole 16-byte units."""
    n = 16 // _ITEMSIZE[dtype]
    return -(-a // n) * n


def beam_scores_softmax_plain(mask, q, keys, v):
    """The expression K6 computes, as PyTorch writes it: a [B, k, L, a]
    tanh intermediate, summed over a, then the softmax over L."""
    e = torch.tanh(keys[:, None, :, :] + q[:, :, None, :]) * v
    scores = e.sum(dim=-1)                                # [B, k, L]
    return torch.softmax(mask[:, None, :] + scores, dim=-1)


def beam_scores_softmax(mask, q, keys, v):
    """align [B, k, L] of the beam's additive attention.  A CPU tensor takes
    the plain twin; a CUDA tensor launches K6, at ``grain(a)`` where a row
    of keys is off the 16-byte grain.  Raises on operands of other shapes
    or of mixed or other dtypes than float32 and bfloat16, where the key
    tiles overflow shared memory (``plan``), and, since the kernel has no
    backward, on operands that need a gradient."""
    B, k, a = q.shape
    L = keys.shape[1]
    if (tuple(mask.shape) != (B, L) or tuple(keys.shape) != (B, L, a)
            or tuple(v.shape) != (a,)):
        raise ValueError(f"beam_scores_softmax: mask [B, L], q [B, k, a], "
                         f"keys [B, L, a], v [a]; got {tuple(mask.shape)}, "
                         f"{tuple(q.shape)}, {tuple(keys.shape)}, "
                         f"{tuple(v.shape)}")
    if keys.device.type == "cpu":
        return beam_scores_softmax_plain(mask, q, keys, v)
    dt = keys.dtype
    if dt not in _ITEMSIZE:
        raise ValueError(f"beam_scores_softmax: K6 takes float32 or "
                         f"bfloat16, got {dt}")
    for name, t, shape in (("mask", mask, (B, L)), ("q", q, (B, k, a)),
                           ("keys", keys, (B, L, a)), ("v", v, (a,))):
        build.require(f"beam_scores_softmax {name}", t, dt, shape)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (mask, q, keys, v)):
        raise ValueError("beam_scores_softmax: K6 has no backward; call it "
                         "under torch.no_grad()")
    out = torch.empty((B, k, L), dtype=dt, device=keys.device)
    if out.numel() == 0:
        return out
    ap = grain(a, dt)
    p = plan(B, k, L, ap, dt)
    if ap != a:
        q, keys, v = (F.pad(t, (0, ap - a)) for t in (q, keys, v))
    elif keys.data_ptr() % 16:
        keys = keys.clone()
    scratch = (torch.empty((B, k, L), dtype=torch.float32, device=keys.device)
               if p["split"] else None)
    fn = build.kernel("asr_beam_attention", [_P] * 6 + [_I] * 8 + [_P])
    rc = fn(mask.data_ptr(), q.data_ptr(), keys.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, k, L, ap, int(dt == torch.bfloat16), p["beams_per_block"],
            p["tile"], p["threads"],
            torch.cuda.current_stream(keys.device).cuda_stream)
    build.check("asr_beam_attention", rc)
    global launches
    launches += 1
    return out
