"""K2: bidirectional LSTM time-loop kernel (``csrc/lstm.cu``) and its
plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/lstm.py`` ``bidir_lstm_time_loop``
(reached through ``ops/rnn.py`` ``_bidir_core_pallas``).  Contract, all
time-major, every operand of one type: xg_f/xg_b [T, B, 4H] (backward
already time-flipped), m_f/m_b [T, B], w_hh [2, H, 4H] -> (ys_f
[T, B, H], ys_b [T, B, H] in the flipped order it was fed, hT [2, B, H],
cT [2, B, H]).

float32 runs the f32 kernel (3xTF32 products, f32 throughout).  bfloat16
(``compute_dtype="bfloat16"``; in JAX the bf16 ``lax.scan``
``_bidir_core_scan``) runs its bf16 instance: bf16 x bf16 products
accumulated in f32, the cell update in f32, and y, h and c rounded to bf16
at the end of each step; the outputs are bf16, as in JAX.

On the card, H alone picks the kernel: H in {64, 128, 192, 256} (the
flagship 256) runs the thread-block-cluster kernel, W_hh resident in
registers and the step's product on the tensor cores; any other H (the
golden model's 16) runs the simple per-block kernel.  B alone picks the
cluster kernel's rows per cluster (16, or 32 from B=113 on), so that
B <= 224 runs in one wave (``csrc/lstm.cu`` explains both).

Inference only: the ``torch.autograd.Function`` whose backward
recomputes through the twin (as ``ops/rnn.py`` ``_bidir_core_bwd`` does)
comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0          # f32 kernel launches (the twin never counts)
bf16_launches = 0     # bf16 kernel (K2-bf16) launches

_P, _I = ctypes.c_void_p, ctypes.c_int


def bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh):
    """The recurrence as a Python loop over time (the step formulas of
    ``chinese_asr_tpu/ops/rnn.py`` ``_bidir_core_scan``), computed in
    float32 and rounded to the operands' type where the kernel rounds:
    for bf16, h @ W_hh of bf16 values (each product exact in f32) summed
    in f32, the cell update in f32, then y, h and c rounded to bf16 at the
    end of each step.  For float32 every rounding is a no-op."""
    T, B, H4 = xg_f.shape
    H = H4 // 4
    dt, f32 = xg_f.dtype, torch.float32

    def rnd(x):                        # the carry's precision
        return x.to(dt).to(f32)

    w = w_hh.to(f32)
    z = xg_f.new_zeros((B, H), dtype=f32)
    h = [z, z]
    c = [z, z]
    ys = [xg_f.new_empty((T, B, H)), xg_f.new_empty((T, B, H))]
    xgs, ms = (xg_f, xg_b), (m_f, m_b)
    for t in range(T):
        for d in range(2):
            gates = xgs[d][t].to(f32) + h[d] @ w[d]
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c2 = torch.sigmoid(f) * c[d] + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            m = ms[d][t][:, None].to(f32)
            y = rnd(h2 * m)
            ys[d][t] = y
            h[d] = rnd(y + (1.0 - m) * h[d])
            c[d] = rnd(m * c2 + (1.0 - m) * c[d])
    return ys[0], ys[1], torch.stack(h).to(dt), torch.stack(c).to(dt)


# the C entry point of each operand type
_ENTRY = {torch.float32: "asr_bilstm", torch.bfloat16: "asr_bilstm_bf16"}


def plan(B: int, H: int, dtype=torch.float32) -> dict:
    """How the kernel launches at (B, H) for operands of ``dtype``,
    without launching: batch rows per cluster, clusters in the grid,
    clusters the card holds at once (``cudaOccupancyMaxActiveClusters``)
    and the waves that makes.  The simple kernel (H outside the cluster
    kernel's) has no clusters."""
    buf = (ctypes.c_int * 3)()
    name = _ENTRY[dtype] + "_plan"
    fn = build.kernel(name, [_I, _I, _P])
    build.check(name, fn(B, H, ctypes.addressof(buf)))
    rows, clusters, resident = buf
    waves = -(-clusters // resident) if clusters else 0
    return dict(rows=rows, clusters=clusters, max_active_clusters=resident,
                waves=waves)


def bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w_hh):
    """A CPU tensor takes the plain twin; a CUDA tensor launches the
    kernel of its type, float32 or bfloat16 (one launch runs both
    directions' whole time loop).  Masks of another type are cast to
    xg's."""
    if xg_f.device.type == "cpu":
        return bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh)
    T, B, H4 = xg_f.shape
    H = H4 // 4
    if H4 != 4 * H or H > 1024:
        raise ValueError(f"bidir_lstm_time_loop: hidden size {H4 / 4} "
                         f"unsupported (4H must divide, H <= 1024)")
    dt = xg_f.dtype
    if dt not in _ENTRY:
        raise ValueError(f"bidir_lstm_time_loop: {dt} unsupported "
                         f"(float32 or bfloat16)")
    m_f, m_b = m_f.to(dt), m_b.to(dt)
    build.require("xg_f", xg_f, dt, (T, B, H4))
    build.require("xg_b", xg_b, dt, (T, B, H4))
    build.require("m_f", m_f, dt, (T, B))
    build.require("m_b", m_b, dt, (T, B))
    build.require("w_hh", w_hh, dt, (2, H, H4))
    if dt == torch.bfloat16 and (xg_f.data_ptr() | xg_b.data_ptr()) % 4:
        raise ValueError("bidir_lstm_time_loop: bf16 gates must be 4-byte "
                         "aligned (they are read two units a word)")
    dev = xg_f.device
    ys_f = torch.empty((T, B, H), dtype=dt, device=dev)
    ys_b = torch.empty((T, B, H), dtype=dt, device=dev)
    hT = torch.empty((2, B, H), dtype=dt, device=dev)
    cT = torch.empty((2, B, H), dtype=dt, device=dev)
    if B == 0:
        return ys_f, ys_b, hT, cT
    name = _ENTRY[dt]
    fn = build.kernel(name, [_P] * 9 + [_I] * 3 + [_P])
    rc = fn(xg_f.data_ptr(), xg_b.data_ptr(), m_f.data_ptr(), m_b.data_ptr(),
            w_hh.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(), hT.data_ptr(),
            cT.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream)
    build.check(name, rc)
    global launches, bf16_launches
    if dt == torch.bfloat16:
        bf16_launches += 1
    else:
        launches += 1
    return ys_f, ys_b, hT, cT
