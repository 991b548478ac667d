"""K2: bidirectional LSTM time-loop kernel (``csrc/lstm.cu``) and its
plain twin.

Replaces ``chinese_asr_tpu/ops/pallas/lstm.py`` ``bidir_lstm_time_loop``
(reached through ``ops/rnn.py`` ``_bidir_core_pallas``).  Contract, all
time-major f32: xg_f/xg_b [T, B, 4H] (backward already time-flipped),
m_f/m_b [T, B], w_hh [2, H, 4H] -> (ys_f [T, B, H], ys_b [T, B, H] in
the flipped order it was fed, hT [2, B, H], cT [2, B, H]).

On the card, H alone picks the kernel: a multiple of 64 that fits (the
flagship 256) runs the thread-block-cluster kernel with W_hh resident in
shared memory; any other H (the golden model's 16) runs the simple
per-block kernel (``csrc/lstm.cu`` explains both).

Inference only: the ``torch.autograd.Function`` whose backward
recomputes through the twin (as ``ops/rnn.py`` ``_bidir_core_bwd`` does)
comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

launches = 0          # kernel launches (the twin never counts)

_P, _I = ctypes.c_void_p, ctypes.c_int


def bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh):
    """The recurrence as a Python loop over time (the step formulas of
    ``chinese_asr_tpu/ops/rnn.py`` ``_bidir_core_scan``)."""
    T, B, H4 = xg_f.shape
    H = H4 // 4
    z = xg_f.new_zeros((B, H))
    h = [z, z]
    c = [z, z]
    ys = [xg_f.new_empty((T, B, H)), xg_f.new_empty((T, B, H))]
    xgs, ms = (xg_f, xg_b), (m_f, m_b)
    for t in range(T):
        for d in range(2):
            gates = xgs[d][t] + h[d] @ w_hh[d]
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c2 = torch.sigmoid(f) * c[d] + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            m = ms[d][t][:, None]
            y = h2 * m
            ys[d][t] = y
            h[d] = y + (1.0 - m) * h[d]
            c[d] = m * c2 + (1.0 - m) * c[d]
    return ys[0], ys[1], torch.stack(h), torch.stack(c)


def bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w_hh):
    """A CPU tensor takes the plain twin; a CUDA tensor launches the
    kernel (one launch runs both directions' whole time loop)."""
    if xg_f.device.type == "cpu":
        return bidir_lstm_time_loop_plain(xg_f, xg_b, m_f, m_b, w_hh)
    T, B, H4 = xg_f.shape
    H = H4 // 4
    if H4 != 4 * H or H > 1024:
        raise ValueError(f"bidir_lstm_time_loop: hidden size {H4 / 4} "
                         f"unsupported (4H must divide, H <= 1024)")
    f32 = torch.float32
    build.require("xg_f", xg_f, f32, (T, B, H4))
    build.require("xg_b", xg_b, f32, (T, B, H4))
    build.require("m_f", m_f, f32, (T, B))
    build.require("m_b", m_b, f32, (T, B))
    build.require("w_hh", w_hh, f32, (2, H, H4))
    dev = xg_f.device
    ys_f = torch.empty((T, B, H), dtype=f32, device=dev)
    ys_b = torch.empty((T, B, H), dtype=f32, device=dev)
    hT = torch.empty((2, B, H), dtype=f32, device=dev)
    cT = torch.empty((2, B, H), dtype=f32, device=dev)
    if B == 0:
        return ys_f, ys_b, hT, cT
    fn = build.kernel("asr_bilstm", [_P] * 9 + [_I] * 3 + [_P])
    rc = fn(xg_f.data_ptr(), xg_b.data_ptr(), m_f.data_ptr(), m_b.data_ptr(),
            w_hh.data_ptr(), ys_f.data_ptr(), ys_b.data_ptr(), hT.data_ptr(),
            cT.data_ptr(), T, B, H, torch.cuda.current_stream(dev).cuda_stream)
    build.check("asr_bilstm", rc)
    global launches
    launches += 1
    return ys_f, ys_b, hT, cT
