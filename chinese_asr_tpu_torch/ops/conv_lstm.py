"""Convolutional LSTM over time (port of ``chinese_asr_tpu/ops/conv_lstm.py``;
reference util.py:886-1022 ConvLSTM / BConvLSTM).

The recurrence runs over time (the width axis) with the gates as 1-D
convs along frequency.  The input conv is hoisted out of the loop as one
conv over all [B*T] frames; each step adds the hidden-state conv, and the
length mask freezes (h, c) past each sample's true end, as in
``ops/rnn.py``.  The loop is Python over plain torch ops, as JAX's is a
``lax.scan`` of XLA convs.

Layout: x [B, T, F, C] (channel-last), states h/c [B, F, C'], gate conv
weights [ks, C, 4C'] in (i, f, g, o) order.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .conv import conv1d_nwc
from .masks import length_mask
from .rnn import reverse_sequence, xavier_normal as _xavier

Params = Dict[str, torch.Tensor]


def init_conv_lstm(gen: torch.Generator, in_c: int, out_c: int,
                   ks: int) -> Params:
    return {
        "w_x": _xavier(gen, (ks, in_c, 4 * out_c), in_c * ks,
                       4 * out_c * ks),
        "w_h": _xavier(gen, (ks, out_c, 4 * out_c), out_c * ks,
                       4 * out_c * ks),
        "b": torch.zeros(4 * out_c),
    }


def _freq_conv(x, w):
    """x [B, F, C], w [ks, C, C'] -> the conv along F with the reference's
    explicit (top, bottom) = ((ks-1)//2, ks-1-top) padding
    (util.py:912-914)."""
    ks = w.shape[0]
    top = (ks - 1) // 2
    return conv1d_nwc(x, w, padding=(top, ks - 1 - top))


def conv_lstm(p: Params, x, lens, state: Optional[Tuple] = None):
    """x [B, T, F, C], lens [B] -> (y [B, T, F, C'], (hT, cT) at the true
    ends).  Gate order (i, f, g, o); c = i*g + f*c_prev (reference
    util.py:930-936: its f gate multiplies the previous cell)."""
    B, T, Fq, _ = x.shape
    C2 = p["w_h"].shape[1]
    if state is None:
        h = x.new_zeros((B, Fq, C2))
        c = x.new_zeros((B, Fq, C2))
    else:
        h, c = state
    mask = length_mask(lens, T, x.dtype)                              # [B, T]
    xg = (_freq_conv(x.reshape(B * T, Fq, -1), p["w_x"]) + p["b"]
          ).reshape(B, T, Fq, -1)
    ys = []
    for t in range(T):
        gates = xg[:, t] + _freq_conv(h, p["w_h"])
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c2 = torch.sigmoid(i) * torch.tanh(g) + torch.sigmoid(f) * c
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        m = mask[:, t, None, None]
        h = m * h2 + (1.0 - m) * h
        c = m * c2 + (1.0 - m) * c
        ys.append(h2 * m)
    return torch.stack(ys, dim=1), (h, c)


def init_bconv_lstm(gen: torch.Generator, in_c: int, out_c: int,
                    ks: int) -> Params:
    return {"fwd": init_conv_lstm(gen, in_c, out_c, ks),
            "bwd": init_conv_lstm(gen, in_c, out_c, ks)}


def bconv_lstm(p: Params, x, lens):
    """Bidirectional variant (reference BConvLSTM util.py:977-1022): the
    backward direction runs on each row reversed by its own length.
    Returns (y [B, T, F, 2*C'], ((h_f, c_f), (h_b, c_b)))."""
    y_f, s_f = conv_lstm(p["fwd"], x, lens)
    y_b, s_b = conv_lstm(p["bwd"], reverse_sequence(x, lens), lens)
    return torch.cat([y_f, reverse_sequence(y_b, lens)], dim=-1), (s_f, s_b)
