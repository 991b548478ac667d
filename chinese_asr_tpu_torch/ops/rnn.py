"""Recurrent ops over parameter dicts (port of ``chinese_asr_tpu/ops/rnn.py``,
LSTM only in this slice).

Parameter layout per layer/direction is the JAX package's (torch-
transposed for right-matmuls): w_ih [D, 4H], w_hh [H, 4H], b_ih, b_hh
[4H], gate order (i, f, g, o).

The flagship encoder path stays TIME-MAJOR across the whole residual
stack: the input projection of each direction is one hoisted matmul
producing [T, B, 4H], the backward direction runs on the statically
flipped sequence with the flipped mask freezing its carry, and the
recurrence of both directions is one launch of kernel K2
(``ops/cuda/lstm.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .cuda import lstm as lstm_k

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init (reference util.py:90-114: zeros bias + LSTM forget-bias 0.5,
# orthogonal hh, xavier-normal ih).  Weights are drawn on the CPU from an
# explicit generator, so a seed gives the same weights on every device.
# --------------------------------------------------------------------------
def _xavier_normal(gen: torch.Generator, shape, fan_in: int, fan_out: int):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen)


def init_lstm_layer(gen: torch.Generator, input_size: int,
                    hidden_size: int) -> Params:
    H = hidden_size
    w_ih = _xavier_normal(gen, (input_size, 4 * H), input_size, 4 * H)
    # torch orthogonal init of the full [4H, H] matrix, stored transposed
    w_hh = torch.nn.init.orthogonal_(torch.empty(4 * H, H),
                                     generator=gen).T.contiguous()
    fb = torch.zeros(4 * H)
    fb[H:2 * H] = 0.5                       # forget-gate bias on each vector
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": fb.clone(), "b_hh": fb.clone()}


def init_rnn_stack(gen: torch.Generator, input_size: int, hidden_size: int,
                   num_layers: int, bidirectional: bool) -> List[Params]:
    """Layer i>0 consumes num_directions*hidden (util.py:1157-1160)."""
    nd = 2 if bidirectional else 1
    layers = []
    for i in range(num_layers):
        in_sz = input_size if i == 0 else nd * hidden_size
        layer = {"fwd": init_lstm_layer(gen, in_sz, hidden_size)}
        if bidirectional:
            layer["bwd"] = init_lstm_layer(gen, in_sz, hidden_size)
        layers.append(layer)
    return layers


def init_cell_stack(gen: torch.Generator, input_size: int, hidden_size: int,
                    num_layers: int) -> List[Params]:
    return [init_lstm_layer(gen, input_size if i == 0 else hidden_size,
                            hidden_size)
            for i in range(num_layers)]


# --------------------------------------------------------------------------
# single-step cells (decoder path; reference RNNCellBase util.py:1650-1661)
# --------------------------------------------------------------------------
def lstm_from_gates(gates, c):
    """(h', c') from pre-activation gates [.., 4H] (i, f, g, o order)."""
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c2)
    return h2, c2


def lstm_step(p: Params, x, h, c):
    gates = x @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"]
    return lstm_from_gates(gates, c)


def cell_stack_step(mode: str, layers: List[Params], x,
                    state: Optional[List]) -> List:
    """One decode step through the LSTM layer stack; returns the new
    per-layer (h, c) list."""
    if mode != "LSTM":
        raise NotImplementedError(
            f"decoder_type {mode!r}: only LSTM is ported so far (GRU/RNN "
            f"cells come with the encoder-families slice)")
    if state is None:
        state = [None] * len(layers)
    new_states = []
    for i, p in enumerate(layers):
        H = p["w_hh"].shape[0]
        s = state[i] if state[i] is not None else (
            x.new_zeros((x.shape[0], H)), x.new_zeros((x.shape[0], H)))
        h, c = lstm_step(p, x, s[0], s[1])
        new_states.append((h, c))
        x = h
    return new_states


# --------------------------------------------------------------------------
# bidirectional time-major layer + residual stack
# --------------------------------------------------------------------------
def _bidir_lstm_layer_tm(p_fwd: Params, p_bwd: Params, x_tm, mask_tm):
    """One bidirectional LSTM layer, fully time-major.

    x_tm [T, B, D], mask_tm [T, B] -> (y [T, B, 2H] in natural time order,
    (h_f, c_f), (h_b, c_b)).  The backward direction iterates the
    statically flipped sequence: while the flipped step sits in a sample's
    padding the mask freezes its carry at zero, so its state only starts
    at that sample's true last frame."""
    T, B, _ = x_tm.shape

    def hoist(p, xi):
        return (torch.matmul(xi.reshape(T * B, -1), p["w_ih"])
                + p["b_ih"] + p["b_hh"]).reshape(T, B, -1)

    # flip the INPUT, not the gates: D channels move instead of 4H
    xg_f = hoist(p_fwd, x_tm)
    xg_b = hoist(p_bwd, torch.flip(x_tm, dims=(0,)))
    m_f = mask_tm.contiguous()
    m_b = torch.flip(mask_tm, dims=(0,)).contiguous()
    w_hh = torch.stack([p_fwd["w_hh"], p_bwd["w_hh"]])     # [2, H, 4H]
    ys_f, ys_b, hT, cT = lstm_k.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b,
                                                     w_hh)
    y = torch.cat([ys_f, torch.flip(ys_b, dims=(0,))], dim=-1)
    return y, (hT[0], cT[0]), (hT[1], cT[1])


def rnn_stack(mode: str, layers: List[Params], x, lens, mask,
              residual: bool = True, skip_step: int = 0):
    """Residual stack: y_i added onto the running sum from layer 1 on
    (util.py:1284-1291).  Returns (y [B, T', 2H], ((h_f, c_f), (h_b, c_b))
    of the last layer, lens, mask).  skip_step > 0 subsamples time between
    layers (util.py:1294-1316)."""
    if mode != "LSTM" or not layers or not all("bwd" in l for l in layers):
        raise NotImplementedError(
            "only the bidirectional LSTM stack is ported so far "
            "(unidirectional and GRU/RNN stacks come with the "
            "encoder-families slice)")
    x_tm = x.transpose(0, 1)
    m_tm = mask.transpose(0, 1)
    states = None
    for i, layer in enumerate(layers):
        y, s_f, s_b = _bidir_lstm_layer_tm(layer["fwd"], layer["bwd"],
                                           x_tm, m_tm)
        states = (s_f, s_b)
        x_tm = x_tm + y if (residual and i > 0) else y
        if skip_step > 0 and i < len(layers) - 1:
            x_tm = x_tm[::skip_step]
            lens = torch.clamp(torch.div(lens, skip_step,
                                         rounding_mode="floor"), min=1)
            m_tm = m_tm[::skip_step]
    return x_tm.transpose(0, 1), states, lens, m_tm.transpose(0, 1)
