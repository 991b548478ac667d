"""Recurrent ops over parameter dicts (port of ``chinese_asr_tpu/ops/rnn.py``):
LSTM, GRU, RNN_TANH and RNN_RELU cells, masked time loops, residual and
local stacks.

Parameter layout per layer/direction is the JAX package's (torch-
transposed for right-matmuls): w_ih [D, nH], w_hh [H, nH], b_ih, b_hh
[nH], in torch's gate order: LSTM (i, f, g, o), GRU (r, z, n).

The flagship encoder path stays TIME-MAJOR across the whole residual
stack: the input projection of each direction is one hoisted matmul
producing [T, B, 4H], the backward direction runs on the statically
flipped sequence with the flipped mask freezing its carry, and the
recurrence of both directions is one launch of kernel K2
(``ops/cuda/lstm.py``), and its backward, under autograd, one launch of
K2-bwd.  The stack runs in the activations' dtype: bf16
activations (``compute_dtype="bfloat16"``) take bf16 weights, masks and
zero states, the hoisted ``x @ W_ih`` in bf16, and K2's bf16 instance
(its bf16 twin on the CPU), as the JAX package's bf16 scan does.

Every other recurrence -- GRU and RNN layers and unidirectional stacks --
is a Python loop over time of plain torch ops with the input product
hoisted out of it, as JAX's ``lax.scan`` loops are plain XLA: no Pallas
kernel stands behind them.  The decoder's cells are plain torch too, but
for the LSTM cell's two gate products, which ``ops/cuda/gemm.py``
``linear_pair`` runs on K7 in float32 without autograd on the card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .cuda import gemm
from .cuda import lstm as lstm_k

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init (reference util.py:90-114: zeros bias + LSTM forget-bias 0.5,
# orthogonal hh, xavier-normal ih).  Weights are drawn on the CPU from an
# explicit generator, so a seed gives the same weights on every device.
# --------------------------------------------------------------------------
_GATES = {"LSTM": 4, "GRU": 3, "RNN_TANH": 1, "RNN_RELU": 1}


def xavier_normal(gen: torch.Generator, shape, fan_in: int, fan_out: int):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=gen)


def init_rnn_layer(gen: torch.Generator, mode: str, input_size: int,
                   hidden_size: int) -> Params:
    H, n = hidden_size, _GATES[mode]
    w_ih = xavier_normal(gen, (input_size, n * H), input_size, n * H)
    # torch orthogonal init of the full [n*H, H] matrix, stored transposed
    w_hh = torch.nn.init.orthogonal_(torch.empty(n * H, H),
                                     generator=gen).T.contiguous()
    b = torch.zeros(n * H)
    if mode == "LSTM":
        b[H:2 * H] = 0.5                    # forget-gate bias on each vector
    return {"w_ih": w_ih, "w_hh": w_hh, "b_ih": b.clone(), "b_hh": b.clone()}


def init_rnn_stack(gen: torch.Generator, mode: str, input_size: int,
                   hidden_size: int, num_layers: int,
                   bidirectional: bool) -> List[Params]:
    """Layer i>0 consumes num_directions*hidden (util.py:1157-1160)."""
    nd = 2 if bidirectional else 1
    layers = []
    for i in range(num_layers):
        in_sz = input_size if i == 0 else nd * hidden_size
        layer = {"fwd": init_rnn_layer(gen, mode, in_sz, hidden_size)}
        if bidirectional:
            layer["bwd"] = init_rnn_layer(gen, mode, in_sz, hidden_size)
        layers.append(layer)
    return layers


def init_cell_stack(gen: torch.Generator, mode: str, input_size: int,
                    hidden_size: int, num_layers: int) -> List[Params]:
    return [init_rnn_layer(gen, mode, input_size if i == 0 else hidden_size,
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
    gates = gemm.linear_pair(x, p["w_ih"], h, p["w_hh"], p["b_ih"],
                             p["b_hh"])
    return lstm_from_gates(gates, c)


def gru_from_gates(gi, gh, h):
    """h' from the input and hidden gate products [.., 3H] (torch order
    r, z, n; ``b_hn`` sits inside ``r * (...)``)."""
    ir, iz, inn = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(inn + r * hn)
    return (1.0 - z) * n + z * h


def gru_step(p: Params, x, h):
    return gru_from_gates(x @ p["w_ih"] + p["b_ih"],
                          h @ p["w_hh"] + p["b_hh"], h)


def _act(mode: str):
    return torch.tanh if mode == "RNN_TANH" else torch.relu


def rnn_step(p: Params, x, h, act):
    return act(x @ p["w_ih"] + h @ p["w_hh"] + p["b_ih"] + p["b_hh"])


def cell_stack_step(mode: str, layers: List[Params], x,
                    state: Optional[List]) -> List:
    """One decode step through the layer stack; returns the new per-layer
    state list ((h, c) tuples for LSTM, h tensors otherwise)."""
    if state is None:
        state = [None] * len(layers)
    new_states = []
    for i, p in enumerate(layers):
        z = x.new_zeros((x.shape[0], p["w_hh"].shape[0]))
        if mode == "LSTM":
            s = state[i] if state[i] is not None else (z, z)
            h, c = lstm_step(p, x, s[0], s[1])
            new_states.append((h, c))
        else:
            s = state[i] if state[i] is not None else z
            h = (gru_step(p, x, s) if mode == "GRU"
                 else rnn_step(p, x, s, _act(mode)))
            new_states.append(h)
        x = h
    return new_states


def map_state(fn, state: List) -> List:
    """``fn`` on every tensor of a per-layer cell state list, keeping its
    structure ((h, c) tuples for LSTM, h tensors otherwise)."""
    return [tuple(fn(e) for e in s) if isinstance(s, tuple) else fn(s)
            for s in state]


# --------------------------------------------------------------------------
# full-sequence masked time loops (JAX: lax.scan), batch-major [B, T, .]
# --------------------------------------------------------------------------
def _hoist(p: Params, x, both_biases: bool):
    B, T, _ = x.shape
    g = torch.matmul(x.reshape(B * T, -1), p["w_ih"]) + p["b_ih"]
    if both_biases:
        g = g + p["b_hh"]
    return g.reshape(B, T, -1)


def _scan(step, g, mask, state):
    """Run ``step(g_t, state) -> (h2, new_state_candidate)`` over time with
    the mask freezing the carry past each row's length; y_t = h2 * m_t."""
    ys = [state[0].new_zeros((g.shape[0], 0, state[0].shape[-1]))]
    for t in range(g.shape[1]):
        m = mask[:, t, None]
        h2, cand = step(g[:, t], state)
        state = tuple(m * a + (1.0 - m) * b for a, b in zip(cand, state))
        ys.append((h2 * m)[:, None])
    return torch.cat(ys, dim=1), state


def _scan_lstm(p: Params, x, mask, h0, c0):
    """x [B, T, D], mask [B, T] -> (y [B, T, H], (hT, cT))."""
    xg = _hoist(p, x, True)

    def step(g, s):
        h2, c2 = lstm_from_gates(g + s[0] @ p["w_hh"], s[1])
        return h2, (h2, c2)

    return _scan(step, xg, mask, (h0, c0))


def _scan_gru(p: Params, x, mask, h0):
    gi = _hoist(p, x, False)

    def step(g, s):
        h2 = gru_from_gates(g, s[0] @ p["w_hh"] + p["b_hh"], s[0])
        return h2, (h2,)

    y, (hT,) = _scan(step, gi, mask, (h0,))
    return y, hT


def _scan_rnn(p: Params, x, mask, h0, act):
    gi = _hoist(p, x, True)

    def step(g, s):
        h2 = act(g + s[0] @ p["w_hh"])
        return h2, (h2,)

    y, (hT,) = _scan(step, gi, mask, (h0,))
    return y, hT


def reverse_sequence(x, lens, max_len: Optional[int] = None):
    """Reverse the valid prefix of each row of x [B, T, ...] in time:
    position t < len maps to len-1-t, padding positions keep themselves."""
    T = x.shape[1] if max_len is None else max_len
    pos = torch.arange(T, device=x.device)[None, :]
    lens = lens.to(torch.int64)[:, None]
    idx = torch.where(pos < lens, lens - 1 - pos, pos)                # [B, T]
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def rnn_layer(mode: str, p: Params, x, mask, state=None):
    """One unidirectional layer.  x [B, T, D], mask [B, T] -> (y [B, T, H],
    state): (h, c) for LSTM else h, each [B, H]; zeros if None."""
    z = x.new_zeros((x.shape[0], p["w_hh"].shape[0]))
    if mode == "LSTM":
        return _scan_lstm(p, x, mask, *(state if state is not None
                                         else (z, z)))
    state = z if state is None else state
    if mode == "GRU":
        return _scan_gru(p, x, mask, state)
    return _scan_rnn(p, x, mask, state, _act(mode))


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
    ys_f, ys_b, hT, cT = lstm_k.bidir_lstm(xg_f, xg_b, m_f, m_b, w_hh)
    y = torch.cat([ys_f, torch.flip(ys_b, dims=(0,))], dim=-1)
    return y, (hT[0], cT[0]), (hT[1], cT[1])


def bidir_rnn_layer(mode: str, p_fwd: Params, p_bwd: Params, x, lens, mask):
    """Bidirectional layer -> (y [B, T, 2H], state_fwd, state_bwd).  LSTM
    takes the time-major K2 layer (static flip plus the mask); the other
    modes run the backward direction on each row reversed by its own
    length, as JAX does."""
    if mode == "LSTM":
        y, s_f, s_b = _bidir_lstm_layer_tm(p_fwd, p_bwd, x.transpose(0, 1),
                                           mask.transpose(0, 1))
        return y.transpose(0, 1), s_f, s_b
    y_f, s_f = rnn_layer(mode, p_fwd, x, mask)
    y_b, s_b = rnn_layer(mode, p_bwd, reverse_sequence(x, lens), mask)
    return torch.cat([y_f, reverse_sequence(y_b, lens)], dim=-1), s_f, s_b


def rnn_stack(mode: str, layers: List[Params], x, lens, mask,
              residual: bool = True, skip_step: int = 0):
    """Residual stack: y_i added onto the running sum from layer 1 on
    (util.py:1284-1291).  Returns (y, last layer's states, lens, mask): the
    states are (state_fwd, state_bwd) for a bidirectional stack, else
    (state,), each (h, c) for LSTM or h.  skip_step > 0 subsamples time
    between layers (util.py:1294-1316)."""
    if mode == "LSTM" and layers and all("bwd" in l for l in layers):
        # the flagship path stays time-major across the whole stack
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
    states = None
    for i, layer in enumerate(layers):
        if "bwd" in layer:
            y, s_f, s_b = bidir_rnn_layer(mode, layer["fwd"], layer["bwd"], x,
                                          lens, mask)
            states = (s_f, s_b)
        else:
            y, s = rnn_layer(mode, layer["fwd"], x, mask)
            states = (s,)
        x = x + y if (residual and i > 0) else y
        if skip_step > 0 and i < len(layers) - 1:
            x = x[:, ::skip_step]
            lens = torch.clamp(torch.div(lens, skip_step,
                                         rounding_mode="floor"), min=1)
            mask = mask[:, ::skip_step]
    return x, states, lens, mask


# --------------------------------------------------------------------------
# LocalRNN (reference util.py:1026-1146)
# --------------------------------------------------------------------------
def local_rnn(mode: str, layers: List[Params], x, lens, mask,
              residual: bool = False, skip_steps=None):
    """Per-layer-configurable stack.  Unlike ``rnn_stack``, ``skip_steps``
    is per layer and applies after every layer including the last
    (util.py:1119-1141), keeping the first frame of each group with the
    ceil-div length ``(lens + step - 1) // step``; residual defaults off.
    Returns (y, per-layer states, lens, mask)."""
    if skip_steps is None:
        skip_steps = [1] * len(layers)
    skip_steps = ([skip_steps] * len(layers) if isinstance(skip_steps, int)
                  else list(skip_steps))
    assert len(skip_steps) == len(layers)
    all_states = []
    for i, layer in enumerate(layers):
        if "bwd" in layer:
            y, s_f, s_b = bidir_rnn_layer(mode, layer["fwd"], layer["bwd"], x,
                                          lens, mask)
            all_states.append((s_f, s_b))
        else:
            y, s = rnn_layer(mode, layer["fwd"], x, mask)
            all_states.append((s,))
        x = x + y if (residual and i > 0) else y
        step = skip_steps[i]
        if step > 1:
            x = x[:, ::step]
            lens = torch.div(lens + step - 1, step, rounding_mode="floor")
            mask = mask[:, ::step]
    return x, all_states, lens, mask
