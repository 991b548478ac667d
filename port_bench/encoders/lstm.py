"""The LSTM family: the flagship's residual stack of bidirectional LSTM
layers (reference encoder.py:9-83, util.py:1284-1291).

Its tensors are ``encoder/layers[i]/{fwd,bwd}/{w_ih, w_hh, b_ih, b_hh}``
with right-multiplied ``[in, out]`` matrices and gates in (i, f, g, o)
order: xavier-normal input matrices, recurrent matrices at the scale of
an orthogonal matrix's entries, forget-gate biases 0.5.  Its output is
the two directions concatenated, ``2H`` wide, one frame a front-end
frame; its final state is the last layer's, directions concatenated.
Departure from the published code, the program's documented semantics:
the backward direction of each layer starts from zero at a row's last
frame (a packed sequence does the same).
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.las import _lstm_cell, initial_state
from port_bench.roofline import shapes


def _check(enc: dict) -> None:
    """The stack the reference computes: bidirectional, residual, every
    frame kept."""
    if not (enc["bidirectional"] and enc["residual"]
            and enc["skip_step"] == 0):
        raise ValueError("the LSTM family's reference is the residual "
                         "bidirectional stack without skip_step")


def enc_size(cfg: dict) -> int:
    return 2 * cfg["encoder"]["hidden_size"]


def layout(cfg: dict):
    enc = cfg["encoder"]
    _check(enc)
    D = shapes.feature_width(cfg["audio"])
    H = enc["hidden_size"]
    out = []
    for i in range(enc["num_layers"]):
        d_in = D if i == 0 else enc_size(cfg)
        for d in ("fwd", "bwd"):
            pre = ("encoder", "layers", i, d)
            out += [(pre + ("w_ih",), (d_in, 4 * H),
                     math.sqrt(2.0 / (d_in + 4 * H))),
                    (pre + ("w_hh",), (H, 4 * H), 1.0 / math.sqrt(4 * H)),
                    (pre + ("b_ih",), (4 * H,), ("forget", H)),
                    (pre + ("b_hh",), (4 * H,), ("forget", H))]
    return out


def frames(feature_frames: int, cfg: dict) -> int:
    return feature_frames


def tiny(enc: dict) -> dict:
    return dict(enc, hidden_size=16, num_layers=2)


def flops(cfg: dict, frames: int) -> float:
    """Each of the layers runs two directions of the input product (2 F
    D_in 4H) and the recurrent product (2 F H 4H)."""
    enc = cfg["encoder"]
    D, H = shapes.feature_width(cfg["audio"]), enc["hidden_size"]
    f = 0.0
    for i in range(enc["num_layers"]):
        d_in = D if i == 0 else 2 * H
        f += 2 * (2 * frames * d_in * 4 * H + 2 * frames * H * 4 * H)
    return f


# --------------------------------------------------------------------------
# the plain reference
# --------------------------------------------------------------------------
def _reverse(x, lens):
    """Each row's first ``lens`` steps of x [B, T, D] in reverse order,
    the rest in place."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(t < lens[:, None], lens[:, None] - 1 - t, t)
    return torch.gather(x, 1, idx[..., None].expand(x.shape))


def _lstm_dir(prec, p, x, lens):
    """x [B, T, D] -> (y [B, T, H] zero past each length, final (h, c))."""
    B, T, _ = x.shape
    H = p["w_hh"].shape[0]
    xg = prec.mm(x, p["w_ih"]) + p["b_ih"] + p["b_hh"]
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    ys = []
    for t in range(T):
        h2, c2 = _lstm_cell(prec, p, xg[:, t], h, c)
        live = (t < lens)[:, None]
        h = torch.where(live, h2, h)
        c = torch.where(live, c2, c)
        ys.append(torch.where(live, h2, torch.zeros_like(h2)))
    return torch.stack(ys, dim=1), (h, c)


def encoder(prec, layers, x, lens):
    """The residual stack of bidirectional LSTM layers -> (out [B, T, 2H],
    the last layer's final (h, c), directions concatenated)."""
    state = None
    for i, layer in enumerate(layers):
        y_f, (h_f, c_f) = _lstm_dir(prec, layer["fwd"], x, lens)
        y_b, (h_b, c_b) = _lstm_dir(prec, layer["bwd"], _reverse(x, lens),
                                    lens)
        y = torch.cat([y_f, _reverse(y_b, lens)], dim=-1)
        x = x + y if i > 0 else y
        state = (torch.cat([h_f, h_b], -1), torch.cat([c_f, c_b], -1))
    return x, state


def encode(prec, params, x, lens, cfg):
    enc, state = encoder(prec, params["encoder"]["layers"], x, lens)
    return enc, lens, initial_state(params, enc, state)
