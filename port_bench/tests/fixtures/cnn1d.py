"""The CNN1D family (reference encoder.py:102-144), kept as a test
fixture: ``test_pb_encoders.py`` copies it into a copy of the benchmark
as ``encoders/cnn1d.py``, to show that a configuration with another
encoder is added in new files alone.

A stack of strided 1-D convolutions over the front end's frames, each
``hidden_size`` channels wide with kernel ``ks``, one a stride of
``stride`` (the shorter of the layers and the strides wins): the
reference's right pad so that no frame is dropped, the convolution,
BatchNorm with its running statistics, ReLU, from the second layer on a
strided identity skip where ``residual``, and frames past a row's
length zeroed (the program's ``ops/conv.py`` ``conv1d_block``).  Its
tensors are the program's: ``encoder/convs[i]/w`` [ks, in, out]
(xavier-normal, fans in x ks and out x ks), ``b`` and ``norm_bias`` and
``bn_mean`` zeros, ``norm_scale`` and ``bn_var`` ones.  It has no
recurrent state, so the decoder starts from zeros.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference.las import initial_state
from port_bench.roofline import shapes

BN_EPS = 1e-5


def _plan(enc: dict):
    """(ks, stride) a layer."""
    return [(enc["ks"], int(s)) for s in enc["stride"][:enc["num_layers"]]]


def _out_len(n, ks: int, stride: int):
    """Frames out of ``n`` in (reference util.py:1430)."""
    return (n - ks + stride - 1) // stride + 1


def enc_size(cfg: dict) -> int:
    return cfg["encoder"]["hidden_size"]


def layout(cfg: dict):
    enc = cfg["encoder"]
    if enc["norm"] != "BN" or enc["act"] != "RELU":
        raise ValueError("the CNN1D family's reference is the BN, ReLU stack")
    C, c_in = enc["hidden_size"], shapes.feature_width(cfg["audio"])
    out = []
    for i, (ks, _) in enumerate(_plan(enc)):
        pre = ("encoder", "convs", i)
        out += [(pre + ("w",), (ks, c_in, C),
                 math.sqrt(2.0 / (c_in * ks + C * ks))),
                (pre + ("b",), (C,), "zeros"),
                (pre + ("norm_scale",), (C,), "ones"),
                (pre + ("norm_bias",), (C,), "zeros"),
                (pre + ("bn_mean",), (C,), "zeros"),
                (pre + ("bn_var",), (C,), "ones")]
        c_in = C
    return out


def frames(feature_frames: int, cfg: dict) -> int:
    n = feature_frames
    for ks, s in _plan(cfg["encoder"]):
        n = max(0, _out_len(n, ks, s))
    return n


def tiny(enc: dict) -> dict:
    return dict(enc, hidden_size=16, num_layers=2, stride=[2, 2])


def flops(cfg: dict, frames: int) -> float:
    """Each layer's product over its output frames (2 L ks C_in C)."""
    enc = cfg["encoder"]
    C, c_in = enc["hidden_size"], shapes.feature_width(cfg["audio"])
    f, n = 0.0, frames
    for ks, s in _plan(enc):
        n = max(0, _out_len(n, ks, s))
        f += 2 * n * ks * c_in * C
        c_in = C
    return f


def encode(prec, params, x, lens, cfg):
    enc = cfg["encoder"]
    for i, (ks, s) in enumerate(_plan(enc)):
        p = params["encoder"]["convs"][i]
        T = x.shape[1]
        x = torch.nn.functional.pad(x, (0, 0, 0, (s - (T - ks) % s) % s))
        B, _, c_in = x.shape
        win = x.unfold(1, ks, s).transpose(2, 3)          # [B, L, ks, C_in]
        y = prec.mm(win.reshape(B, win.shape[1], ks * c_in),
                    p["w"].reshape(ks * c_in, -1)) + p["b"]
        y = (y - p["bn_mean"]) * torch.rsqrt(p["bn_var"] + BN_EPS) \
            * p["norm_scale"] + p["norm_bias"]
        y = torch.relu(y)
        if enc["residual"] and i > 0:
            y = y + x[:, ks - 1::s][:, :y.shape[1]]
        lens = torch.clamp(_out_len(lens, ks, s), min=0)
        live = torch.arange(y.shape[1], device=y.device)[None, :] \
            < lens[:, None]
        x = y * live[..., None]
    return x, lens, initial_state(params, x)
