"""Masked convolution blocks (port of ``chinese_asr_tpu/ops/conv.py``;
reference util.py:145-183 pad/pad2d, util.py:1327-1573 Conv1D/Conv2D).

Tensors and weights keep the JAX package's channel-last layouts
([B, T, C] / [B, T, F, C]; conv1d weights [ks, in, out], conv2d weights
[kt, kf, in, out]), so a JAX parameter tree carries over leaf for leaf;
each conv permutes to torch's channel-first layout around
``F.conv1d`` / ``F.conv2d`` (cross-correlation in both frameworks).

The reference's "auto-pad so no frame is dropped" (util.py:145-158) is a
right/bottom pad derived from the array length; output lengths follow
``(l - ks + stride - 1) // stride + 1`` and padding positions are zeroed.
BatchNorm statistics include the padded positions, as the reference's do
("BN under padding", reference encoder.py:465); ``train=True`` normalizes
with the biased batch statistics and records them for the train step's
running-stat update, ``train=False`` uses the stored running stats.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .masks import length_mask
from .rnn import xavier_normal as _xavier
from .cuda import gemm as gemm_k
from .cuda import subsample as subsample_k

Params = Dict[str, torch.Tensor]


def conv_out_len(lens, ks: int, stride: int):
    """Reference length recompute (util.py:1430): floor((l-ks+s-1)/s)+1."""
    return torch.clamp(torch.div(lens - ks + stride - 1, stride,
                                 rounding_mode="floor") + 1, min=0)


def norm_params(out_c: int, norm: str) -> Params:
    p = {}
    if norm != "NONE":
        p["norm_scale"] = torch.ones(out_c)
        p["norm_bias"] = torch.zeros(out_c)
    if norm == "BN":
        p["bn_mean"] = torch.zeros(out_c)
        p["bn_var"] = torch.ones(out_c)
    return p


class ShardStats(list):
    """The ``updates`` list of a train step on a data-parallel mesh: BN sums
    each channel's statistics over the ``shards`` data ranks' rows with
    ``sum_batch`` (a sum over the data axis through autograd,
    ``sharding.sum_shares_over_data``), as JAX's SPMD mean runs over the
    whole sharded batch axis."""

    def __init__(self, sum_batch, shards: int):
        super().__init__()
        self.sum_batch = sum_batch
        self.shards = shards


def apply_norm(p: Params, y, norm: str, train: bool, eps: float = 1e-5,
               spatial_axes: Tuple[int, ...] = (1,), updates=None):
    """y [..., C]: BN per channel over batch + spatial (padding included),
    LN over channels, IN per sample over spatial.  BN with ``train``
    normalizes with the biased batch statistics and, when ``updates`` (a
    list) is given, records ``(param_dict, batch_mean, batch_var, n)``
    for ``bn_stats_tree``; without ``train`` it uses the running stats.
    When ``updates`` is a ``ShardStats`` (training on a data-parallel
    mesh), y is one shard of the batch and the statistics are the global
    batch's."""
    if norm == "NONE":
        return y
    if norm == "BN":
        if train:
            axes = (0,) + tuple(spatial_axes)
            n = 1
            for a in axes:
                n *= y.shape[a]
            sum_batch = getattr(updates, "sum_batch", None)
            if sum_batch is None:
                mean = y.mean(dim=axes)
                var = y.var(dim=axes, unbiased=False)
            else:
                # y is one data shard of the batch: the statistics are the
                # global batch's, the shards' sums summed (two passes)
                n *= updates.shards
                mean = sum_batch(y.sum(dim=axes)) / n
                var = sum_batch(torch.square(y - mean).sum(dim=axes)) / n
            if updates is not None:
                updates.append((p, mean, var, n))
        else:
            mean, var = p["bn_mean"], p["bn_var"]
        yn = (y - mean) * torch.rsqrt(var + eps)
    elif norm == "LN":
        mean = y.mean(dim=-1, keepdim=True)
        var = y.var(dim=-1, unbiased=False, keepdim=True)
        yn = (y - mean) * torch.rsqrt(var + eps)
    elif norm == "IN":
        mean = y.mean(dim=tuple(spatial_axes), keepdim=True)
        var = y.var(dim=tuple(spatial_axes), unbiased=False, keepdim=True)
        yn = (y - mean) * torch.rsqrt(var + eps)
    else:
        raise ValueError(norm)
    return yn * p["norm_scale"] + p["norm_bias"]


def apply_act(y, act: str):
    if act == "GLU":
        a, b = torch.chunk(y, 2, dim=-1)
        return a * torch.sigmoid(b)
    if act == "RELU":
        return torch.relu(y)
    if act == "SIGMOID":
        return torch.sigmoid(y)
    if act == "TANH":
        return torch.tanh(y)
    return y


def conv1d_nwc(x, w, stride: int = 1, padding=(0, 0)):
    """x [B, T, C], w [ks, C, C'] -> [B, T', C'] (``padding`` (left, right)
    zeros along T)."""
    xc = x.transpose(1, 2)
    if any(padding):
        xc = F.pad(xc, padding)
    return F.conv1d(xc, w.permute(2, 1, 0), stride=stride).transpose(1, 2)


def conv2d_nhwc(x, w, stride=(1, 1), padding=(0, 0, 0, 0)):
    """x [B, T, F, C], w [kt, kf, C, C'] -> [B, T', F', C'] (``padding``
    (f_lo, f_hi, t_lo, t_hi) zeros, ``F.pad``'s order for the last two
    dims of the channel-first tensor)."""
    xc = x.permute(0, 3, 1, 2)
    if any(padding):
        xc = F.pad(xc, padding)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Conv1D block: conv -> norm -> act -> skip -> length mask
# --------------------------------------------------------------------------
def init_conv1d(gen: torch.Generator, in_c: int, out_c: int, ks: int,
                norm: str = "NONE") -> Params:
    # torch Conv1d weight [out, in, ks]: xavier fans are (in*ks, out*ks)
    p = {"w": _xavier(gen, (ks, in_c, out_c), in_c * ks, out_c * ks),
         "b": torch.zeros(out_c)}
    p.update(norm_params(out_c, norm))
    return p


def conv1d_block(p: Params, x, lens, ks: int, stride: int, act: str = "NONE",
                 norm: str = "NONE", skip_connect: bool = False,
                 train: bool = False, updates=None):
    """x [B, T, C] (padding zeroed), lens [B] -> (y [B, T', C'], out_lens).
    Order as the reference's (util.py:1389-1434): pad -> conv -> norm ->
    act -> strided-identity skip -> recompute lens -> zero mask."""
    T = x.shape[1]
    right = (stride - (T - ks) % stride) % stride
    if right:
        x = F.pad(x, (0, 0, 0, right))
    y = conv1d_nwc(x, p["w"], stride) + p["b"]
    y = apply_norm(p, y, norm, train, updates=updates)
    y = apply_act(y, act)
    if skip_connect:
        y = y + x[:, ks - 1::stride, :][:, : y.shape[1], :]
    out_lens = conv_out_len(lens, ks, stride)
    y = y * length_mask(out_lens, y.shape[1], y.dtype)[..., None]
    return y, out_lens


# --------------------------------------------------------------------------
# Conv2D block over [B, T, F, C] (T = variable-length time)
# --------------------------------------------------------------------------
def init_conv2d(gen: torch.Generator, in_c: int, out_c: int, ks,
                norm: str = "NONE") -> Params:
    kh, kw = (ks, ks) if isinstance(ks, int) else ks
    p = {"w": _xavier(gen, (kh, kw, in_c, out_c), in_c * kh * kw,
                      out_c * kh * kw),
         "b": torch.zeros(out_c)}
    p.update(norm_params(out_c, norm))
    return p


def conv2d_block(p: Params, x, lens, ks, stride, act: str = "NONE",
                 norm: str = "NONE", skip_connect: bool = False,
                 train: bool = False, freq_pad: Optional[int] = None,
                 updates=None):
    """x [B, T, F, C], lens over T -> (y [B, T', F', C'], out_lens).
    ``freq_pad`` pads the frequency axis on both sides first (the
    reference's explicit h_pad, encoder.py:325)."""
    kt, kf = (ks, ks) if isinstance(ks, int) else ks
    st, sf = (stride, stride) if isinstance(stride, int) else stride
    if freq_pad:
        x = F.pad(x, (0, 0, freq_pad, freq_pad))
    T, Fq = x.shape[1], x.shape[2]
    right = (st - (T - kt) % st) % st
    bottom = (sf - (Fq - kf) % sf) % sf
    if right or bottom:
        x = F.pad(x, (0, 0, 0, bottom, 0, right))
    y = conv2d_nhwc(x, p["w"], (st, sf)) + p["b"]
    y = apply_norm(p, y, norm, train, spatial_axes=(1, 2), updates=updates)
    y = apply_act(y, act)
    if skip_connect:
        ident = x[:, kt - 1::st, kf - 1::sf, :]
        y = y + ident[:, : y.shape[1], : y.shape[2], :]
    out_lens = conv_out_len(lens, kt, st)
    y = y * length_mask(out_lens, y.shape[1], y.dtype)[:, :, None, None]
    return y, out_lens


# --------------------------------------------------------------------------
# BatchNorm running statistics (torch semantics) for the train step
# --------------------------------------------------------------------------
def bn_stats_tree(params, updates):
    """``apply_norm`` recordings -> a tree mirroring ``params``: the
    recorded sub-dicts (matched by identity, so this takes the tree the
    forward ran on) carry ``{"__bn__": (batch_mean, unbiased_batch_var)}``,
    every other node is None.  None when nothing was recorded."""
    if not updates:
        return None
    table = {id(p): (m, v * (n / max(n - 1, 1))) for p, m, v, n in updates}

    def rec(node):
        if isinstance(node, dict):
            out = {k: rec(v) for k, v in node.items()}
            if id(node) in table:
                out["__bn__"] = table[id(node)]
            return None if all(v is None for v in out.values()) else out
        if isinstance(node, (list, tuple)):
            seq = [rec(v) for v in node]
            return None if all(v is None for v in seq) else seq
        return None

    return rec(params)


def merge_bn_stats(new_params, stats_tree, momentum: float = 0.1):
    """Fold a ``bn_stats_tree`` into the running stats with torch's moving
    average ``running = (1 - momentum) * running + momentum * batch_stat``
    (the unbiased batch variance into running_var), in the running
    buffers' dtype."""
    if stats_tree is None:
        return new_params

    def rec(node, st):
        if st is None:
            return node
        if isinstance(node, dict):
            out = {k: rec(v, st.get(k)) for k, v in node.items()}
            if "__bn__" in st:
                m, v = st["__bn__"]
                out["bn_mean"] = ((1 - momentum) * node["bn_mean"]
                                  + momentum * m.to(node["bn_mean"].dtype))
                out["bn_var"] = ((1 - momentum) * node["bn_var"]
                                 + momentum * v.to(node["bn_var"].dtype))
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(rec(n, s) for n, s in zip(node, st))
        return node

    return rec(new_params, stats_tree)


# --------------------------------------------------------------------------
# same-shape residual conv2d (reference ResCNN, encoder.py:411-478)
# --------------------------------------------------------------------------
def init_same_conv2d(gen: torch.Generator, in_c: int, out_c: int,
                     ks: int = 3) -> Params:
    return {"w": _xavier(gen, (ks, ks, in_c, out_c), in_c * ks * ks,
                         out_c * ks * ks),
            "b": torch.zeros(out_c)}


def same_conv2d(p: Params, x):
    """Stride-1 SAME conv, [B, T, F, C] -> [B, T, F, C'] (XLA's SAME: the
    odd pad on the high side)."""
    kt, kf = p["w"].shape[:2]
    t0, f0 = (kt - 1) // 2, (kf - 1) // 2
    return conv2d_nhwc(x, p["w"], padding=(f0, kf - 1 - f0,
                                           t0, kt - 1 - t0)) + p["b"]


# --------------------------------------------------------------------------
# the Conformer's convolutions: ESPnet's Conv2dSubsampling (two valid 3x3
# stride-2 convolutions with ReLU, flattened channel-major into a linear
# map) and the convolution module's depthwise conv1d and BatchNorm
# --------------------------------------------------------------------------
# the most elements the subsampling's first convolution holds at once off
# K8: it runs a slice of rows at a time, so that the widest intermediate
# of the model ([B, C, (T-1)/2, (F-1)/2], 6.6 GB at B=128 of 13 s, C=512)
# is not held whole (1 GiB in float32)
SUBSAMPLE_SLICE_ELEMS = 1 << 28


def subsample_out_len(lens):
    """Frames out of the two valid stride-2 convolutions of a row of
    ``lens`` frames: ((l - 1) // 2 - 1) // 2, at least 0."""
    l1 = torch.div(lens - 1, 2, rounding_mode="floor")
    return torch.clamp(torch.div(l1 - 1, 2, rounding_mode="floor"), min=0)


def conv2d_subsampling(p: Dict[str, Params], x, lens):
    """x [B, T, F] features (padding zeroed), lens [B] -> (y [B, T2, d]
    zero past each row's length, T2 = ((T - 1) // 2 - 1) // 2, the lens
    out).  ``p``: ``conv1`` / ``conv2`` ({w [3, 3, in, C], b [C]}, the
    layout of ``init_conv2d``) and ``out`` ({w [C * F2, d], b [d]}, F2 =
    ((F - 1) // 2 - 1) // 2).  On the card both convolutions with their
    ReLUs are one K8 launch over the whole batch (``ops/cuda/subsample.py``
    ``convs``), whose output is the map's input; elsewhere (the CPU,
    autograd) they are two ``F.conv2d``.  A valid convolution's outputs
    within a row's length read only that row's frames; rows are
    independent, so off K8 the convolutions run ``SUBSAMPLE_SLICE_ELEMS``
    at a time."""
    c1, c2 = p["conv1"], p["conv2"]
    h = subsample_k.convs(x, c1["w"], c1["b"], c2["w"], c2["b"])
    if h is not None:
        y = gemm_k.linear(h, p["out"]["w"], p["out"]["b"])
    else:
        B, T, Fq = x.shape
        w1 = c1["w"].permute(3, 2, 0, 1)
        w2 = c2["w"].permute(3, 2, 0, 1)
        per_row = w1.shape[0] * ((T - 1) // 2) * ((Fq - 1) // 2)
        rows = max(1, SUBSAMPLE_SLICE_ELEMS // max(1, per_row))
        outs = []
        for s in range(0, B, rows):
            h = F.conv2d(x[s:s + rows, None], w1, c1["b"], stride=2).relu_()
            h = F.conv2d(h, w2, c2["b"], stride=2).relu_()
            # [b, C, T2, F2] -> [b, T2, C * F2]: feature c * F2 + f
            outs.append(gemm_k.linear(h.transpose(1, 2).flatten(2),
                                      p["out"]["w"], p["out"]["b"]))
        y = outs[0] if len(outs) == 1 else torch.cat(outs)
    lens = subsample_out_len(lens)
    return y * length_mask(lens, y.shape[1], y.dtype)[..., None], lens


def depthwise_conv1d_same(x, w, b, lens):
    """x [B, L, C], w [K, C], b [C] -> [B, C, L] channel-first: each
    channel convolved with its own K taps, frames at or past a row's
    length zeroed at the input, padded as torch's ``padding="same"``
    ((K - 1) // 2 frames before, K // 2 after: 15 and 16 at the
    Conformer's K = 32; for an odd K as many each side, 15 and 15 at the
    E-Branchformer's K = 31, ESPnet's symmetric padding)."""
    K = w.shape[0]
    x = x * length_mask(lens, x.shape[1], x.dtype)[..., None]
    xc = F.pad(x.transpose(1, 2), ((K - 1) // 2, K // 2))
    return F.conv1d(xc, w.t()[:, None, :], b, groups=x.shape[2])


def batch_norm_channels_first(p: Params, y, train: bool, eps: float = 1e-5,
                              updates=None):
    """``apply_norm``'s BatchNorm of y [B, C, L] over its channels, with
    its ``train`` / ``updates`` contract; in inference one fused kernel
    over the running statistics."""
    if train:
        return apply_norm(p, y.transpose(1, 2), "BN", True, eps,
                          updates=updates).transpose(1, 2)
    return F.batch_norm(y, p["bn_mean"], p["bn_var"], p["norm_scale"],
                        p["norm_bias"], False, 0.0, eps)
