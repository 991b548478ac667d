"""The Conformer encoder (Gulati et al., "Conformer: Convolution-augmented
Transformer for Speech Recognition", arXiv:2005.08100, section 2 and
Figure 1), a family of its own with no counterpart in the reference or
the JAX package.

ESPnet's ``Conv2dSubsampling`` (``ops/conv.py`` ``conv2d_subsampling``:
two valid 3x3 stride-2 convolutions of ``hidden_size`` channels with
ReLU, flattened channel-major, a linear map to d = ``hidden_size``)
takes the front end's frames to a quarter, then ``num_layers`` blocks
of

  x1 = x + 1/2 FFN(x)            FFN: LN, Linear d -> ``ffn_size``,
                                 Swish, Linear back to d
  x2 = x1 + MHSA(LN(x1))         ``ops/self_attention.py``
                                 ``rel_pos_attention``, ``self_attn_heads``
                                 heads over Transformer-XL relative
                                 positions
  x3 = x2 + Conv(x2)             LN, pointwise d -> 2d, GLU, depthwise
                                 conv1d of kernel ``ks`` (torch's "same"
                                 padding; frames past a row's length zero
                                 at its input), BatchNorm, Swish,
                                 pointwise d -> d
  y  = LN(x3 + 1/2 FFN(x3))

with no dropout and the input not scaled by sqrt(d).  Its output is d
wide, zero past each row's length; it has no recurrent state, so the
decoder starts from zeros.  The BatchNorm follows ``ops/conv.py``
``apply_norm``: with ``train`` it normalizes with batch statistics
(padded frames included) and records them for the train step.

Parameters: ``subsample/{conv1, conv2}/{w [3, 3, in, C], b}``,
``subsample/out/{w [C * F2, d], b}``, and for each block ``ffn1`` and
``ffn2`` ({ln_scale, ln_bias, w1, b1, w2, b2}), ``mhsa`` ({ln_scale,
ln_bias, w_qkv, b_qkv, w_pos, pos_u, pos_v, w_o, b_o}), ``conv``
({ln_scale, ln_bias, pw1_w [d, 2d], pw1_b, dw_w [ks, d], dw_b,
norm_scale, norm_bias, bn_mean, bn_var, pw2_w, pw2_b}), ``ln_scale``,
``ln_bias``.

``blocks`` counts the blocks applied, as the kernel wrappers count their
launches: a registered counter (``utils/observe.py``), so a graph's
replay counts its blocks.  The dense products are ``ops/cuda/gemm.py``
``linear`` (K7 on the card).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops import conv as conv_ops
from ..ops import self_attention as sa_ops
from ..ops.cuda import gemm as gemm_k
from ..ops.masks import length_mask
from ..ops.rnn import xavier_normal
from ..utils import observe

Params = Dict

blocks = 0      # blocks applied (launch-style: a graph's replay adds its own)
observe.register_counters(__name__, "blocks")

LN_EPS = 1e-5
BN_EPS = 1e-5


def subsample_width(n_feats: int) -> int:
    """Features a frame along the subsampling's frequency axis: F2."""
    return ((n_feats - 1) // 2 - 1) // 2


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_linear(gen, d_in: int, d_out: int) -> tuple:
    """An xavier-normal [d_in, d_out] matrix and a zero bias."""
    return xavier_normal(gen, (d_in, d_out), d_in, d_out), torch.zeros(d_out)


def init_ffn(gen, d: int, f: int) -> Params:
    w1, b1 = init_linear(gen, d, f)
    w2, b2 = init_linear(gen, f, d)
    return {"ln_scale": torch.ones(d), "ln_bias": torch.zeros(d),
            "w1": w1, "b1": b1, "w2": w2, "b2": b2}


def init_block(gen: torch.Generator, d: int, heads: int, ffn: int,
               ks: int) -> Params:
    w_qkv, b_qkv = init_linear(gen, d, 3 * d)
    w_o, b_o = init_linear(gen, d, d)
    pw1_w, pw1_b = init_linear(gen, d, 2 * d)
    pw2_w, pw2_b = init_linear(gen, d, d)
    conv = {"ln_scale": torch.ones(d), "ln_bias": torch.zeros(d),
            "pw1_w": pw1_w, "pw1_b": pw1_b,
            # a channel's filter: fan in and out of ks taps each
            "dw_w": xavier_normal(gen, (ks, d), ks, ks),
            "dw_b": torch.zeros(d), "pw2_w": pw2_w, "pw2_b": pw2_b}
    conv.update(conv_ops.norm_params(d, "BN"))
    return {
        "ffn1": init_ffn(gen, d, ffn),
        "mhsa": {"ln_scale": torch.ones(d), "ln_bias": torch.zeros(d),
                 "w_qkv": w_qkv, "b_qkv": b_qkv,
                 "w_pos": xavier_normal(gen, (d, d), d, d),
                 "pos_u": torch.zeros(heads, d // heads),
                 "pos_v": torch.zeros(heads, d // heads),
                 "w_o": w_o, "b_o": b_o},
        "conv": conv,
        "ffn2": init_ffn(gen, d, ffn),
        "ln_scale": torch.ones(d), "ln_bias": torch.zeros(d),
    }


def init_subsample(gen: torch.Generator, d: int, n_feats: int) -> Params:
    """``ops/conv.py`` ``conv2d_subsampling``'s tensors."""
    out_w, out_b = init_linear(gen, d * subsample_width(n_feats), d)
    return {"conv1": {"w": xavier_normal(gen, (3, 3, 1, d), 9, 9 * d),
                      "b": torch.zeros(d)},
            "conv2": {"w": xavier_normal(gen, (3, 3, d, d), 9 * d, 9 * d),
                      "b": torch.zeros(d)},
            "out": {"w": out_w, "b": out_b}}


def init_conformer(gen: torch.Generator, cfg: Config) -> Params:
    e = cfg.encoder
    return {"subsample": init_subsample(gen, e.hidden_size,
                                        cfg.audio.feat_dim),
            "blocks": [init_block(gen, e.hidden_size, e.self_attn_heads,
                                  e.ffn_size, e.ks)
                       for _ in range(e.num_layers)]}


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------
def layer_norm(p: Params, x):
    """LayerNorm over the last axis with ``p``'s ``ln_scale``, ``ln_bias``."""
    return F.layer_norm(x, x.shape[-1:], p["ln_scale"], p["ln_bias"], LN_EPS)


def feed_forward(p: Params, x):
    """LN, Linear d -> f, Swish, Linear f -> d."""
    h = F.silu(gemm_k.linear(layer_norm(p, x), p["w1"], p["b1"]))
    return gemm_k.linear(h, p["w2"], p["b2"])


def _conv_module(p: Params, x, lens, train: bool, updates):
    h = F.glu(gemm_k.linear(layer_norm(p, x), p["pw1_w"], p["pw1_b"]),
              dim=-1)
    h = conv_ops.depthwise_conv1d_same(h, p["dw_w"], p["dw_b"], lens)
    h = conv_ops.batch_norm_channels_first(p, h, train, BN_EPS, updates)
    return gemm_k.linear(F.silu(h).transpose(1, 2), p["pw2_w"],
                         p["pw2_b"])


def block(p: Params, x, lens, heads: int, table, train: bool = False,
          updates=None):
    """One Conformer block, x [B, L, d] -> [B, L, d] (module docstring);
    ``table``: the relative positions' sinusoids (``ops/self_attention.py``
    ``rel_pos_table``)."""
    global blocks
    blocks += 1
    x = x + 0.5 * feed_forward(p["ffn1"], x)
    x = x + sa_ops.rel_pos_attention(p["mhsa"], layer_norm(p["mhsa"], x),
                                     lens, heads, table)
    x = x + _conv_module(p["conv"], x, lens, train, updates)
    x = x + 0.5 * feed_forward(p["ffn2"], x)
    return layer_norm(p, x)


def apply_conformer(p: Params, cfg: Config, x, lens, train: bool = False,
                    updates=None):
    """x [B, T, feat_dim] (padding zeroed), lens [B] -> (y [B, T2, d] zero
    past each row's length, T2 = ((T - 1) // 2 - 1) // 2, its lens)."""
    x, lens = conv_ops.conv2d_subsampling(p["subsample"], x, lens)
    table = sa_ops.rel_pos_table(x.shape[1], x.shape[2], x.dtype, x.device)
    for blk in p["blocks"]:
        x = block(blk, x, lens, cfg.encoder.self_attn_heads, table, train,
                  updates)
    return x * length_mask(lens, x.shape[1], x.dtype)[..., None], lens
