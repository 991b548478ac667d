"""The E-Branchformer encoder (Kim et al., "E-Branchformer: Branchformer
with Enhanced merging for speech recognition", arXiv:2210.00077, section
3 and Figure 1; ESPnet's ``EBranchformerEncoder``), a family of its own
with no counterpart in the reference or the JAX package.

ESPnet's ``Conv2dSubsampling`` (``ops/conv.py`` ``conv2d_subsampling``,
as the Conformer's) takes the front end's frames to a quarter, scaled by
sqrt(d) (ESPnet's ``RelPositionalEncoding``), d = ``hidden_size``; then
``num_layers`` blocks of

  x  = x + 1/2 FFN1(x)          FFN: LN, Linear d -> ``ffn_size``, Swish,
                                Linear back to d
  g  = MHSA(LN(x))              ``ops/self_attention.py``
                                ``rel_pos_attention``, ``self_attn_heads``
                                heads over Transformer-XL relative
                                positions
  c  = cgMLP(x)                 LN, Linear d -> ``cgmlp_size``, GELU (erf);
                                r, h its first and second halves; h
                                through a LayerNorm of its own and a
                                depthwise conv1d of kernel ``ks``; Linear
                                cgmlp_size / 2 -> d of r * h
  x  = x + Merge(g, c)          m = [g, c] (2d wide): Linear 2d -> d of
                                m + a depthwise conv1d of kernel
                                ``merge_ks`` over m
  x  = x + 1/2 FFN2(x)
  x  = LN(x)
  y  = LN(x)                    after the last block (ESPnet's
                                ``after_norm``)

with LN eps 1e-5, no dropout and no layer drop.  Each depthwise conv
zeroes the frames at or past a row's length at its input and pads as
torch's "same" (for an odd kernel (k - 1) / 2 frames each side).  The
output is d wide, zero past each row's length; the encoder has no
recurrent state, so the decoder starts from zeros.

Parameters: ``subsample`` (``conformer.init_subsample``), for each block
``ffn1``, ``ffn2`` and ``mhsa`` as the Conformer's, ``cgmlp`` ({ln_scale,
ln_bias, w1 [d, cgmlp_size], b1, gate_ln_scale, gate_ln_bias, dw_w [ks,
cgmlp_size / 2], dw_b, w2 [cgmlp_size / 2, d], b2}), ``merge`` ({dw_w
[merge_ks, 2d], dw_b, w [2d, d], b}), ``ln_scale``, ``ln_bias``; and
``after_norm`` ({ln_scale, ln_bias}).

``blocks`` counts the blocks applied, launch-style: a registered counter
(``utils/observe.py``), so a graph's replay counts its blocks.  The nine
dense products a block (two a FFN, QKV, W_o, the cgMLP's two, the
merge's) are ``ops/cuda/gemm.py`` ``linear`` (K7 on the card).
"""

from __future__ import annotations

import math
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
from .conformer import (LN_EPS, feed_forward, init_ffn, init_linear,
                        init_subsample, layer_norm)

Params = Dict

blocks = 0      # blocks applied (launch-style: a graph's replay adds its own)
observe.register_counters(__name__, "blocks")


def _norm(d: int) -> Params:
    return {"ln_scale": torch.ones(d), "ln_bias": torch.zeros(d)}


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def init_block(gen: torch.Generator, d: int, heads: int, ffn: int,
               cgmlp: int, ks: int, merge_ks: int) -> Params:
    w_qkv, b_qkv = init_linear(gen, d, 3 * d)
    w_o, b_o = init_linear(gen, d, d)
    mhsa = dict(_norm(d), w_qkv=w_qkv, b_qkv=b_qkv,
                w_pos=xavier_normal(gen, (d, d), d, d),
                pos_u=torch.zeros(heads, d // heads),
                pos_v=torch.zeros(heads, d // heads), w_o=w_o, b_o=b_o)
    half = cgmlp // 2
    w1, b1 = init_linear(gen, d, cgmlp)
    w2, b2 = init_linear(gen, half, d)
    # a channel's filter: fan in and out of its taps
    branch = dict(_norm(d), w1=w1, b1=b1, gate_ln_scale=torch.ones(half),
                  gate_ln_bias=torch.zeros(half),
                  dw_w=xavier_normal(gen, (ks, half), ks, ks),
                  dw_b=torch.zeros(half), w2=w2, b2=b2)
    mw, mb = init_linear(gen, 2 * d, d)
    merge = {"dw_w": xavier_normal(gen, (merge_ks, 2 * d), merge_ks,
                                   merge_ks),
             "dw_b": torch.zeros(2 * d), "w": mw, "b": mb}
    return dict(_norm(d), ffn1=init_ffn(gen, d, ffn), mhsa=mhsa,
                cgmlp=branch, merge=merge, ffn2=init_ffn(gen, d, ffn))


def init_e_branchformer(gen: torch.Generator, cfg: Config) -> Params:
    e = cfg.encoder
    d = e.hidden_size
    return {"subsample": init_subsample(gen, d, cfg.audio.feat_dim),
            "blocks": [init_block(gen, d, e.self_attn_heads, e.ffn_size,
                                  e.cgmlp_size, e.ks, e.merge_ks)
                       for _ in range(e.num_layers)],
            "after_norm": _norm(d)}


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------
def cgmlp(p: Params, x, lens):
    """The local branch, x [B, L, d] (the block's input) -> [B, L, d]."""
    r, h = F.gelu(gemm_k.linear(layer_norm(p, x), p["w1"],
                                p["b1"])).chunk(2, dim=-1)
    h = F.layer_norm(h, h.shape[-1:], p["gate_ln_scale"], p["gate_ln_bias"],
                     LN_EPS)
    h = conv_ops.depthwise_conv1d_same(h, p["dw_w"], p["dw_b"], lens)
    return gemm_k.linear(r * h.transpose(1, 2), p["w2"], p["b2"])


def merge(p: Params, g, c, lens):
    """The branches g, c [B, L, d] merged: Linear 2d -> d of m + the
    depthwise conv of m, m = [g, c]."""
    m = torch.cat([g, c], dim=-1)
    h = conv_ops.depthwise_conv1d_same(m, p["dw_w"], p["dw_b"], lens)
    return gemm_k.linear(m + h.transpose(1, 2), p["w"], p["b"])


def block(p: Params, x, lens, heads: int, table):
    """One E-Branchformer block, x [B, L, d] -> [B, L, d] (module
    docstring); ``table``: the relative positions' sinusoids
    (``ops/self_attention.py`` ``rel_pos_table``)."""
    global blocks
    blocks += 1
    x = x + 0.5 * feed_forward(p["ffn1"], x)
    g = sa_ops.rel_pos_attention(p["mhsa"], layer_norm(p["mhsa"], x), lens,
                                 heads, table)
    x = x + merge(p["merge"], g, cgmlp(p["cgmlp"], x, lens), lens)
    x = x + 0.5 * feed_forward(p["ffn2"], x)
    return layer_norm(p, x)


def apply_e_branchformer(p: Params, cfg: Config, x, lens):
    """x [B, T, feat_dim] (padding zeroed), lens [B] -> (y [B, T2, d] zero
    past each row's length, T2 = ((T - 1) // 2 - 1) // 2, its lens)."""
    x, lens = conv_ops.conv2d_subsampling(p["subsample"], x, lens)
    x = x * math.sqrt(x.shape[-1])
    table = sa_ops.rel_pos_table(x.shape[1], x.shape[2], x.dtype, x.device)
    for blk in p["blocks"]:
        x = block(blk, x, lens, cfg.encoder.self_attn_heads, table)
    x = layer_norm(p["after_norm"], x)
    return x * length_mask(lens, x.shape[1], x.dtype)[..., None], lens
