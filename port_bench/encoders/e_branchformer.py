"""The E_BRANCHFORMER family: E-Branchformer (L) (Kim et al.,
"E-Branchformer: Branchformer with Enhanced merging for speech
recognition", arXiv:2210.00077, section 3 and Figure 1; widths of
ESPnet's LibriSpeech recipe ``train_asr_e_branchformer.yaml``) over
ESPnet's ``Conv2dSubsampling``, under the flagship's decoder.

Subsampling: the Conformer family's (``encoders/conformer.py``: two
valid 3x3 stride-2 convolutions with ReLU, a linear map to d; each row
over its own frames alone), its output scaled by sqrt(d) (ESPnet's
``RelPositionalEncoding``).  Then ``num_layers`` blocks of

  x = x + 1/2 FFN1(x)         LN, Linear d -> ffn, Swish, Linear ffn -> d
  g = MHSA(LN(x))             the Conformer family's relative-position
                              attention, ``self_attn_heads`` heads
  c = cgMLP(x)                LN, Linear d -> C (``cgmlp_size``), GELU
                              (erf); r, h = the first and second C / 2
                              channels; h through a LayerNorm of its own
                              and a depthwise conv1d of ``ks`` taps;
                              Linear C / 2 -> d of r * h
  m = [g, c]                  2d channels
  x = x + Linear 2d -> d (m + DWConv(m))   ``merge_ks`` taps
  x = x + 1/2 FFN2(x)
  x = LN(x)

then a final LN (ESPnet's ``after_norm``), the output zeroed past each
row's length.  Each depthwise conv zeroes the frames at or past the
row's length at its input and is padded (k - 1) // 2 frames before and
k // 2 after (15 and 15 at 31 taps).  LN eps 1e-5; no dropout, no layer
drop.  The encoder has no recurrent state: the decoder starts from
zeros.

Here the convolutions are products of unfolded windows: every product
goes through ``prec.mm``; the merge keeps the published concatenation.
Its tensors are the program's
(``chinese_asr_tpu_torch/models/e_branchformer.py``): xavier-normal
matrices (a convolution's fans times its taps; a depthwise filter's fans
are its taps), LayerNorm gains ones, and every bias, ``pos_u`` and
``pos_v`` drawn N(0, 0.1^2), so that a dropped term shows.
"""

from __future__ import annotations

import math
import sys

import torch

from port_bench.encoders import conformer as conf
from port_bench.reference.las import initial_state

BIAS_STD = conf.BIAS_STD
EPS = conf.EPS


def enc_size(cfg: dict) -> int:
    return cfg["encoder"]["hidden_size"]


def layout(cfg: dict):
    enc = cfg["encoder"]
    d, f, H = enc["hidden_size"], enc["ffn_size"], enc["self_attn_heads"]
    C, k, mk = enc["cgmlp_size"], enc["ks"], enc["merge_ks"]
    half = C // 2
    xav = conf._xavier
    F2 = conf._sub_width(cfg["audio"])
    pre = ("encoder", "subsample")
    out = [(pre + ("conv1", "w"), (3, 3, 1, d), xav(9, 9 * d)),
           (pre + ("conv1", "b"), (d,), BIAS_STD),
           (pre + ("conv2", "w"), (3, 3, d, d), xav(9 * d, 9 * d)),
           (pre + ("conv2", "b"), (d,), BIAS_STD),
           (pre + ("out", "w"), (d * F2, d), xav(d * F2, d)),
           (pre + ("out", "b"), (d,), BIAS_STD)]

    def ln(p, width=d, name="ln"):
        return [(p + (name + "_scale",), (width,), "ones"),
                (p + (name + "_bias",), (width,), BIAS_STD)]

    def lin(p, w, b, d_in, d_out):
        return [(p + (w,), (d_in, d_out), xav(d_in, d_out)),
                (p + (b,), (d_out,), BIAS_STD)]

    def ffn(p):
        return ln(p) + lin(p, "w1", "b1", d, f) + lin(p, "w2", "b2", f, d)

    def dw(p, taps, width):
        return [(p + ("dw_w",), (taps, width), xav(taps, taps)),
                (p + ("dw_b",), (width,), BIAS_STD)]

    for i in range(enc["num_layers"]):
        blk = ("encoder", "blocks", i)
        m, c, g = blk + ("mhsa",), blk + ("cgmlp",), blk + ("merge",)
        out += ffn(blk + ("ffn1",))
        out += ln(m) + lin(m, "w_qkv", "b_qkv", d, 3 * d)
        out += [(m + ("w_pos",), (d, d), xav(d, d)),
                (m + ("pos_u",), (H, d // H), BIAS_STD),
                (m + ("pos_v",), (H, d // H), BIAS_STD)]
        out += lin(m, "w_o", "b_o", d, d)
        out += ln(c) + lin(c, "w1", "b1", d, C)
        out += ln(c, half, "gate_ln") + dw(c, k, half)
        out += lin(c, "w2", "b2", half, d)
        out += dw(g, mk, 2 * d) + lin(g, "w", "b", 2 * d, d)
        out += ffn(blk + ("ffn2",))
        out += ln(blk)
    out += ln(("encoder", "after_norm"))
    return out


def frames(feature_frames: int, cfg: dict) -> int:
    return conf._sub_frames(feature_frames)


def tiny(enc: dict) -> dict:
    return dict(enc, hidden_size=32, num_layers=2, self_attn_heads=4,
                ffn_size=64, cgmlp_size=96, ks=7, merge_ks=5)


def flops(cfg: dict, frames: int) -> float:
    """The subsampling's products (as the Conformer family counts them)
    and each block's over its L output frames: two FFNs (2 x 4 L d f),
    the QKV (6 L d d), positions over its 2 L - 1 distances (2 (2L - 1) d
    d), content and position scores and the context over the row's own
    L x L (3 x 2 L L d), W_o (2 L d d), the cgMLP's products (2 L d C + 2
    L C/2 d) and depthwise conv (2 L C/2 ks), the merge's depthwise conv
    (2 L 2d merge_ks) and product (2 L 2d d)."""
    enc = cfg["encoder"]
    d, f = enc["hidden_size"], enc["ffn_size"]
    C, k, mk = enc["cgmlp_size"], enc["ks"], enc["merge_ks"]
    L = conf._sub_frames(frames)
    if L == 0:
        return 0.0
    # the Conformer family's count with no blocks: its subsampling's
    sub = conf.flops(dict(cfg, encoder=dict(enc, num_layers=0)), frames)
    block = (8 * L * d * f + 6 * L * d * d + 2 * (2 * L - 1) * d * d
             + 6 * L * L * d + 2 * L * d * d
             + 2 * L * d * C + L * C * d + L * C * k
             + 4 * L * d * mk + 4 * L * d * d)
    return float(sub + enc["num_layers"] * block)


# --------------------------------------------------------------------------
# the plain reference
# --------------------------------------------------------------------------
def _norm(x, scale, bias):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * scale + bias


def _gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def depthwise(prec, x, w, b, lens):
    """x [B, L, C], w [K, C], b [C] -> [B, L, C]: frames at or past a row's
    length zeroed, (K - 1) // 2 zero frames before and K // 2 after, each
    channel's K taps over its unfolded windows."""
    B, L, C = x.shape
    K = w.shape[0]
    x = x * conf._live(lens, L, x.device)[..., None]
    x = torch.nn.functional.pad(x, (0, 0, (K - 1) // 2, K // 2))
    win = x.unfold(1, K, 1).permute(2, 0, 1, 3).reshape(C, B * L, K)
    y = prec.mm(win, w.t()[:, :, None])                     # [C, B L, 1]
    return y.reshape(C, B, L).permute(1, 2, 0) + b


def cgmlp(prec, p, x, lens):
    h = _gelu(prec.mm(conf._ln(p, x), p["w1"]) + p["b1"])
    half = h.shape[-1] // 2
    r = h[..., :half]
    g = _norm(h[..., half:], p["gate_ln_scale"], p["gate_ln_bias"])
    g = depthwise(prec, g, p["dw_w"], p["dw_b"], lens)
    return prec.mm(r * g, p["w2"]) + p["b2"]


def merge(prec, p, g, c, lens):
    m = torch.cat([g, c], dim=-1)
    m = m + depthwise(prec, m, p["dw_w"], p["dw_b"], lens)
    return prec.mm(m, p["w"]) + p["b"]


def block(prec, p, x, lens, heads: int):
    x = x + 0.5 * conf._ffn(prec, p["ffn1"], x)
    g = conf._mhsa(prec, p["mhsa"], conf._ln(p["mhsa"], x), lens, heads)
    c = cgmlp(prec, p["cgmlp"], x, lens)
    x = x + merge(prec, p["merge"], g, c, lens)
    x = x + 0.5 * conf._ffn(prec, p["ffn2"], x)
    return conf._ln(p, x)


def encode(prec, params, x, lens, cfg):
    p = params["encoder"]
    x, lens = conf.subsample(prec, p["subsample"], x, lens)
    x = x * math.sqrt(x.shape[-1])
    for blk in p["blocks"]:
        x = block(prec, blk, x, lens, cfg["encoder"]["self_attn_heads"])
    x = conf._ln(p["after_norm"], x)
    x = x * conf._live(lens, x.shape[1], x.device)[..., None]
    return x, lens, initial_state(params, x)


def __getattr__(name: str):
    """``blocks``: the program's count of the E-Branchformer blocks it
    applied (``chinese_asr_tpu_torch/models/e_branchformer.py``,
    launch-style), 0 where the program has no such counter.
    ``kernels/e_branchformer.json`` names it as the counter of the one
    GELU a block launches, so that a traced window counts it as
    ``e_branchformer.blocks``."""
    if name == "blocks":
        prog = sys.modules.get("chinese_asr_tpu_torch.models.e_branchformer")
        return getattr(prog, "blocks", 0)
    raise AttributeError(name)
