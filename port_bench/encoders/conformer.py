"""The CONFORMER family: Conformer (L) (Gulati et al., "Conformer:
Convolution-augmented Transformer for Speech Recognition",
arXiv:2005.08100, section 2, Figure 1 and Table 1) over ESPnet's
``Conv2dSubsampling``, under the flagship's decoder.

Subsampling: Conv2d(1 -> d, 3x3, stride 2), ReLU, Conv2d(d -> d, 3x3,
stride 2), ReLU over (frames, mels), valid, then [d, F2] flattened
channel-major (feature c F2 + f) and a linear map to d: a row of n
frames gives ((n - 1) // 2 - 1) // 2.  Each row is subsampled here over
its own frames alone.  Then ``num_layers`` blocks of

  x1 = x + 1/2 FFN(x)        LN, Linear d -> ffn, Swish, Linear ffn -> d
  x2 = x1 + MHSA(LN(x1))     ``self_attn_heads`` heads; for head h,
                             query i, key j: ((q_i + u_h) . k_j + (q_i +
                             v_h) . (R_{i-j} W_pos)_h) / sqrt(d_k), R the
                             sinusoid of the distance i - j (sin at even
                             features, cos at odd, angle d / 10000 **
                             (2 (k // 2) / d)), W_pos without bias; keys
                             at or past the row's length masked (a row of
                             no frames keeps its first); heads
                             concatenated through W_o
  x3 = x2 + Conv(x2)         LN, pointwise d -> 2d, GLU, frames past the
                             row's length zeroed, depthwise conv1d of
                             ``ks`` taps padded as torch's "same" ((ks -
                             1) // 2 before, ks // 2 after), BatchNorm
                             (eps 1e-5; running statistics, or with
                             ``train`` the batch's, padded frames
                             included), Swish, pointwise d -> d
  y  = LN(x3 + 1/2 FFN(x3))  (LN eps 1e-5)

and the output zeroed past each row's length.  No dropout; the input is
not scaled by sqrt(d).  The encoder has no recurrent state: the decoder
starts from zeros.

Here the positional term indexes R_{i-j} W_pos directly for every (i,
j), and the convolutions are products of unfolded windows: every
product goes through ``prec.mm``.  Its tensors are the program's
(``chinese_asr_tpu_torch/models/conformer.py``): xavier-normal matrices
(a convolution's fans times its taps; a depthwise filter's fans are its
taps), LayerNorm gains, BatchNorm scales and running variances ones,
and every bias, ``pos_u``, ``pos_v`` and running mean drawn N(0, 0.1^2),
so that a term dropped or a BatchNorm skipped shows.
"""

from __future__ import annotations

import math
import sys

import torch

from port_bench.reference.las import initial_state
from port_bench.roofline import shapes

EPS = 1e-5
BIAS_STD = 0.1


def enc_size(cfg: dict) -> int:
    return cfg["encoder"]["hidden_size"]


def _xavier(fan_in: int, fan_out: int) -> float:
    return math.sqrt(2.0 / (fan_in + fan_out))


def _sub_width(audio: dict) -> int:
    """F2: the subsampling's features a channel."""
    return ((shapes.feature_width(audio) - 1) // 2 - 1) // 2


def layout(cfg: dict):
    enc = cfg["encoder"]
    d, f, k, H = (enc["hidden_size"], enc["ffn_size"], enc["ks"],
                  enc["self_attn_heads"])
    F2 = _sub_width(cfg["audio"])
    out = []
    pre = ("encoder", "subsample")
    out += [(pre + ("conv1", "w"), (3, 3, 1, d), _xavier(9, 9 * d)),
            (pre + ("conv1", "b"), (d,), BIAS_STD),
            (pre + ("conv2", "w"), (3, 3, d, d), _xavier(9 * d, 9 * d)),
            (pre + ("conv2", "b"), (d,), BIAS_STD),
            (pre + ("out", "w"), (d * F2, d), _xavier(d * F2, d)),
            (pre + ("out", "b"), (d,), BIAS_STD)]

    def ln(p):
        return [(p + ("ln_scale",), (d,), "ones"),
                (p + ("ln_bias",), (d,), BIAS_STD)]

    def lin(p, w, b, d_in, d_out):
        return [(p + (w,), (d_in, d_out), _xavier(d_in, d_out)),
                (p + (b,), (d_out,), BIAS_STD)]

    def ffn(p):
        return ln(p) + lin(p, "w1", "b1", d, f) + lin(p, "w2", "b2", f, d)

    for i in range(enc["num_layers"]):
        blk = ("encoder", "blocks", i)
        m, c = blk + ("mhsa",), blk + ("conv",)
        out += ffn(blk + ("ffn1",))
        out += ln(m) + lin(m, "w_qkv", "b_qkv", d, 3 * d)
        out += [(m + ("w_pos",), (d, d), _xavier(d, d)),
                (m + ("pos_u",), (H, d // H), BIAS_STD),
                (m + ("pos_v",), (H, d // H), BIAS_STD)]
        out += lin(m, "w_o", "b_o", d, d)
        out += ln(c) + lin(c, "pw1_w", "pw1_b", d, 2 * d)
        out += [(c + ("dw_w",), (k, d), _xavier(k, k)),
                (c + ("dw_b",), (d,), BIAS_STD),
                (c + ("norm_scale",), (d,), "ones"),
                (c + ("norm_bias",), (d,), BIAS_STD),
                (c + ("bn_mean",), (d,), BIAS_STD),
                (c + ("bn_var",), (d,), "ones")]
        out += lin(c, "pw2_w", "pw2_b", d, d)
        out += ffn(blk + ("ffn2",))
        out += ln(blk)
    return out


def _sub_frames(n):
    """Frames out of the two valid stride-2 convolutions."""
    return max(0, ((n - 1) // 2 - 1) // 2)


def frames(feature_frames: int, cfg: dict) -> int:
    return _sub_frames(feature_frames)


def tiny(enc: dict) -> dict:
    return dict(enc, hidden_size=32, num_layers=2, self_attn_heads=4,
                ffn_size=64, ks=8)


def flops(cfg: dict, frames: int) -> float:
    """The subsampling's products over the row's frames (2 T1 F1 9 d, 2 T2
    F2 9 d d, 2 L F2 d d) and each block's over its L output frames: two
    FFNs (2 x 4 L d f), the QKV (6 L d d), positions over its 2 L - 1
    distances (2 (2L - 1) d d), content and position scores and the
    context over the row's own L x L (3 x 2 L L d), W_o (2 L d d), the
    pointwise convolutions (4 L d d + 2 L d d) and the depthwise one (2
    L d ks)."""
    enc = cfg["encoder"]
    d, f, k = enc["hidden_size"], enc["ffn_size"], enc["ks"]
    F0 = shapes.feature_width(cfg["audio"])
    T1, F1 = (frames - 1) // 2, (F0 - 1) // 2
    L, F2 = _sub_frames(frames), (F1 - 1) // 2
    if L == 0:
        return 0.0
    sub = 2 * T1 * F1 * 9 * d + 2 * L * F2 * 9 * d * d + 2 * L * F2 * d * d
    block = (8 * L * d * f + 6 * L * d * d + 2 * (2 * L - 1) * d * d
             + 6 * L * L * d + 2 * L * d * d + 6 * L * d * d + 2 * L * d * k)
    return float(sub + enc["num_layers"] * block)


# --------------------------------------------------------------------------
# the plain reference
# --------------------------------------------------------------------------
def _live(lens, L, device):
    return torch.arange(L, device=device)[None, :] < lens[:, None]


def _conv2d_s2(prec, x, p):
    """x [T, F, C_in] -> [T', F', C_out], a valid 3x3 stride-2
    convolution as a product of unfolded windows."""
    win = x.unfold(0, 3, 2).unfold(1, 3, 2)           # [T', F', C, 3, 3]
    T, Fq, C = win.shape[:3]
    win = win.permute(0, 1, 3, 4, 2).reshape(T * Fq, 9 * C)
    y = prec.mm(win, p["w"].reshape(9 * C, -1)) + p["b"]
    return y.reshape(T, Fq, -1)


def subsample(prec, p, x, lens):
    """x [B, T, F] -> (y [B, T2, d] zero past each length, lens out); each
    row over its own frames."""
    B, T, _ = x.shape
    L = _sub_frames(T)
    d = p["out"]["w"].shape[1]
    y = x.new_zeros((B, L, d))
    out_lens = []
    for b in range(B):
        n = int(lens[b])
        m = _sub_frames(n)
        out_lens.append(m)
        if m == 0:
            continue
        h = torch.relu(_conv2d_s2(prec, x[b, :n, :, None], p["conv1"]))
        h = torch.relu(_conv2d_s2(prec, h, p["conv2"]))      # [m, F2, d]
        h = h.permute(0, 2, 1).reshape(m, -1)                # c F2 + f
        y[b, :m] = prec.mm(h, p["out"]["w"]) + p["out"]["b"]
    return y, torch.tensor(out_lens, device=x.device)


def _ln(p, x):
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * p["ln_scale"] + p["ln_bias"]


def _swish(x):
    return x * torch.sigmoid(x)


def _ffn(prec, p, x):
    h = _swish(prec.mm(_ln(p, x), p["w1"]) + p["b1"])
    return prec.mm(h, p["w2"]) + p["b2"]


def rel_pos(L: int, D: int, device):
    """R_{i-j} [L, L, D] for every query i and key j, in float64."""
    i = torch.arange(L, device=device, dtype=torch.float64)
    dist = i[:, None] - i[None, :]
    k = torch.arange(D, device=device)
    angle = dist[..., None] / torch.pow(10000.0, (2 * (k // 2)).double() / D)
    return torch.where(k % 2 == 0, torch.sin(angle), torch.cos(angle))


def position_term(prec, p, q):
    """q [B, L, H, dk] -> [B, H, L, L]: (q_i + v_h) . (R_{i-j} W_pos)_h."""
    B, L, H, dk = q.shape
    R = rel_pos(L, H * dk, q.device).to(q.dtype)
    P = prec.mm(R, p["w_pos"]).reshape(L, L, H, dk)          # [i, j, h, :]
    qv = (q + p["pos_v"]).permute(2, 1, 0, 3)                # [h, i, b, :]
    out = prec.mm(qv, P.permute(2, 0, 3, 1))                 # [h, i, b, j]
    return out.permute(2, 0, 1, 3)


def _mhsa(prec, p, x, lens, heads):
    B, L, D = x.shape
    dk = D // heads
    q, k, v = (prec.mm(x, p["w_qkv"]) + p["b_qkv"]).reshape(
        B, L, 3, heads, dk).unbind(2)
    content = prec.mm((q + p["pos_u"]).transpose(1, 2),
                      k.permute(0, 2, 3, 1))                 # [b, h, i, j]
    scores = (content + position_term(prec, p, q)) / math.sqrt(dk)
    keys = _live(lens.clamp(min=1), L, x.device)[:, None, None, :]
    scores = scores.masked_fill(~keys, float("-inf"))
    ctx = prec.mm(torch.softmax(scores, -1), v.transpose(1, 2))
    return prec.mm(ctx.transpose(1, 2).reshape(B, L, D), p["w_o"]) + p["b_o"]


def _conv(prec, p, x, lens, train: bool):
    B, L, D = x.shape
    h = prec.mm(_ln(p, x), p["pw1_w"]) + p["pw1_b"]
    h = h[..., :D] * torch.sigmoid(h[..., D:])
    h = h * _live(lens, L, x.device)[..., None]
    K = p["dw_w"].shape[0]
    h = torch.nn.functional.pad(h, (0, 0, (K - 1) // 2, K // 2))
    win = h.unfold(1, K, 1)                                  # [B, L, D, K]
    win = win.permute(2, 0, 1, 3).reshape(D, B * L, K)
    y = prec.mm(win, p["dw_w"].t()[:, :, None])              # [D, B L, 1]
    y = y.reshape(D, B, L).permute(1, 2, 0) + p["dw_b"]
    if train:
        mean = y.mean((0, 1))
        var = y.var((0, 1), unbiased=False)
    else:
        mean, var = p["bn_mean"], p["bn_var"]
    y = (y - mean) / torch.sqrt(var + EPS) * p["norm_scale"] + p["norm_bias"]
    return prec.mm(_swish(y), p["pw2_w"]) + p["pw2_b"]


def block(prec, p, x, lens, heads: int, train: bool = False):
    x = x + 0.5 * _ffn(prec, p["ffn1"], x)
    x = x + _mhsa(prec, p["mhsa"], _ln(p["mhsa"], x), lens, heads)
    x = x + _conv(prec, p["conv"], x, lens, train)
    x = x + 0.5 * _ffn(prec, p["ffn2"], x)
    return _ln(p, x)


def encode(prec, params, x, lens, cfg, train: bool = False):
    """``train``: BatchNorm on the batch's statistics, as a train step
    runs it."""
    p = params["encoder"]
    x, lens = subsample(prec, p["subsample"], x, lens)
    for blk in p["blocks"]:
        x = block(prec, blk, x, lens, cfg["encoder"]["self_attn_heads"],
                  train)
    x = x * _live(lens, x.shape[1], x.device)[..., None]
    return x, lens, initial_state(params, x)


def __getattr__(name: str):
    """``blocks``: the program's count of the Conformer blocks it applied
    (``chinese_asr_tpu_torch/models/conformer.py``, launch-style), 0
    where the program has no such counter.  ``kernels/conformer.json``
    names it as the counter of the one GLU a block launches, so that a
    traced window counts it as ``conformer.blocks``."""
    if name == "blocks":
        prog = sys.modules.get("chinese_asr_tpu_torch.models.conformer")
        return getattr(prog, "blocks", 0)
    raise AttributeError(name)
