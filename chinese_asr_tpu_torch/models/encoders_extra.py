"""Secondary encoder families (port of
``chinese_asr_tpu/models/encoders_extra.py``; reference encoder.py:85-586).

Every family honours the ``EncoderOut`` contract of the RNN path:

  CNN1D                  stride-conv stack (encoder.py:102-144)
  CNN1D_RNN              2-layer conv front + GRU stack (encoder.py:85-99)
  CNN1D_SELF_ATTENTION   conv front + transformer blocks (encoder.py:237-251)
  CNN2D                  2-D conv stack over (time, mel) (encoder.py:147-190)
  SELF_ATTENTION         transformer blocks (encoder.py:193-234; its
                         upstream forward reads a never-set ``self.layers``,
                         fixed as in JAX)
  SELF_LOCAL_ATTENTION   ws-windowed attention blocks (encoder.py:254-287)
  CRNN                   conv head + ConvLSTM body (encoder.py:290-371)
  DCNN                   conv head + ResConvLSTM middle + NIN tail
                         (encoder.py:374-408; its upstream forward returns
                         None, fixed as in JAX to return the features)

The 2-D families read the featurizer's channel-major [B, T, C*mel] as
[B, T, mel, C] and flatten back channel-major (feature index c*F + f), so
their weights convert 1:1 with the reference's.  Parameter trees carry the
JAX package's names and layouts.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config, EncoderConfig
from ..ops import conv as conv_ops
from ..ops import conv_lstm as cl_ops
from ..ops import rnn as rnn_ops
from ..ops import self_attention as sa_ops
from ..ops.masks import length_mask
from .encoder import EncoderOut

Params = Dict


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _conv_plan(ecfg: EncoderConfig) -> List[Tuple[int, int, int]]:
    """(out_c, ks, stride) per conv layer: the reference zips
    [oc]*layers with the stride list, so the shorter one wins
    (encoder.py:117-121)."""
    strides = ecfg.stride if isinstance(ecfg.stride, (tuple, list)) \
        else (ecfg.stride,) * ecfg.num_layers
    n = min(ecfg.num_layers, len(strides))
    return [(ecfg.hidden_size, ecfg.ks, int(strides[i])) for i in range(n)]


def _feat_channels(cfg: Config) -> int:
    a = cfg.audio
    return (3 if a.delta_delta else 1) * (3 if a.downsample else 1)


def _to_2d(cfg: Config, x):
    """[B, T, D] -> [B, T, mel, C] (the featurizer's layout is channel-major,
    ``audio/features.py`` stack3)."""
    B, T, D = x.shape
    C = _feat_channels(cfg)
    return x.reshape(B, T, C, D // C).transpose(2, 3)


def _flatten_2d(x):
    """[B, T, F, C] -> [B, T, C*F], channel-major (the reference's
    ``x.view(b, c*h, w)``, encoder.py:188, 332)."""
    B, T, Fq, C = x.shape
    return x.transpose(2, 3).reshape(B, T, C * Fq)


# --------------------------------------------------------------------------
# CNN1D (encoder.py:102-144)
# --------------------------------------------------------------------------
def init_cnn1d(gen: torch.Generator, cfg: Config, input_size: int, plan=None,
               norm=None, act=None) -> Params:
    ecfg = cfg.encoder
    plan = plan or _conv_plan(ecfg)
    norm = norm if norm is not None else ecfg.norm
    act = act if act is not None else ecfg.act
    layers, in_c = [], input_size
    for oc, ks, _ in plan:
        layers.append(conv_ops.init_conv1d(gen, in_c, oc, ks, norm))
        in_c = oc // 2 if act == "GLU" else oc
    return {"convs": layers}


def apply_cnn1d(p: Params, cfg: Config, x, lens, plan=None, norm=None,
                act=None, skip=None, train=False, updates=None):
    ecfg = cfg.encoder
    plan = plan or _conv_plan(ecfg)
    norm = norm if norm is not None else ecfg.norm
    act = act if act is not None else ecfg.act
    skip = skip if skip is not None else ecfg.residual
    for i, (_, ks, st) in enumerate(plan):
        x, lens = conv_ops.conv1d_block(
            p["convs"][i], x, lens, ks, st, act, norm,
            skip_connect=(skip and i > 0), train=train, updates=updates)
    return x, lens


def cnn1d_out_size(ecfg: EncoderConfig) -> int:
    oc = _conv_plan(ecfg)[-1][0]
    return oc // 2 if ecfg.act == "GLU" else oc


# front of CNN1D_RNN / CNN1D_SELF_ATTENTION (encoder.py:89, 243: oc=256,
# ks=3, stride=2, BN, RELU, no skip, 2 layers)
_FRONT_PLAN = [(256, 3, 2), (256, 3, 2)]


# --------------------------------------------------------------------------
# CNN2D (encoder.py:147-190)
# --------------------------------------------------------------------------
def init_cnn2d(gen: torch.Generator, cfg: Config) -> Params:
    ecfg = cfg.encoder
    layers, in_c = [], _feat_channels(cfg)
    for oc, ks, _ in _conv_plan(ecfg):
        layers.append(conv_ops.init_conv2d(gen, in_c, oc, ks, ecfg.norm))
        in_c = oc // 2 if ecfg.act == "GLU" else oc
    return {"convs": layers}


def apply_cnn2d(p: Params, cfg: Config, x, lens, train=False, updates=None):
    ecfg = cfg.encoder
    x = _to_2d(cfg, x)
    for i, (_, ks, st) in enumerate(_conv_plan(ecfg)):
        x, lens = conv_ops.conv2d_block(
            p["convs"][i], x, lens, ks, st, ecfg.act, ecfg.norm,
            skip_connect=(ecfg.residual and i > 0), train=train,
            updates=updates)
    return _flatten_2d(x), lens


def cnn2d_out_size(cfg: Config) -> int:
    f = cfg.audio.n_mels
    for (_, ks, st) in _conv_plan(cfg.encoder):
        # the freq axis is auto-padded like time (ops/conv.conv2d_block)
        pad = (st - (f - ks) % st) % st
        f = (f + pad - ks) // st + 1
    return cnn1d_out_size(cfg.encoder) * f


# --------------------------------------------------------------------------
# SELF_ATTENTION / SELF_LOCAL_ATTENTION (encoder.py:193-234, 254-287)
# --------------------------------------------------------------------------
def init_sa(gen: torch.Generator, cfg: Config, input_size: int,
            hidden: int = None, layers: int = None, proj: bool = None,
            ffn: int = None) -> Params:
    ecfg = cfg.encoder
    hidden = hidden or ecfg.hidden_size
    layers = layers or ecfg.num_layers
    proj = ecfg.mha_proj if proj is None else proj
    ffn = ffn or ecfg.ffn_size
    return {"blocks": [
        sa_ops.init_block(gen, input_size if i == 0 else hidden, hidden,
                          proj, ffn)
        for i in range(layers)]}


def apply_sa(p: Params, cfg: Config, x, lens, heads: int = None, ws=None,
             pos: bool = False):
    heads = heads or cfg.encoder.self_attn_heads
    if pos:
        x = x + sa_ops.sin_pos_embedding(x.shape[1], x.shape[2], x.dtype,
                                         x.device)
    for blk in p["blocks"]:
        x = sa_ops.attention_block(blk, x, lens, heads, ws)
    # the EncoderOut contract: padding rows exactly zero (the positions and
    # the LN biases would otherwise leak into them)
    return x * length_mask(lens, x.shape[1], x.dtype)[..., None], lens


# --------------------------------------------------------------------------
# CNN1D_RNN (encoder.py:85-99): conv front + GRU stack
# --------------------------------------------------------------------------
def init_cnn1d_rnn(gen: torch.Generator, cfg: Config) -> Params:
    ecfg = cfg.encoder
    return {
        "front": init_cnn1d(gen, cfg, cfg.audio.feat_dim, plan=_FRONT_PLAN,
                            norm="BN", act="RELU"),
        "rnn": rnn_ops.init_rnn_stack(gen, "GRU", 256, ecfg.hidden_size,
                                      ecfg.num_layers, ecfg.bidirectional),
    }


def apply_cnn1d_rnn(p: Params, cfg: Config, x, lens, train=False,
                    updates=None):
    ecfg = cfg.encoder
    x, lens = apply_cnn1d(p["front"], cfg, x, lens, plan=_FRONT_PLAN,
                          norm="BN", act="RELU", skip=False, train=train,
                          updates=updates)
    mask = length_mask(lens, x.shape[1], x.dtype)
    y, states, lens, _ = rnn_ops.rnn_stack("GRU", p["rnn"], x, lens, mask,
                                           residual=ecfg.residual)
    state = (torch.cat([states[0], states[1]], dim=-1) if ecfg.bidirectional
             else states[0])
    return y, lens, state


# --------------------------------------------------------------------------
# CNN1D_SELF_ATTENTION (encoder.py:237-251)
# --------------------------------------------------------------------------
def init_cnn1d_sa(gen: torch.Generator, cfg: Config) -> Params:
    return {
        "front": init_cnn1d(gen, cfg, cfg.audio.feat_dim, plan=_FRONT_PLAN,
                            norm="BN", act="RELU"),
        "sa": init_sa(gen, cfg, 256, hidden=256, layers=4, proj=True,
                      ffn=512),
    }


def apply_cnn1d_sa(p: Params, cfg: Config, x, lens, train=False,
                   updates=None):
    x, lens = apply_cnn1d(p["front"], cfg, x, lens, plan=_FRONT_PLAN,
                          norm="BN", act="RELU", skip=False, train=train,
                          updates=updates)
    return apply_sa(p["sa"], cfg, x, lens, heads=4, pos=True)


# --------------------------------------------------------------------------
# CRNN (encoder.py:290-371): 2 conv2d heads (time stride 2) + 3x ConvLSTM
# --------------------------------------------------------------------------
def _init_heads(gen: torch.Generator, cfg: Config) -> List[Params]:
    oc = cfg.encoder.conv_channels
    return [conv_ops.init_conv2d(gen, _feat_channels(cfg), oc, 3, "BN"),
            conv_ops.init_conv2d(gen, oc, oc, 3, "BN")]


def _apply_heads(heads: List[Params], x, lens, train, updates):
    for hp in heads:
        # time stride 2, freq stride 1, freq pad 1 (encoder.py:300-301, 325)
        x, lens = conv_ops.conv2d_block(hp, x, lens, 3, (2, 1), "NONE", "BN",
                                        train=train, freq_pad=1,
                                        updates=updates)
    return x, lens


def init_crnn(gen: torch.Generator, cfg: Config) -> Params:
    oc = cfg.encoder.conv_channels
    return {"heads": _init_heads(gen, cfg),
            "conv_lstm": [cl_ops.init_conv_lstm(gen, oc, oc, 3)
                          for _ in range(3)]}


def apply_crnn(p: Params, cfg: Config, x, lens, train=False, updates=None):
    x, lens = _apply_heads(p["heads"], _to_2d(cfg, x), lens, train, updates)
    for cp in p["conv_lstm"]:
        x, _ = cl_ops.conv_lstm(cp, x, lens)
    return _flatten_2d(x), lens


def crnn_out_size(cfg: Config) -> int:
    # the heads pad the freq axis by 1 each side for their 3-wide kernel
    # at freq stride 1, so it keeps n_mels
    return cfg.encoder.conv_channels * cfg.audio.n_mels


# --------------------------------------------------------------------------
# blocks: ResCNN / ResConvLSTM / NIN (encoder.py:411-586) + DCNN
# --------------------------------------------------------------------------
def init_res_cnn(gen: torch.Generator, in_c: int, out_c: int) -> Params:
    p = {"conv1": conv_ops.init_same_conv2d(gen, in_c, out_c, 3),
         "conv2": conv_ops.init_same_conv2d(gen, out_c, out_c, 3),
         "bn1": conv_ops.norm_params(out_c, "BN"),
         "bn2": conv_ops.norm_params(out_c, "BN")}
    if in_c != out_c:
        p["down"] = conv_ops.init_same_conv2d(gen, in_c, out_c, 1)
    return p


def res_cnn(p: Params, x, lens, train=False, updates=None):
    """conv -> BN -> relu -> conv -> BN -> +skip -> relu, width-masked
    (reference ResCNN, encoder.py:411-478)."""
    m = length_mask(lens, x.shape[1], x.dtype)[:, :, None, None]
    y = conv_ops.same_conv2d(p["conv1"], x) * m
    y = conv_ops.apply_norm(p["bn1"], y, "BN", train, spatial_axes=(1, 2),
                            updates=updates)
    y = torch.relu(y) * m
    y = conv_ops.same_conv2d(p["conv2"], y) * m
    y = conv_ops.apply_norm(p["bn2"], y, "BN", train, spatial_axes=(1, 2),
                            updates=updates)
    if "down" in p:
        x = conv_ops.same_conv2d(p["down"], x)
    return torch.relu(x + y) * m, lens


def init_res_conv_lstm(gen: torch.Generator, in_c: int, out_c: int,
                       ks: int = 3) -> Params:
    p = {"cl1": cl_ops.init_bconv_lstm(gen, in_c, out_c, ks),
         "cl2": cl_ops.init_bconv_lstm(gen, 2 * out_c, out_c, ks),
         "bn1": conv_ops.norm_params(2 * out_c, "BN"),
         "bn2": conv_ops.norm_params(2 * out_c, "BN")}
    if in_c != 2 * out_c:
        p["down"] = conv_ops.init_same_conv2d(gen, in_c, 2 * out_c, 1)
    return p


def res_conv_lstm(p: Params, x, lens, train=False, updates=None):
    """BConvLSTM -> BN -> relu -> BConvLSTM -> BN -> +skip -> relu
    (reference ResConvLSTM, encoder.py:481-541; its [b, 2, c', h, w]
    BConvLSTM output is the channel concat [B, T, F, 2c'] here)."""
    m = length_mask(lens, x.shape[1], x.dtype)[:, :, None, None]
    y, _ = cl_ops.bconv_lstm(p["cl1"], x, lens)
    y = conv_ops.apply_norm(p["bn1"], y, "BN", train, spatial_axes=(1, 2),
                            updates=updates)
    y = torch.relu(y) * m
    y, _ = cl_ops.bconv_lstm(p["cl2"], y, lens)
    y = conv_ops.apply_norm(p["bn2"], y, "BN", train, spatial_axes=(1, 2),
                            updates=updates)
    if "down" in p:
        x = conv_ops.same_conv2d(p["down"], x)
    return torch.relu(x + y) * m, lens


def init_nin(gen: torch.Generator, in_c: int, out_c: int,
             ks: int = 3) -> Params:
    """NIN tail (encoder.py:544-586; upstream's forward is mistyped and
    assigns self.conv1 twice, fixed as in JAX: two distinct 1x1 convs)."""
    return {
        "cl1": cl_ops.init_bconv_lstm(gen, in_c, out_c, ks),
        "conv1": conv_ops.init_conv2d(gen, 2 * out_c, out_c, 1, "BN"),
        "cl2": cl_ops.init_bconv_lstm(gen, out_c, out_c, ks),
        "conv2": conv_ops.init_conv2d(gen, 2 * out_c, out_c, 1, "BN"),
        "cl3": cl_ops.init_bconv_lstm(gen, out_c, out_c, ks),
    }


def nin(p: Params, x, lens, train=False, updates=None):
    """L -> C(1x1) -> BN -> relu -> L -> C(1x1) -> BN -> relu -> L."""
    x, _ = cl_ops.bconv_lstm(p["cl1"], x, lens)
    x, lens = conv_ops.conv2d_block(p["conv1"], x, lens, 1, 1, "RELU", "BN",
                                    train=train, updates=updates)
    x, _ = cl_ops.bconv_lstm(p["cl2"], x, lens)
    x, lens = conv_ops.conv2d_block(p["conv2"], x, lens, 1, 1, "RELU", "BN",
                                    train=train, updates=updates)
    x, _ = cl_ops.bconv_lstm(p["cl3"], x, lens)
    return x, lens


def init_dcnn(gen: torch.Generator, cfg: Config) -> Params:
    oc = cfg.encoder.conv_channels
    return {
        "heads": _init_heads(gen, cfg),
        "middle": [init_res_conv_lstm(gen, oc if i == 0 else 2 * oc, oc, 3)
                   for i in range(cfg.encoder.dcnn_middle)],
        "nin": init_nin(gen, 2 * oc, oc, 3),
    }


def apply_dcnn(p: Params, cfg: Config, x, lens, train=False, updates=None):
    """Very deep CNN encoder (encoder.py:374-408)."""
    x, lens = _apply_heads(p["heads"], _to_2d(cfg, x), lens, train, updates)
    for mp in p["middle"]:
        x, lens = res_conv_lstm(mp, x, lens, train, updates)
    x, lens = nin(p["nin"], x, lens, train, updates)
    return _flatten_2d(x), lens


def dcnn_out_size(cfg: Config) -> int:
    # the heads keep the freq axis (pad 1 each side, ks 3, stride 1)
    return 2 * cfg.encoder.conv_channels * cfg.audio.n_mels


# --------------------------------------------------------------------------
# registry (dispatched from models/encoder.py)
# --------------------------------------------------------------------------
def init_encoder(gen: torch.Generator, cfg: Config) -> Params:
    et = cfg.encoder.encoder_type
    D = cfg.audio.feat_dim
    if et == "CNN1D":
        return init_cnn1d(gen, cfg, D)
    if et == "CNN2D":
        return init_cnn2d(gen, cfg)
    if et == "CNN1D_RNN":
        return init_cnn1d_rnn(gen, cfg)
    if et == "CNN1D_SELF_ATTENTION":
        return init_cnn1d_sa(gen, cfg)
    if et in ("SELF_ATTENTION", "SELF_LOCAL_ATTENTION"):
        return init_sa(gen, cfg, D)
    if et == "CRNN":
        return init_crnn(gen, cfg)
    if et == "DCNN":
        return init_dcnn(gen, cfg)
    raise ValueError(f"unknown encoder_type {et}")


def apply_encoder(p: Params, cfg: Config, x, lens, train=False,
                  updates=None) -> EncoderOut:
    et = cfg.encoder.encoder_type
    state = None
    if et == "CNN1D":
        y, lens = apply_cnn1d(p, cfg, x, lens, train=train, updates=updates)
    elif et == "CNN2D":
        y, lens = apply_cnn2d(p, cfg, x, lens, train, updates)
    elif et == "CNN1D_RNN":
        y, lens, state = apply_cnn1d_rnn(p, cfg, x, lens, train, updates)
    elif et == "CNN1D_SELF_ATTENTION":
        y, lens = apply_cnn1d_sa(p, cfg, x, lens, train, updates)
    elif et == "SELF_ATTENTION":
        y, lens = apply_sa(p, cfg, x, lens)
    elif et == "SELF_LOCAL_ATTENTION":
        y, lens = apply_sa(p, cfg, x, lens, ws=cfg.encoder.ws)
    elif et == "CRNN":
        y, lens = apply_crnn(p, cfg, x, lens, train, updates)
    elif et == "DCNN":
        y, lens = apply_dcnn(p, cfg, x, lens, train, updates)
    else:
        raise ValueError(f"unknown encoder_type {et}")
    return EncoderOut(y, lens, state)


# --------------------------------------------------------------------------
# reference state-dict import (reference save format model.py:347-355;
# tensor names per each class' submodule tree): numpy leaves in the JAX
# package's layouts, which ``las.params_from_torch_state`` hands to
# ``params_from_numpy``
# --------------------------------------------------------------------------
def _a(sd, key):
    return np.asarray(sd[key])


def _norm_from_sd(p: Params, sd, pre: str) -> None:
    if pre + "norm.weight" in sd:
        p["norm_scale"] = _a(sd, pre + "norm.weight")
        p["norm_bias"] = _a(sd, pre + "norm.bias")
    if pre + "norm.running_mean" in sd:
        p["bn_mean"] = _a(sd, pre + "norm.running_mean")
        p["bn_var"] = _a(sd, pre + "norm.running_var")


def _conv_from_sd(sd, pre: str, axes) -> Params:
    """nn.Conv1d [out, in, ks] -> [ks, in, out] (axes (2, 1, 0)); nn.Conv2d
    [out, in, kf, kt] (its h = freq, w = time) -> [kt, kf, in, out] (axes
    (3, 2, 1, 0)).  The conv bias exists only without a norm
    (util.py:1477-1480); zeros stand in for it otherwise."""
    w = _a(sd, pre + "conv.weight")
    p = {"w": w.transpose(*axes),
         "b": (_a(sd, pre + "conv.bias") if pre + "conv.bias" in sd
               else np.zeros((w.shape[0],), w.dtype))}
    _norm_from_sd(p, sd, pre)
    return p


def _conv1d_from_sd(sd, pre: str) -> Params:
    """Reference ``Conv1D`` (util.py:1327-1427)."""
    return _conv_from_sd(sd, pre, (2, 1, 0))


def _conv2d_from_sd(sd, pre: str) -> Params:
    """Reference ``Conv2D`` (util.py:1467-1573)."""
    return _conv_from_sd(sd, pre, (3, 2, 1, 0))


def rnn_stack_from_sd(sd, pre: str, num_layers: int,
                      bidirectional: bool) -> List[Params]:
    """Reference ``RNN_RES``, a ModuleList of 1-layer nn.LSTM/GRU/RNN
    (util.py:1155-1161): weight_ih_l0 [nH, in] -> [in, nH]."""
    layers = []
    for i in range(num_layers):
        base = f"{pre}{i}."

        def direction(sfx):
            return {"w_ih": _a(sd, base + "weight_ih_l0" + sfx).T,
                    "w_hh": _a(sd, base + "weight_hh_l0" + sfx).T,
                    "b_ih": _a(sd, base + "bias_ih_l0" + sfx),
                    "b_hh": _a(sd, base + "bias_hh_l0" + sfx)}

        layer = {"fwd": direction("")}
        if bidirectional:
            layer["bwd"] = direction("_reverse")
        layers.append(layer)
    return layers


def _sa_blocks_from_sd(sd, pre: str, layers: int) -> Params:
    """Reference ``SelfAttentionBlock`` / ``SelfLocalAttentionBlock``
    (util.py:1777-1864): the attention submodule is ``mha`` in the full
    block and ``sla`` in the windowed one."""
    blocks = []
    for i in range(layers):
        b = f"{pre}{i}."
        attn = b + ("mha." if b + "mha.weight" in sd else "sla.")
        ffn_bias = _a(sd, b + "ffn.bias")
        F_ = _a(sd, b + "ffn.weight_1").shape[0]
        blk = {
            "attn": {"w_qkv": _a(sd, attn + "weight").T,
                     "b_qkv": _a(sd, attn + "bias")},
            "ffn": {"w1": _a(sd, b + "ffn.weight_1").T,
                    "b1": ffn_bias[:F_],
                    "w2": _a(sd, b + "ffn.weight_2").T,
                    "b2": ffn_bias[F_:]},
            "ln1_scale": _a(sd, b + "ln_1.weight"),
            "ln1_bias": _a(sd, b + "ln_1.bias"),
            "ln2_scale": _a(sd, b + "ln_2.weight"),
            "ln2_bias": _a(sd, b + "ln_2.bias"),
        }
        if attn + "proj_weight" in sd:
            blk["attn"]["w_proj"] = _a(sd, attn + "proj_weight").T
        blocks.append(blk)
    return {"blocks": blocks}


def _conv_lstm_from_sd(sd, pre: str) -> Params:
    """Reference ``ConvLSTM`` (util.py:886-983): two biased gate convs,
    whose biases sum into the one fused bias; gate order (i, f, g, o)."""
    return {"w_x": _a(sd, pre + "conv_x.weight").transpose(2, 1, 0),
            "w_h": _a(sd, pre + "conv_h.weight").transpose(2, 1, 0),
            "b": _a(sd, pre + "conv_x.bias") + _a(sd, pre + "conv_h.bias")}


def encoder_from_torch_state(enc_sd: Dict[str, np.ndarray],
                             cfg: Config) -> Params:
    """The encoder tree (numpy leaves) from a reference encoder state dict
    of a secondary family (the RNN family is read in ``las``).  DCNN has
    no converter, as in JAX."""
    et = cfg.encoder.encoder_type
    ecfg = cfg.encoder

    def front():
        return {"convs": [_conv1d_from_sd(enc_sd, f"cnn1d.convs.{i}.")
                          for i in range(len(_FRONT_PLAN))]}

    if et in ("CNN1D", "CNN2D"):
        read = _conv1d_from_sd if et == "CNN1D" else _conv2d_from_sd
        return {"convs": [read(enc_sd, f"convs.{i}.")
                          for i in range(len(_conv_plan(ecfg)))]}
    if et == "CNN1D_RNN":
        # CNN1DRNNEncoder.rnn is a full RNNEncoder around RNN_RES
        # (encoder.py:91), hence the triple prefix
        return {"front": front(),
                "rnn": rnn_stack_from_sd(enc_sd, "rnn.rnn.rnn.",
                                         ecfg.num_layers, ecfg.bidirectional)}
    if et == "CNN1D_SELF_ATTENTION":
        # fixed geometry (encoder.py:239-243: hidden 256, 4 layers)
        return {"front": front(),
                "sa": _sa_blocks_from_sd(enc_sd, "sa.blocks.", 4)}
    if et in ("SELF_ATTENTION", "SELF_LOCAL_ATTENTION"):
        return _sa_blocks_from_sd(enc_sd, "blocks.", ecfg.num_layers)
    if et == "CRNN":
        # the reference CRNNEncoder also holds an RNN_RES its forward never
        # uses (encoder.py:305-307 vs 321-333): skipped
        return {"heads": [_conv2d_from_sd(enc_sd, f"heads.{i}.")
                          for i in range(2)],
                "conv_lstm": [_conv_lstm_from_sd(enc_sd, f"conv_lstm.{i}.")
                              for i in range(3)]}
    raise ValueError(f"no torch converter for encoder_type {et}")


def encoder_output_size(cfg: Config) -> int:
    et = cfg.encoder.encoder_type
    if et == "CNN1D":
        return cnn1d_out_size(cfg.encoder)
    if et == "CNN2D":
        return cnn2d_out_size(cfg)
    if et == "CNN1D_RNN":
        return cfg.encoder.hidden_size * cfg.encoder.num_directions
    if et == "CNN1D_SELF_ATTENTION":
        return 256
    if et in ("SELF_ATTENTION", "SELF_LOCAL_ATTENTION"):
        return cfg.encoder.hidden_size
    if et == "CRNN":
        return crnn_out_size(cfg)
    if et == "DCNN":
        return dcnn_out_size(cfg)
    raise ValueError(f"unknown encoder_type {et}")
