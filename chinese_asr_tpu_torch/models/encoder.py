"""Encoder registry (port of ``chinese_asr_tpu/models/encoder.py``).

The RNN family (LSTM, GRU, RNN_TANH, RNN_RELU; reference ``RNNEncoder``,
encoder.py:9-83) is the residual stack of ``ops/rnn.py``: the flagship
4-layer bidirectional LSTM runs its recurrence through kernel K2, the
other modes and unidirectional stacks through plain time loops.  The
conv / self-attention families live in ``encoders_extra.py``, the
Conformer in ``conformer.py``, the E-Branchformer in
``e_branchformer.py``; all share the ``EncoderOut`` contract.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ..config import Config, EncoderConfig
from ..ops import rnn as rnn_ops
from ..ops.masks import length_mask

Params = Dict

_RNN_FAMILY = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")


class EncoderOut(NamedTuple):
    out: torch.Tensor               # [B, L, enc_size]
    out_lens: torch.Tensor          # [B]
    # (h, c) each [B, enc_size] for LSTM; h for GRU/RNN; None for the
    # families without a recurrent final state
    state: Optional[Union[Tuple, torch.Tensor]]


def init_rnn_encoder(gen: torch.Generator, ecfg: EncoderConfig,
                     input_size: int) -> Params:
    return {"layers": rnn_ops.init_rnn_stack(
        gen, ecfg.encoder_type, input_size, ecfg.hidden_size,
        ecfg.num_layers, ecfg.bidirectional)}


def rnn_encoder(p: Params, ecfg: EncoderConfig, x, lens) -> EncoderOut:
    """x [B, T, D] zero-padded, lens [B] -> EncoderOut.  Final state: the
    last layer's, directions concatenated to [B, dirs*H] (reference
    encoder.py:67-77); with skip_step the lens are the subsampled ones."""
    mask = length_mask(lens, x.shape[1], x.dtype)
    y, states, out_lens, _ = rnn_ops.rnn_stack(
        ecfg.encoder_type, p["layers"], x, lens, mask,
        residual=ecfg.residual, skip_step=ecfg.skip_step)
    if not ecfg.bidirectional:
        state = states[0]
    elif ecfg.encoder_type == "LSTM":
        (h_f, c_f), (h_b, c_b) = states
        state = (torch.cat([h_f, h_b], dim=-1), torch.cat([c_f, c_b], dim=-1))
    else:
        state = torch.cat([states[0], states[1]], dim=-1)
    return EncoderOut(y, out_lens, state)


def init_encoder(gen: torch.Generator, cfg: Config) -> Params:
    if cfg.encoder.encoder_type in _RNN_FAMILY:
        return init_rnn_encoder(gen, cfg.encoder, cfg.audio.feat_dim)
    if cfg.encoder.encoder_type == "CONFORMER":
        from . import conformer
        return conformer.init_conformer(gen, cfg)
    if cfg.encoder.encoder_type == "E_BRANCHFORMER":
        from . import e_branchformer
        return e_branchformer.init_e_branchformer(gen, cfg)
    from . import encoders_extra
    return encoders_extra.init_encoder(gen, cfg)


def apply_encoder(p: Params, cfg: Config, x, lens, train: bool = False,
                  bn_updates=None) -> EncoderOut:
    """``train`` / ``bn_updates`` matter only to the BatchNorm families:
    ``train`` normalizes with batch statistics and records the running-stat
    updates into the ``bn_updates`` list (``ops/conv.py`` apply_norm)."""
    if cfg.encoder.encoder_type in _RNN_FAMILY:
        return rnn_encoder(p, cfg.encoder, x, lens)
    if cfg.encoder.encoder_type == "CONFORMER":
        from . import conformer
        y, out_lens = conformer.apply_conformer(p, cfg, x, lens, train=train,
                                                updates=bn_updates)
        return EncoderOut(y, out_lens, None)
    if cfg.encoder.encoder_type == "E_BRANCHFORMER":
        from . import e_branchformer
        y, out_lens = e_branchformer.apply_e_branchformer(p, cfg, x, lens)
        return EncoderOut(y, out_lens, None)
    from . import encoders_extra
    return encoders_extra.apply_encoder(p, cfg, x, lens, train=train,
                                        updates=bn_updates)


def encoder_output_size(cfg: Config) -> int:
    if cfg.encoder.encoder_type in _RNN_FAMILY + ("CONFORMER",
                                                  "E_BRANCHFORMER"):
        return cfg.encoder.enc_size
    from . import encoders_extra
    return encoders_extra.encoder_output_size(cfg)
