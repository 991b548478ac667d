"""Encoder (port of ``chinese_asr_tpu/models/encoder.py``): the RNN family's
4-layer residual bidirectional LSTM (reference ``RNNEncoder``,
encoder.py:9-83).  The conv / self-attention families come with a later
slice and raise here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import Config, EncoderConfig
from ..ops import rnn as rnn_ops
from ..ops.masks import length_mask

Params = Dict

_RNN_FAMILY = ("LSTM", "GRU", "RNN_TANH", "RNN_RELU")


class EncoderOut(NamedTuple):
    out: torch.Tensor               # [B, L, enc_size]
    out_lens: torch.Tensor          # [B]
    state: Optional[Tuple]          # (h, c) each [B, enc_size]


def _require_lstm(cfg: Config) -> None:
    if cfg.encoder.encoder_type != "LSTM":
        raise NotImplementedError(
            f"encoder_type {cfg.encoder.encoder_type!r}: only the LSTM "
            f"encoder is ported so far (the other families come with the "
            f"encoder-families slice)")


def init_rnn_encoder(gen: torch.Generator, ecfg: EncoderConfig,
                     input_size: int) -> Params:
    return {"layers": rnn_ops.init_rnn_stack(
        gen, input_size, ecfg.hidden_size, ecfg.num_layers,
        ecfg.bidirectional)}


def rnn_encoder(p: Params, ecfg: EncoderConfig, x, lens) -> EncoderOut:
    """x [B, T, D] zero-padded, lens [B] -> EncoderOut.  Final state: last
    layer, directions concatenated to [B, 2H] (reference encoder.py:67-77);
    like the reference, the returned lens are the input lens."""
    mask = length_mask(lens, x.shape[1], x.dtype)
    y, ((h_f, c_f), (h_b, c_b)), out_lens, _ = rnn_ops.rnn_stack(
        ecfg.encoder_type, p["layers"], x, lens, mask,
        residual=ecfg.residual, skip_step=ecfg.skip_step)
    state = (torch.cat([h_f, h_b], dim=-1), torch.cat([c_f, c_b], dim=-1))
    return EncoderOut(y, out_lens, state)


def init_encoder(gen: torch.Generator, cfg: Config) -> Params:
    _require_lstm(cfg)
    return init_rnn_encoder(gen, cfg.encoder, cfg.audio.feat_dim)


def apply_encoder(p: Params, cfg: Config, x, lens) -> EncoderOut:
    _require_lstm(cfg)
    return rnn_encoder(p, cfg.encoder, x, lens)


def encoder_output_size(cfg: Config) -> int:
    if cfg.encoder.encoder_type in _RNN_FAMILY:
        return cfg.encoder.enc_size
    return cfg.encoder.hidden_size
