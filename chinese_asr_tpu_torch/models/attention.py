"""Bahdanau additive attention (port of ``chinese_asr_tpu/models/attention.py``,
reference attention.py:20-111), single head, batch-major [B, L, D]."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config import AttentionConfig

Params = Dict[str, torch.Tensor]


def _require_bahdanau(cfg: AttentionConfig) -> None:
    if cfg.attn_type != "B" or cfg.heads != 1 or cfg.map_enc:
        raise NotImplementedError(
            "only single-head Bahdanau attention without map_enc is ported "
            "so far (Luong / multi-head come with the encoder-families "
            "slice)")


def init_attention(gen: torch.Generator, cfg: AttentionConfig, enc_size: int,
                   dec_hidden: int) -> Params:
    """Reference attention.py:53-65: xavier-normal W_enc/W_hidden, N(0, .1)
    v, zero bias."""
    _require_bahdanau(cfg)
    a = cfg.attn_size

    def xavier(shape):
        return math.sqrt(2.0 / (shape[0] + shape[1])) * torch.randn(
            shape, generator=gen)

    return {
        "w_enc": xavier((enc_size, a)),
        "b_attn": torch.zeros(a),
        "w_hidden": xavier((dec_hidden, a)),
        "v": 0.1 * torch.randn(a, generator=gen),
    }


def compute_key_value(p: Params, cfg: AttentionConfig, enc_outputs):
    """enc_outputs [B, L, enc] -> keys [B, L, a], values [B, L, enc]
    (reference attention.py:67-78)."""
    _require_bahdanau(cfg)
    keys = torch.matmul(enc_outputs, p["w_enc"]) + p["b_attn"]
    return keys, enc_outputs


def attend(p: Params, cfg: AttentionConfig, mask, hidden_state, keys, values
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention read.  mask [B, L] additive, hidden_state [B, H] ->
    (context [B, ctx], alignment [B, L])."""
    q = hidden_state @ p["w_hidden"]                      # [B, a]
    e = torch.tanh(keys + q[:, None, :]) * p["v"]         # [B, L, a]
    scores = e.sum(dim=-1)                                # [B, L]
    align = torch.softmax(mask + scores, dim=1)
    context = (align[..., None] * values).sum(dim=1)      # [B, ctx]
    return context, align


def attend_beam(p: Params, cfg: AttentionConfig, mask, hidden_state, keys,
                values) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-shaped read: k beams per sample share one copy of keys/values
    (never tiled nor reordered).  mask [B, L]; hidden_state [B, k, H];
    keys [B, L, a]; values [B, L, d] -> (context [B, k, d], align
    [B, k, L]).  The tanh intermediate is [B, k, L, a] (~350 MB f32 at
    B=128, k=16, L=332, a=128)."""
    q = hidden_state @ p["w_hidden"]                      # [B, k, a]
    e = torch.tanh(keys[:, None, :, :] + q[:, :, None, :]) * p["v"]
    scores = e.sum(dim=-1)                                # [B, k, L]
    align = torch.softmax(mask[:, None, :] + scores, dim=-1)
    context = torch.bmm(align, values)                    # [B, k, d]
    return context, align
