"""Additive attention (port of ``chinese_asr_tpu/models/attention.py``,
reference attention.py:20-111), batch-major [B, L, D]: one head or
``heads`` heads over slices of the attention width, with the optional
``map_enc`` value projection and, for several heads, the ``linear_map``
of the concatenated context."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..config import AttentionConfig
from ..ops.cuda import attention as attn_k

Params = Dict[str, torch.Tensor]


def context_size(cfg: AttentionConfig, enc_size: int) -> int:
    return cfg.attn_size if cfg.map_enc else enc_size


def init_attention(gen: torch.Generator, cfg: AttentionConfig, enc_size: int,
                   dec_hidden: int) -> Params:
    """Reference attention.py:53-65: xavier-normal W_enc/W_hidden, N(0, .1)
    v, zero bias; map_enc a no-bias linear, linear_map a square matrix."""
    a = cfg.attn_size

    def xavier(shape):
        return math.sqrt(2.0 / (shape[0] + shape[1])) * torch.randn(
            shape, generator=gen)

    p = {
        "w_enc": xavier((enc_size, a)),
        "b_attn": torch.zeros(a),
        "w_hidden": xavier((dec_hidden, a)),
        "v": 0.1 * torch.randn(a, generator=gen),
    }
    if cfg.map_enc:
        p["map_enc"] = xavier((enc_size, a))
    if cfg.heads > 1 and cfg.linear_map:
        ctx = context_size(cfg, enc_size)
        p["linear_map"] = xavier((ctx, ctx))
    return p


def compute_key_value(p: Params, cfg: AttentionConfig, enc_outputs):
    """enc_outputs [B, L, enc] -> keys [B, L, a], values [B, L, ctx]
    (reference attention.py:67-78)."""
    values = (torch.matmul(enc_outputs, p["map_enc"]) if "map_enc" in p
              else enc_outputs)
    keys = torch.matmul(enc_outputs, p["w_enc"]) + p["b_attn"]
    return keys, values


def attend(p: Params, cfg: AttentionConfig, mask, hidden_state, keys, values
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One attention read.  mask [B, L] additive, hidden_state [B, H] ->
    (context [B, ctx], alignment [B, L], or [B, L, heads] for several
    heads)."""
    q = hidden_state @ p["w_hidden"]                      # [B, a]
    e = torch.tanh(keys + q[:, None, :]) * p["v"]         # [B, L, a]
    if cfg.heads == 1:
        scores = e.sum(dim=-1)                            # [B, L]
        align = torch.softmax(mask + scores, dim=1)
        context = (align[..., None] * values).sum(dim=1)  # [B, ctx]
        return context, align
    B, L, a = e.shape
    n = cfg.heads
    scores = e.reshape(B, L, n, a // n).sum(dim=-1)       # [B, L, n]
    align = torch.softmax(mask[..., None] + scores, dim=1)
    v_h = values.reshape(B, L, n, -1)                     # [B, L, n, d/n]
    context = (align[..., None] * v_h).sum(dim=1).reshape(B, -1)
    if "linear_map" in p:
        context = context @ p["linear_map"]
    return context, align


def attend_beam(p: Params, cfg: AttentionConfig, mask, hidden_state, keys,
                values) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-shaped read: k beams per sample share one copy of keys/values
    (never tiled nor reordered).  mask [B, L]; hidden_state [B, k, H];
    keys [B, L, a]; values [B, L, d] -> (context [B, k, ctx], align
    [B, k, L]; for several heads the first head's).

    One head: the scores and their softmax are K6
    (``ops/cuda/attention.py``; on the CPU its plain twin), which never
    forms the [B, k, L, a] tanh intermediate.  Several heads keep the
    plain expression and its intermediate: no benchmarked configuration
    runs them, and their softmax per head is another reduction."""
    q = hidden_state @ p["w_hidden"]                      # [B, k, a]
    if cfg.heads == 1:
        align = attn_k.beam_scores_softmax(mask, q, keys, p["v"])
        return torch.bmm(align, values), align            # [B, k, d]
    e = torch.tanh(keys[:, None, :, :] + q[:, :, None, :]) * p["v"]
    B, k, L, a = e.shape
    n = cfg.heads
    scores = e.reshape(B, k, L, n, a // n).sum(dim=-1)    # [B, k, L, n]
    align = torch.softmax(mask[:, None, :, None] + scores, dim=2)
    v_h = values.reshape(B, L, n, -1)
    context = torch.einsum("bkln,blnd->bknd", align, v_h).reshape(B, k, -1)
    if "linear_map" in p:
        context = context @ p["linear_map"]
    return context, align[..., 0]
