"""Attention decoder step (port of ``chinese_asr_tpu/models/decoder.py``,
reference decoder.py:10-137): embed -> input-feed concat -> LSTM cell
stack -> Bahdanau attention -> logits."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import AttentionConfig, DecoderConfig, VocabConfig
from ..ops import rnn as rnn_ops
from . import attention as attn_ops

Params = Dict


class DecoderOut(NamedTuple):
    logit: torch.Tensor                # [B, V]
    attn_hidden_state: torch.Tensor    # [B, ctx]
    alignment: torch.Tensor            # [B, L]
    cell_state: List                   # per-layer (h, c)


def init_decoder(gen: torch.Generator, dcfg: DecoderConfig,
                 acfg: AttentionConfig, vcfg: VocabConfig,
                 enc_size: int) -> Params:
    """Reference decoder.py:75-92: embedding N(0, .1) with the pad row
    zeroed, init_rnn'd cells, xavier proj weight, torch-default uniform
    proj bias."""
    attn_ops._require_bahdanau(acfg)
    V = vcfg.vocab_size
    input_size = dcfg.embed_dim + enc_size
    proj_in = dcfg.hidden_size + enc_size
    emb = 0.1 * torch.randn(V, dcfg.embed_dim, generator=gen)
    emb[vcfg.pad] = 0.0
    bound = 1.0 / math.sqrt(proj_in)
    p: Params = {
        "embedding": emb,
        "cells": rnn_ops.init_cell_stack(gen, input_size, dcfg.hidden_size,
                                         dcfg.num_layers),
        "proj_w": math.sqrt(2.0 / (proj_in + V)) * torch.randn(
            proj_in, V, generator=gen),
        "proj_b": (torch.rand(V, generator=gen) * 2.0 - 1.0) * bound,
    }
    if dcfg.init_cell_state_as_param:
        p["init_state"] = [torch.zeros(dcfg.hidden_size)
                           for _ in range(dcfg.num_layers * 2)]
    return p


def attn_hidden_width(acfg: AttentionConfig, values_dim: int) -> int:
    """Width of the attentional hidden state fed back at the next step:
    the raw context for Bahdanau attention."""
    return acfg.attn_hidden_size if acfg.attn_type == "L" else values_dim


def get_initial_state(p: Params, dcfg: DecoderConfig, bsz: int, enc_state
                      ) -> Optional[List]:
    """Reference decoder.py:56-73: the encoder's last (h, c) replicated per
    layer when it fits the decoder cell, else the learned init, else None
    (zeros in the cell stack)."""
    if (enc_state is not None and isinstance(enc_state, tuple)
            and len(enc_state) == 2
            and enc_state[0].shape[-1] == dcfg.hidden_size):
        return [enc_state] * dcfg.num_layers
    if "init_state" in p:
        init = p["init_state"]
        return [(init[2 * i].expand(bsz, -1), init[2 * i + 1].expand(bsz, -1))
                for i in range(dcfg.num_layers)]
    return None


def _logit(p: Params, last_h, ahs):
    return torch.cat([last_h, ahs], dim=-1) @ p["proj_w"] + p["proj_b"]


def decoder_step(p: Params, attn_p, dcfg: DecoderConfig, acfg: AttentionConfig,
                 mask, keys, values, token, cell_state, attn_hidden_state
                 ) -> DecoderOut:
    """Reference decoder.py:94-137.  token [B] int; attn_hidden_state
    [B, ctx] or None (zeros)."""
    x = p["embedding"][token]                             # row gather
    if dcfg.input_feeding:
        if attn_hidden_state is None:
            attn_hidden_state = x.new_zeros((x.shape[0], values.shape[-1]))
        x = torch.cat([x, attn_hidden_state], dim=1)
    cell_state = rnn_ops.cell_stack_step(dcfg.decoder_type, p["cells"], x,
                                         cell_state)
    last_h = cell_state[-1][0]
    context, alignment = attn_ops.attend(attn_p, acfg, mask, last_h, keys,
                                         values)
    return DecoderOut(_logit(p, last_h, context), context, alignment,
                      cell_state)


def decoder_step_beam(p: Params, attn_p, dcfg: DecoderConfig,
                      acfg: AttentionConfig, mask, keys, values, token,
                      cell_state, attn_hidden_state) -> DecoderOut:
    """Beam variant: cells run on flat [B*k] rows, attention on the untiled
    per-sample keys/values through ``attend_beam``.

    mask [B, L]; keys [B, L, a]; values [B, L, d]; token [B*k];
    attn_hidden_state [B*k, ctx]; cell_state per-layer over [B*k] rows."""
    B = mask.shape[0]
    k = token.shape[0] // B
    x = p["embedding"][token]
    if dcfg.input_feeding:
        x = torch.cat([x, attn_hidden_state], dim=1)
    cell_state = rnn_ops.cell_stack_step(dcfg.decoder_type, p["cells"], x,
                                         cell_state)
    last_h = cell_state[-1][0]
    context, alignment = attn_ops.attend_beam(
        attn_p, acfg, mask, last_h.reshape(B, k, -1), keys, values)
    context = context.reshape(B * k, -1)
    return DecoderOut(_logit(p, last_h, context), context,
                      alignment.reshape(B * k, -1), cell_state)
