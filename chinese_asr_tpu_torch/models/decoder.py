"""Attention decoder step (port of ``chinese_asr_tpu/models/decoder.py``,
reference decoder.py:10-137): embed -> input-feed concat -> LSTM / GRU /
RNN cell stack -> attention -> attentional hidden state -> logits.

Bahdanau wiring (``attn_type="B"``) feeds the context back and projects
[h, context]; Luong wiring (``"L"``, decoder.py:39-51, 126-127) feeds back
``tanh([h, context] @ attn_hidden_w)`` and projects that alone.

On a mesh (``mesh``, ``parallel/sharding.py``) the embedding and the
output projection hold this model rank's V/mp rows and columns: the lookup
sums the model ranks' rows and the logits come back as full [.., V] rows
(``sharding.embed``, ``sharding.vocab_logits``)."""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import AttentionConfig, DecoderConfig, VocabConfig
from ..ops import rnn as rnn_ops
from ..parallel import sharding
from . import attention as attn_ops

Params = Dict


class DecoderOut(NamedTuple):
    logit: torch.Tensor                # [B, V]
    attn_hidden_state: torch.Tensor    # [B, ctx]
    alignment: torch.Tensor            # [B, L] ([B, L, heads] in decoder_step)
    cell_state: List                   # per-layer (h, c) for LSTM, else h


def init_decoder(gen: torch.Generator, dcfg: DecoderConfig,
                 acfg: AttentionConfig, vcfg: VocabConfig,
                 enc_size: int) -> Params:
    """Reference decoder.py:75-92: embedding N(0, .1) with the pad row
    zeroed, init_rnn'd cells, xavier proj weight, torch-default uniform
    proj bias; for Luong wiring a xavier ``attn_hidden_w``."""
    V = vcfg.vocab_size
    ctx = attn_ops.context_size(acfg, enc_size)
    if acfg.attn_type == "L":
        input_size = dcfg.embed_dim + (acfg.attn_hidden_size
                                       if dcfg.input_feeding else 0)
        proj_in = acfg.attn_hidden_size
    else:
        input_size = dcfg.embed_dim + ctx
        proj_in = dcfg.hidden_size + ctx

    def xavier(shape):
        return math.sqrt(2.0 / (shape[0] + shape[1])) * torch.randn(
            shape, generator=gen)

    emb = 0.1 * torch.randn(V, dcfg.embed_dim, generator=gen)
    emb[vcfg.pad] = 0.0
    bound = 1.0 / math.sqrt(proj_in)
    p: Params = {
        "embedding": emb,
        "cells": rnn_ops.init_cell_stack(gen, dcfg.decoder_type, input_size,
                                         dcfg.hidden_size, dcfg.num_layers),
        "proj_w": xavier((proj_in, V)),
        "proj_b": (torch.rand(V, generator=gen) * 2.0 - 1.0) * bound,
    }
    if acfg.attn_type == "L":
        p["attn_hidden_w"] = xavier((dcfg.hidden_size + ctx,
                                     acfg.attn_hidden_size))
    if dcfg.init_cell_state_as_param:
        num_state = 2 if dcfg.decoder_type == "LSTM" else 1
        p["init_state"] = [torch.zeros(dcfg.hidden_size)
                           for _ in range(dcfg.num_layers * num_state)]
    return p


def attn_hidden_width(acfg: AttentionConfig, values_dim: int) -> int:
    """Width of the attentional hidden state fed back at the next step:
    the raw context for "B", the tanh-projected size for "L"."""
    return acfg.attn_hidden_size if acfg.attn_type == "L" else values_dim


def zero_cell_state(dcfg: DecoderConfig, like, rows: int) -> List:
    """The all-zero per-layer state of ``rows`` rows: (z, z) for LSTM,
    z otherwise (JAX ``cell0``)."""
    z = like.new_zeros((rows, dcfg.hidden_size))
    return [(z, z) if dcfg.decoder_type == "LSTM" else z] * dcfg.num_layers


def last_hidden(dcfg: DecoderConfig, cell_state: List):
    """The top layer's h."""
    last = cell_state[-1]
    return last[0] if dcfg.decoder_type == "LSTM" else last


def get_initial_state(p: Params, dcfg: DecoderConfig, bsz: int, enc_state
                      ) -> Optional[List]:
    """Reference decoder.py:56-73: the encoder's last state replicated per
    layer when it fits the decoder cell, else the learned init, else None
    (zeros in the cell stack).  A state that does not fit (a GRU encoder's
    plain h next to an LSTM decoder's (h, c), or another width) falls
    through."""
    if enc_state is not None:
        if dcfg.decoder_type == "LSTM":
            fits = (isinstance(enc_state, tuple) and len(enc_state) == 2
                    and enc_state[0].shape[-1] == dcfg.hidden_size)
        else:
            fits = (not isinstance(enc_state, tuple)
                    and enc_state.shape[-1] == dcfg.hidden_size)
        if fits:
            return [enc_state] * dcfg.num_layers
    if "init_state" in p:
        init = p["init_state"]
        if dcfg.decoder_type != "LSTM":
            return [e.expand(bsz, -1) for e in init]
        return [(init[2 * i].expand(bsz, -1), init[2 * i + 1].expand(bsz, -1))
                for i in range(dcfg.num_layers)]
    return None


def _attn_hidden(p: Params, acfg: AttentionConfig, last_h, context):
    if acfg.attn_type == "L":
        return torch.tanh(torch.cat([last_h, context], dim=1)
                          @ p["attn_hidden_w"])
    return context


def embed(p: Params, token, mesh=None):
    """The embedding rows of ``token`` (any shape)."""
    return sharding.embed(p["embedding"], token, mesh)


def project(p: Params, acfg: AttentionConfig, last_h, ahs, mesh=None):
    """Logits from the step's top h and attentional hidden state."""
    x = torch.cat([last_h, ahs], dim=-1) if acfg.attn_type == "B" else ahs
    return sharding.vocab_logits(x, p["proj_w"], p["proj_b"], mesh)


def decoder_step(p: Params, attn_p, dcfg: DecoderConfig, acfg: AttentionConfig,
                 mask, keys, values, token, cell_state, attn_hidden_state,
                 compute_logit: bool = True, token_emb=None,
                 gate_partial=None, mesh=None) -> DecoderOut:
    """Reference decoder.py:94-137.  token [B] int; attn_hidden_state
    [B, ctx] or None (zeros).

    ``token_emb`` [B, E]: the input already embedded (the teacher-forced
    trainer embeds all [B, S] tokens at once); ``token`` is then ignored.
    ``gate_partial`` [B, 4H]: layer 0's gate contribution of the embedding
    with both biases (``emb @ W_ih[:E] + b_ih + b_hh``), computed outside
    the step loop; layer 0 then multiplies only the fed-back attentional
    state and W_hh (LSTM with input feeding only, as in JAX).
    ``compute_logit=False`` leaves ``logit`` None (the trainer projects all
    steps at once)."""
    ctx_size = attn_hidden_width(acfg, values.shape[-1])
    if gate_partial is not None:
        if dcfg.decoder_type != "LSTM" or not dcfg.input_feeding:
            raise ValueError("gate_partial needs an LSTM decoder with input "
                             "feeding")
        B = gate_partial.shape[0]
        if attn_hidden_state is None:
            attn_hidden_state = gate_partial.new_zeros((B, ctx_size))
        if cell_state is None:
            cell_state = [(gate_partial.new_zeros((B, l["w_hh"].shape[0])),) * 2
                          for l in p["cells"]]
        p0 = p["cells"][0]
        E = p0["w_ih"].shape[0] - attn_hidden_state.shape[1]
        h0, c0 = cell_state[0]
        gates = (gate_partial + attn_hidden_state @ p0["w_ih"][E:]
                 + h0 @ p0["w_hh"])
        h, c = rnn_ops.lstm_from_gates(gates, c0)
        cell_state = [(h, c)] + (rnn_ops.cell_stack_step(
            dcfg.decoder_type, p["cells"][1:], h, cell_state[1:])
            if len(p["cells"]) > 1 else [])
    else:
        x = token_emb if token_emb is not None else embed(p, token, mesh)
        if dcfg.input_feeding:
            if attn_hidden_state is None:
                attn_hidden_state = x.new_zeros((x.shape[0], ctx_size))
            x = torch.cat([x, attn_hidden_state], dim=1)
        cell_state = rnn_ops.cell_stack_step(dcfg.decoder_type, p["cells"],
                                             x, cell_state)
    last_h = last_hidden(dcfg, cell_state)
    context, alignment = attn_ops.attend(attn_p, acfg, mask, last_h, keys,
                                         values)
    ahs = _attn_hidden(p, acfg, last_h, context)
    logit = project(p, acfg, last_h, ahs, mesh) if compute_logit else None
    return DecoderOut(logit, ahs, alignment, cell_state)


def decoder_step_beam(p: Params, attn_p, dcfg: DecoderConfig,
                      acfg: AttentionConfig, mask, keys, values, token,
                      cell_state, attn_hidden_state, mesh=None) -> DecoderOut:
    """Beam variant: cells run on flat [B*k] rows, attention on the untiled
    per-sample keys/values through ``attend_beam``.

    mask [B, L]; keys [B, L, a]; values [B, L, d]; token [B*k];
    attn_hidden_state [B*k, ctx]; cell_state per-layer over [B*k] rows."""
    B = mask.shape[0]
    k = token.shape[0] // B
    x = embed(p, token, mesh)
    if dcfg.input_feeding:
        x = torch.cat([x, attn_hidden_state], dim=1)
    cell_state = rnn_ops.cell_stack_step(dcfg.decoder_type, p["cells"], x,
                                         cell_state)
    last_h = last_hidden(dcfg, cell_state)
    context, alignment = attn_ops.attend_beam(
        attn_p, acfg, mask, last_h.reshape(B, k, -1), keys, values)
    ahs = _attn_hidden(p, acfg, last_h, context.reshape(B * k, -1))
    return DecoderOut(project(p, acfg, last_h, ahs, mesh), ahs,
                      alignment.reshape(B * k, -1), cell_state)
