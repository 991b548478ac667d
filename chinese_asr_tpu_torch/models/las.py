"""LAS model assembly (port of ``chinese_asr_tpu/models/las.py``): parameter
trees, the encode prologue, and weight import.

Parameters are nested dicts/lists of tensors with the JAX package's tree
names and layouts (``encoder/layers[i]/fwd/w_ih [D, 4H]`` ...), so a JAX
parameter tree carries over leaf for leaf (``params_from_numpy``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.masks import softmax_mask
from . import attention as attn_ops
from . import decoder as dec_ops
from . import encoder as enc_ops

Params = Dict


def init_params(cfg: Config, seed: int = 0, device=None) -> Params:
    """Random weights with the reference initializers, drawn on the CPU
    from ``torch.Generator().manual_seed(seed)`` (so a seed gives the same
    weights on every device), then moved to ``device``."""
    gen = torch.Generator().manual_seed(seed)
    enc_size = enc_ops.encoder_output_size(cfg)
    params = {
        "encoder": enc_ops.init_encoder(gen, cfg),
        "attention": attn_ops.init_attention(gen, cfg.attention, enc_size,
                                             cfg.decoder.hidden_size),
        "decoder": dec_ops.init_decoder(gen, cfg.decoder, cfg.attention,
                                        cfg.vocab, enc_size),
    }
    return tree_map(lambda t: t.to(device), params)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device=None, dtype=torch.float32) -> Params:
    """The JAX package's parameter tree with numpy leaves (as
    ``jax.tree_util.tree_map(np.asarray, params)`` or a
    ``chinese_asr_tpu.v1`` checkpoint gives it) -> the port's tensors on
    ``device``, same names and layouts."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, np.float32, order="C")).to(
            device=device, dtype=dtype), tree)


class EncodedBatch(NamedTuple):
    enc_out: torch.Tensor    # [B, L, enc]
    mask: torch.Tensor       # [B, L] additive softmax mask
    keys: torch.Tensor       # [B, L, a]
    values: torch.Tensor     # [B, L, ctx]
    init_cell_state: Optional[list]


def encode(params: Params, cfg: Config, feats, feat_lens) -> EncodedBatch:
    """Shared decode prologue (reference model.py:523-534): encoder forward,
    softmax mask, decoder initial state, attention key/value precompute."""
    enc = enc_ops.apply_encoder(params["encoder"], cfg, feats, feat_lens)
    mask = softmax_mask(enc.out_lens, enc.out.shape[1], enc.out.dtype)
    cell_state = dec_ops.get_initial_state(params["decoder"], cfg.decoder,
                                           feats.shape[0], enc.state)
    keys, values = attn_ops.compute_key_value(params["attention"],
                                              cfg.attention, enc.out)
    return EncodedBatch(enc.out, mask, keys, values, cell_state)


# --------------------------------------------------------------------------
# reference torch checkpoint import (reference save format
# model.py:347-355: {'encoder_state_dict', 'decoder_state_dict', ...};
# tensor names per test.py:16-21)
# --------------------------------------------------------------------------
def params_from_torch_state(enc_sd: Dict[str, np.ndarray],
                            dec_sd: Dict[str, np.ndarray],
                            cfg: Config, device=None) -> Params:
    """Params tree from reference state_dict arrays (numpy): the LSTM
    encoder and the Bahdanau decoder, transposed to right-matmul layout."""
    ecfg, dcfg = cfg.encoder, cfg.decoder
    enc_ops._require_lstm(cfg)

    def T(name, sd):
        return np.asarray(sd[name]).T

    layers = []
    for i in range(ecfg.num_layers):
        base = f"rnn.rnn.{i}."
        layer = {}
        for dname, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if dname == "bwd" and not ecfg.bidirectional:
                continue
            layer[dname] = {
                "w_ih": T(base + "weight_ih_l0" + suffix, enc_sd),
                "w_hh": T(base + "weight_hh_l0" + suffix, enc_sd),
                "b_ih": np.asarray(enc_sd[base + "bias_ih_l0" + suffix]),
                "b_hh": np.asarray(enc_sd[base + "bias_hh_l0" + suffix]),
            }
        layers.append(layer)

    attention = {
        "w_enc": dec_sd["attn_mechanism.W_enc"],
        "b_attn": dec_sd["attn_mechanism.b_attn"],
        "w_hidden": dec_sd["attn_mechanism.W_hidden"],
        "v": dec_sd["attn_mechanism.v"],
    }
    cells = []
    for i in range(dcfg.num_layers):
        base = f"cell.cell.{i}."
        cells.append({
            "w_ih": T(base + "weight_ih", dec_sd),
            "w_hh": T(base + "weight_hh", dec_sd),
            "b_ih": dec_sd[base + "bias_ih"],
            "b_hh": dec_sd[base + "bias_hh"],
        })
    decoder = {
        "embedding": dec_sd["embedding.weight"],
        "cells": cells,
        "proj_w": T("proj_linear.weight", dec_sd),
        "proj_b": dec_sd["proj_linear.bias"],
    }
    # learned decoder init: the reference's "dec_init_cell_state.{i}"
    # (decoder.py:36-40), or "init_state.{i}" from older exports
    for name in ("dec_init_cell_state", "init_state"):
        if f"{name}.0" in dec_sd:
            init = []
            while f"{name}.{len(init)}" in dec_sd:
                init.append(dec_sd[f"{name}.{len(init)}"])
            decoder["init_state"] = init
            break
    tree = {"encoder": {"layers": layers}, "attention": attention,
            "decoder": decoder}
    return params_from_numpy(tree, device)


def load_torch_checkpoint(path: str, cfg: Config, device=None) -> Params:
    """Load a reference .ckpt (torch.save dict, model.py:347-355).  Only
    load checkpoints you trust: the file is unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    enc_sd = {k: v.numpy() for k, v in ckpt["encoder_state_dict"].items()}
    dec_sd = {k: v.numpy() for k, v in ckpt["decoder_state_dict"].items()}
    return params_from_torch_state(enc_sd, dec_sd, cfg, device)
