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
from ..utils.observe import span
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
    ``device``, same names and layouts.  Floating leaves are cast to
    ``dtype`` (bf16 leaves, ml_dtypes arrays, carry across bit for bit),
    others keep their type, as the JAX package casts."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, order="C"))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def tree_paths(tree, path: tuple = ()) -> list:
    """(path, leaf) in ``jax.tree_util`` order: dict keys sorted, lists in
    order; a path is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_paths(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_paths(v, path + (i,))]
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def params_to_numpy(params: Params):
    """The inverse of ``params_from_numpy``: the same tree with numpy
    leaves on the host (floating leaves as float32), the ``params`` of a
    ``chinese_asr_tpu.v1`` checkpoint, which the JAX package loads as it
    loads its own."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()

    return tree_map(leaf, params)


def count_params(params: Params) -> int:
    return int(sum(t.numel() for t in tree_leaves(params)))


class EncodedBatch(NamedTuple):
    enc_out: torch.Tensor    # [B, L, enc]
    mask: torch.Tensor       # [B, L] additive softmax mask
    keys: torch.Tensor       # [B, L, a]
    values: torch.Tensor     # [B, L, ctx]
    init_cell_state: Optional[list]


def encode(params: Params, cfg: Config, feats, feat_lens,
           train: bool = False, bn_updates=None) -> EncodedBatch:
    """Shared decode prologue (reference model.py:523-534): encoder forward,
    softmax mask, decoder initial state, attention key/value precompute.
    ``train`` switches the BatchNorm encoders to batch statistics and, with
    a ``bn_updates`` list, records the running-stat updates for the train
    step (torch BatchNorm semantics)."""
    with span("asr.encode", lambda: f"B {feats.shape[0]} T {feats.shape[1]}"):
        enc = enc_ops.apply_encoder(params["encoder"], cfg, feats, feat_lens,
                                    train=train, bn_updates=bn_updates)
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
    """Params tree from reference state_dict arrays (numpy), transposed to
    right-matmul layout.  Expected names (default LSTM config):

      encoder: rnn.rnn.{i}.weight_ih_l0[_reverse], weight_hh_l0, bias_ih_l0,
               bias_hh_l0 (every RNN mode); the other families as
               ``encoders_extra.encoder_from_torch_state`` reads them
      decoder: embedding.weight, cell.cell.{i}.weight_ih/hh, bias_ih/hh,
               proj_linear.weight/bias, [attn_hidden_weight],
               attn_mechanism.W_enc/b_attn/W_hidden/v[/map_enc.weight
               /linear_map]"""
    ecfg, dcfg = cfg.encoder, cfg.decoder

    def T(name, sd):
        return np.asarray(sd[name]).T

    if ecfg.encoder_type in enc_ops._RNN_FAMILY:
        from .encoders_extra import rnn_stack_from_sd
        encoder = {"layers": rnn_stack_from_sd(enc_sd, "rnn.rnn.",
                                               ecfg.num_layers,
                                               ecfg.bidirectional)}
    else:
        from . import encoders_extra
        encoder = encoders_extra.encoder_from_torch_state(enc_sd, cfg)

    # the attention lives in the decoder's state dict (the reference's
    # decoder holds attn_mechanism; its tensors are in math orientation)
    attention = {
        "w_enc": dec_sd["attn_mechanism.W_enc"],
        "b_attn": dec_sd["attn_mechanism.b_attn"],
        "w_hidden": dec_sd["attn_mechanism.W_hidden"],
        "v": dec_sd["attn_mechanism.v"],
    }
    if "attn_mechanism.map_enc.weight" in dec_sd:
        attention["map_enc"] = T("attn_mechanism.map_enc.weight", dec_sd)
    if "attn_mechanism.linear_map" in dec_sd:
        attention["linear_map"] = dec_sd["attn_mechanism.linear_map"]
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
    if "attn_hidden_weight" in dec_sd:
        decoder["attn_hidden_w"] = dec_sd["attn_hidden_weight"]
    # learned decoder init: the reference's "dec_init_cell_state.{i}"
    # (decoder.py:36-40), or "init_state.{i}" from older exports
    for name in ("dec_init_cell_state", "init_state"):
        if f"{name}.0" in dec_sd:
            init = []
            while f"{name}.{len(init)}" in dec_sd:
                init.append(dec_sd[f"{name}.{len(init)}"])
            decoder["init_state"] = init
            break
    tree = {"encoder": encoder, "attention": attention, "decoder": decoder}
    return params_from_numpy(tree, device)


def load_torch_checkpoint(path: str, cfg: Config, device=None) -> Params:
    """Load a reference .ckpt (torch.save dict, model.py:347-355).  Only
    load checkpoints you trust: the file is unpickled."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    enc_sd = {k: v.numpy() for k, v in ckpt["encoder_state_dict"].items()}
    dec_sd = {k: v.numpy() for k, v in ckpt["decoder_state_dict"].items()}
    return params_from_torch_state(enc_sd, dec_sd, cfg, device)


def params_to_torch_state(params: Params, cfg: Config):
    """Inverse of ``params_from_torch_state``: (enc_sd, dec_sd) numpy dicts
    in the reference's tensor names and orientation, so that a model
    trained here loads in the reference code (or re-imports).  It covers
    what JAX exports: the RNN encoder family, the attention with its
    map_enc / linear_map, the Luong projection and the learned decoder
    init state; the other encoder families raise, as in JAX."""
    unexported = set(params["encoder"]) - {"layers"}
    if unexported:
        raise ValueError(
            f"torch export supports the RNN encoder family only; params "
            f"contain unsupported encoder entries {sorted(unexported)}")
    p = params_to_numpy(params)
    enc_sd: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(p["encoder"]["layers"]):
        base = f"rnn.rnn.{i}."
        for dname, suffix in (("fwd", ""), ("bwd", "_reverse")):
            if dname not in layer:
                continue
            d = layer[dname]
            enc_sd[base + "weight_ih_l0" + suffix] = d["w_ih"].T
            enc_sd[base + "weight_hh_l0" + suffix] = d["w_hh"].T
            enc_sd[base + "bias_ih_l0" + suffix] = d["b_ih"]
            enc_sd[base + "bias_hh_l0" + suffix] = d["b_hh"]
    ap, dp = p["attention"], p["decoder"]
    dec_sd: Dict[str, np.ndarray] = {
        "embedding.weight": dp["embedding"],
        "proj_linear.weight": dp["proj_w"].T,
        "proj_linear.bias": dp["proj_b"],
        "attn_mechanism.W_enc": ap["w_enc"],
        "attn_mechanism.b_attn": ap["b_attn"],
        "attn_mechanism.W_hidden": ap["w_hidden"],
        "attn_mechanism.v": ap["v"],
    }
    if "map_enc" in ap:
        dec_sd["attn_mechanism.map_enc.weight"] = ap["map_enc"].T
    if "linear_map" in ap:
        dec_sd["attn_mechanism.linear_map"] = ap["linear_map"]
    for i, cell in enumerate(dp["cells"]):
        base = f"cell.cell.{i}."
        dec_sd[base + "weight_ih"] = cell["w_ih"].T
        dec_sd[base + "weight_hh"] = cell["w_hh"].T
        dec_sd[base + "bias_ih"] = cell["b_ih"]
        dec_sd[base + "bias_hh"] = cell["b_hh"]
    if "attn_hidden_w" in dp:
        dec_sd["attn_hidden_weight"] = dp["attn_hidden_w"]
    # reference naming (decoder.py:36-40), so that its load_state_dict
    # takes a learned-init checkpoint exported from here
    for i, e in enumerate(dp.get("init_state", [])):
        dec_sd[f"dec_init_cell_state.{i}"] = e
    return enc_sd, dec_sd


def save_torch_checkpoint(path: str, params: Params, cfg: Config,
                          args=None) -> str:
    """Write a reference-schema .ckpt (model.py:347-355:
    {'encoder_state_dict', 'decoder_state_dict', 'optimizer_state_dict',
    'args'}), loadable by the reference code and by
    ``load_torch_checkpoint``."""
    enc_sd, dec_sd = params_to_torch_state(params, cfg)

    def sd(d):
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in d.items()}

    torch.save({"encoder_state_dict": sd(enc_sd),
                "decoder_state_dict": sd(dec_sd),
                "optimizer_state_dict": {}, "args": args}, path)
    return path
