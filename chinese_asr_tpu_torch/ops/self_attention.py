"""Self-attention ops and transformer-style blocks (port of
``chinese_asr_tpu/ops/self_attention.py``; reference util.py:459-635
attention math, util.py:1664-1864 FFN/QKV modules and blocks,
util.py:749-765 sinusoidal positions).

The reference's quirks are kept, as in JAX: the block INPUT is scaled by
head_dim**-0.5 before the joint QKV projection (util.py:1725-1729); the
residual applies only when input and output widths match
(util.py:1810-1812); local attention takes ws-wide windows whose start is
clamped to [0, len-ws] per sample (util.py:542-560), slots past a
sample's length masked with -inf.  Layouts are batch-major [B, L, D]; the
windowed gather is the fixed-shape [B, L, ws, d].
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch

from .masks import length_mask, softmax_mask

Params = Dict[str, torch.Tensor]


def _xavier(gen: torch.Generator, shape):
    return math.sqrt(2.0 / (shape[0] + shape[1])) * torch.randn(shape,
                                                                generator=gen)


@functools.lru_cache(maxsize=None)
def sin_pos_embedding(length: int, dim: int, dtype=torch.float32,
                      device=None):
    """Sinusoidal positions (reference get_sin_pos_embedding,
    util.py:749-765), computed in float64 on the host as JAX does.
    Cached (do not write into the result): a CUDA graph's capture cannot
    copy from the host, and the graph keeps reading this tensor."""
    pos = np.arange(length)[:, None].astype(np.float64)
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / dim)
    emb = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


# --------------------------------------------------------------------------
# attention math
# --------------------------------------------------------------------------
def self_attention(q, k, v, lens, heads: int, proj_w=None):
    """Full masked QK attention (reference compute_self_attention,
    util.py:459-508).  q/k/v [B, L, D] -> (attn [B, L, D], alignment)."""
    B, L, D = q.shape
    if heads > 1:
        qh = q.reshape(B, L, heads, -1).transpose(1, 2)
        kh = k.reshape(B, L, heads, -1).transpose(1, 2)
        align = qh @ kh.transpose(2, 3)                   # [B, n, L, L]
    else:
        align = q @ k.transpose(1, 2)                     # [B, L, L]
    if lens is not None:
        km = softmax_mask(lens, L, q.dtype)               # [B, L]
        align = align + (km[:, None, None, :] if heads > 1
                         else km[:, None, :])
    align = torch.softmax(align, dim=-1)
    if heads > 1:
        vh = v.reshape(B, L, heads, -1).transpose(1, 2)
        attn = (align @ vh).transpose(1, 2).reshape(B, L, -1)
        if proj_w is not None:
            attn = attn @ proj_w
    else:
        attn = align @ v
    if lens is not None:
        attn = attn * length_mask(lens, L, attn.dtype)[..., None]
    return attn, align


def self_local_attention(q, k, v, lens, ws: int, heads: int, proj_w=None):
    """Windowed local attention (reference compute_self_local_attention,
    util.py:511-635): per-position ws-wide key/value windows, the start
    clamped into the valid region."""
    B, L, D = q.shape
    n = ws // 2
    lens_arr = (torch.full((B,), L, dtype=torch.int64, device=q.device)
                if lens is None else lens.to(torch.int64))
    pos = torch.arange(L, device=q.device)[None, :]                  # [1, L]
    upper = torch.clamp(lens_arr[:, None] - ws, min=0)               # [B, 1]
    start = torch.minimum(torch.clamp(pos - n, min=0), upper)        # [B, L]
    idx = start[:, :, None] + torch.arange(ws, device=q.device)      # [B,L,ws]
    gidx = torch.clamp(idx, max=L - 1).reshape(B, L * ws)
    rows = torch.arange(B, device=q.device)[:, None]

    def gather(t):                     # [B, L, D] -> [B, L, ws, D]
        return t[rows, gidx].reshape(B, L, ws, -1)

    kw, vw = gather(k), gather(v)
    invalid = idx >= lens_arr[:, None, None]                         # [B,L,ws]
    neg = torch.full((), float("-inf"), dtype=q.dtype, device=q.device)
    if heads > 1:
        qh = q.reshape(B, L, heads, -1)
        kh = kw.reshape(B, L, ws, heads, -1)
        align = torch.einsum("blhd,blwhd->bhlw", qh, kh)             # [B,n,L,ws]
        align = torch.where(invalid[:, None], neg, align)
        align = torch.softmax(align, dim=-1)
        vh = vw.reshape(B, L, ws, heads, -1)
        attn = torch.einsum("bhlw,blwhd->blhd", align, vh).reshape(B, L, -1)
        if proj_w is not None:
            attn = attn @ proj_w
    else:
        align = torch.einsum("bld,blwd->blw", q, kw)
        align = torch.where(invalid, neg, align)
        align = torch.softmax(align, dim=-1)
        attn = torch.einsum("blw,blwd->bld", align, vw)
    if lens is not None:
        attn = attn * length_mask(lens, L, attn.dtype)[..., None]
    return attn, align


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
def init_qkv(gen: torch.Generator, input_size: int, hidden_size: int,
             proj: bool) -> Params:
    p = {"w_qkv": _xavier(gen, (input_size, 3 * hidden_size)),
         "b_qkv": torch.zeros(3 * hidden_size)}
    if proj:
        p["w_proj"] = _xavier(gen, (hidden_size, hidden_size))
    return p


def qkv_attention(p: Params, x, lens, heads: int, ws: Optional[int] = None):
    """SelfAttention / SelfLocalAttention module (util.py:1694-1774), with
    the input-scaling quirk."""
    hidden = p["w_qkv"].shape[1] // 3
    x = x * (hidden // heads) ** -0.5
    q, k, v = torch.chunk(x @ p["w_qkv"] + p["b_qkv"], 3, dim=-1)
    proj_w = p.get("w_proj")
    if ws is None:
        return self_attention(q, k, v, lens, heads, proj_w)[0]
    return self_local_attention(q, k, v, lens, ws, heads, proj_w)[0]


def init_ffn(gen: torch.Generator, input_size: int, hidden_size: int,
             output_size: int) -> Params:
    return {"w1": _xavier(gen, (input_size, hidden_size)),
            "w2": _xavier(gen, (hidden_size, output_size)),
            "b1": torch.zeros(hidden_size),
            "b2": torch.zeros(output_size)}


def ffn(p: Params, x):
    return torch.relu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def layer_norm(scale, bias, x, eps: float = 1e-5):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


# --------------------------------------------------------------------------
# multi-head attention with an incremental KV cache (the capability of the
# reference's vendored fairseq MultiheadAttention_fair, util.py:1868-2120,
# unused by its default path): a preallocated [B, max_len, D] cache and a
# length
# --------------------------------------------------------------------------
def init_mha(gen: torch.Generator, embed_dim: int, heads: int) -> Params:
    return {"w_qkv": _xavier(gen, (embed_dim, 3 * embed_dim)),
            "b_qkv": torch.zeros(3 * embed_dim),
            "w_out": _xavier(gen, (embed_dim, embed_dim)),
            "b_out": torch.zeros(embed_dim),
            "heads": heads}


def mha_init_cache(batch: int, max_len: int, embed_dim: int,
                   dtype=torch.float32, device=None):
    z = torch.zeros((batch, max_len, embed_dim), dtype=dtype, device=device)
    return {"k": z, "v": z, "len": 0}


def mha_step(p: Params, x, cache):
    """One incremental decode step: x [B, D] -> (y [B, D], new cache).
    Writes this step's key/value at ``cache["len"]`` and attends over the
    valid prefix (fairseq's incremental_state contract, fixed shapes)."""
    heads = p["heads"]
    B, D = x.shape
    hd = D // heads
    q, k_new, v_new = torch.chunk((x * hd ** -0.5) @ p["w_qkv"] + p["b_qkv"],
                                  3, dim=-1)
    L = cache["k"].shape[1]
    pos = cache["len"]
    k = cache["k"].clone()
    v = cache["v"].clone()
    k[:, pos] = k_new
    v[:, pos] = v_new
    valid = torch.arange(L, device=x.device) <= pos                  # [L]
    scores = torch.einsum("bhd,blhd->bhl", q.reshape(B, heads, hd),
                          k.reshape(B, L, heads, hd))
    scores = torch.where(valid[None, None, :], scores,
                         torch.tensor(float("-inf"), dtype=scores.dtype,
                                      device=x.device))
    align = torch.softmax(scores, dim=-1)
    y = torch.einsum("bhl,blhd->bhd", align,
                     v.reshape(B, L, heads, hd)).reshape(B, D)
    return y @ p["w_out"] + p["b_out"], {"k": k, "v": v, "len": pos + 1}


def mha_full(p: Params, x, lens=None):
    """Whole-sequence causal MHA with the same weights (the cache's
    equivalence check).  x [B, L, D] -> [B, L, D]."""
    heads = p["heads"]
    B, L, D = x.shape
    hd = D // heads
    q, k, v = torch.chunk((x * hd ** -0.5) @ p["w_qkv"] + p["b_qkv"], 3,
                          dim=-1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.reshape(B, L, heads, hd),
                          k.reshape(B, L, heads, hd))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    scores = torch.where(causal[None, None], scores,
                         torch.tensor(float("-inf"), dtype=scores.dtype,
                                      device=x.device))
    align = torch.softmax(scores, dim=-1)
    y = torch.einsum("bhqk,bkhd->bqhd", align,
                     v.reshape(B, L, heads, hd)).reshape(B, L, D)
    return y @ p["w_out"] + p["b_out"]


def init_block(gen: torch.Generator, input_size: int, hidden_size: int,
               proj: bool, ffn_size: int) -> Params:
    return {
        "attn": init_qkv(gen, input_size, hidden_size, proj),
        "ffn": init_ffn(gen, hidden_size, ffn_size, hidden_size),
        "ln1_scale": torch.ones(hidden_size),
        "ln1_bias": torch.zeros(hidden_size),
        "ln2_scale": torch.ones(hidden_size),
        "ln2_bias": torch.zeros(hidden_size),
    }


def attention_block(p: Params, x, lens, heads: int, ws: Optional[int] = None):
    """attn -> (residual if the widths match) -> LN -> FFN -> residual ->
    LN (SelfAttentionBlock / SelfLocalAttentionBlock, util.py:1777-1864)."""
    y = qkv_attention(p["attn"], x, lens, heads, ws)
    if x.shape[-1] == y.shape[-1]:
        y = x + y
    x = layer_norm(p["ln1_scale"], p["ln1_bias"], y)
    y = ffn(p["ffn"], x)
    return layer_norm(p["ln2_scale"], p["ln2_bias"], x + y)
