"""Random weights of a LAS configuration, made by the benchmark from the
seed on the device in two generator calls (one normal draw for every
matrix and vector, one uniform draw for the output bias), in the
parameter tree the program takes: ``encoder/layers[i]/{fwd,bwd}``,
``attention``, ``decoder`` with right-multiplied ``[in, out]`` matrices
and LSTM gates in (i, f, g, o) order.

Scales follow the reference's initialisers: xavier-normal input and
projection matrices, recurrent matrices at the scale of an orthogonal
matrix's entries, forget-gate biases 0.5, embedding N(0, 0.1) with the
pad row zero, attention ``v`` N(0, 0.1), output bias U(-1/sqrt(in),
1/sqrt(in)).  The same tensors go to the program and to the reference.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch


def _layout(cfg: dict) -> Tuple[List[tuple], int]:
    """[(path, shape, std or None for zeros, forget-bias H or 0)] and the
    vocabulary size."""
    enc, dec, att = cfg["encoder"], cfg["decoder"], cfg["attention"]
    a = cfg["audio"]
    D = a["n_mels"] * 3 * 3
    H, Hd, E, A = enc["hidden_size"], dec["hidden_size"], dec["embed_dim"], \
        att["attn_size"]
    V = cfg["vocab"]["max_num_words"] + 4
    enc_size = 2 * H
    out = []
    for i in range(enc["num_layers"]):
        d_in = D if i == 0 else enc_size
        for d in ("fwd", "bwd"):
            pre = ("encoder", "layers", i, d)
            out += [(pre + ("w_ih",), (d_in, 4 * H),
                     math.sqrt(2.0 / (d_in + 4 * H)), 0),
                    (pre + ("w_hh",), (H, 4 * H), 1.0 / math.sqrt(4 * H), 0),
                    (pre + ("b_ih",), (4 * H,), None, H),
                    (pre + ("b_hh",), (4 * H,), None, H)]
    out += [(("attention", "w_enc"), (enc_size, A),
             math.sqrt(2.0 / (enc_size + A)), 0),
            (("attention", "b_attn"), (A,), None, 0),
            (("attention", "w_hidden"), (Hd, A), math.sqrt(2.0 / (Hd + A)), 0),
            (("attention", "v"), (A,), 0.1, 0),
            (("decoder", "embedding"), (V, E), 0.1, 0)]
    d_in = E + enc_size
    out += [(("decoder", "cells", 0, "w_ih"), (d_in, 4 * Hd),
             math.sqrt(2.0 / (d_in + 4 * Hd)), 0),
            (("decoder", "cells", 0, "w_hh"), (Hd, 4 * Hd),
             1.0 / math.sqrt(4 * Hd), 0),
            (("decoder", "cells", 0, "b_ih"), (4 * Hd,), None, Hd),
            (("decoder", "cells", 0, "b_hh"), (4 * Hd,), None, Hd),
            (("decoder", "proj_w"), (Hd + enc_size, V),
             math.sqrt(2.0 / (Hd + enc_size + V)), 0)]
    return out, V


def _put(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= k:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
        node[path[-1]] = value
    else:
        node[path[-1]] = value


def make_params(cfg: dict, seed: int, device) -> dict:
    """The float32 parameter tree of ``cfg`` from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    layout, V = _layout(cfg)
    n = sum(math.prod(s) for _, s, std, _ in layout if std is not None)
    normal = torch.randn(n, generator=gen, device=device)
    Hd = cfg["decoder"]["hidden_size"]
    enc_size = 2 * cfg["encoder"]["hidden_size"]
    bound = 1.0 / math.sqrt(Hd + enc_size)
    proj_b = (torch.rand(V, generator=gen, device=device) * 2.0 - 1.0) * bound
    tree: dict = {}
    off = 0
    for path, shape, std, forget in layout:
        if std is None:
            t = torch.zeros(shape, device=device)
            if forget:
                t[forget:2 * forget] = 0.5
        else:
            size = math.prod(shape)
            t = normal[off:off + size].view(shape) * std
            off += size
        _put(tree, path, t)
    tree["decoder"]["embedding"][cfg["vocab"]["pad"]] = 0.0
    tree["decoder"]["proj_b"] = proj_b
    return tree


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def served(tree, dtype):
    """The weights as a deployment in ``dtype`` serves them."""
    return tree_map(lambda t: t.to(dtype), tree)
