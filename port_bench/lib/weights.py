"""Random weights of a LAS configuration, made by the benchmark from the
seed on the device in two generator calls (one normal draw for every
matrix and vector, one uniform draw for the output bias), in the
parameter tree the program takes: the encoder family's tensors
(``port_bench/encoders``), then ``attention`` and ``decoder`` with
right-multiplied ``[in, out]`` matrices and LSTM gates in (i, f, g, o)
order, sized by the family's output width.

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

from port_bench import encoders


def _layout(cfg: dict) -> Tuple[List[tuple], int, int]:
    """[(path, shape, init)] in draw order, the vocabulary size and the
    encoder's output width.  ``init``: a normal std (float), "zeros",
    "ones", or ("forget", H) for zeros with the forget gate's H entries
    0.5."""
    family = encoders.of(cfg)
    dec, att = cfg["decoder"], cfg["attention"]
    Hd, E, A = dec["hidden_size"], dec["embed_dim"], att["attn_size"]
    V = cfg["vocab"]["max_num_words"] + 4
    enc_size = family.enc_size(cfg)
    out = list(family.layout(cfg))
    out += [(("attention", "w_enc"), (enc_size, A),
             math.sqrt(2.0 / (enc_size + A))),
            (("attention", "b_attn"), (A,), "zeros"),
            (("attention", "w_hidden"), (Hd, A), math.sqrt(2.0 / (Hd + A))),
            (("attention", "v"), (A,), 0.1),
            (("decoder", "embedding"), (V, E), 0.1)]
    d_in = E + enc_size
    out += [(("decoder", "cells", 0, "w_ih"), (d_in, 4 * Hd),
             math.sqrt(2.0 / (d_in + 4 * Hd))),
            (("decoder", "cells", 0, "w_hh"), (Hd, 4 * Hd),
             1.0 / math.sqrt(4 * Hd)),
            (("decoder", "cells", 0, "b_ih"), (4 * Hd,), ("forget", Hd)),
            (("decoder", "cells", 0, "b_hh"), (4 * Hd,), ("forget", Hd)),
            (("decoder", "proj_w"), (Hd + enc_size, V),
             math.sqrt(2.0 / (Hd + enc_size + V)))]
    return out, V, enc_size


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


def _check_init(path, init) -> None:
    """Refuses an ``init`` that is none of the four forms."""
    if isinstance(init, float) or init in ("zeros", "ones"):
        return
    if (isinstance(init, tuple) and len(init) == 2 and init[0] == "forget"
            and isinstance(init[1], int)):
        return
    raise ValueError(f"weights: {path} has init {init!r}; an init is a "
                     f"float std, \"zeros\", \"ones\" or (\"forget\", H)")


def make_params(cfg: dict, seed: int, device) -> dict:
    """The float32 parameter tree of ``cfg`` from ``seed`` on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    layout, V, enc_size = _layout(cfg)
    for path, _, init in layout:
        _check_init(path, init)
    n = sum(math.prod(s) for _, s, init in layout if isinstance(init, float))
    normal = torch.randn(n, generator=gen, device=device)
    Hd = cfg["decoder"]["hidden_size"]
    bound = 1.0 / math.sqrt(Hd + enc_size)
    proj_b = (torch.rand(V, generator=gen, device=device) * 2.0 - 1.0) * bound
    tree: dict = {}
    off = 0
    for path, shape, init in layout:
        if isinstance(init, float):
            size = math.prod(shape)
            t = normal[off:off + size].view(shape) * init
            off += size
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
            if isinstance(init, tuple):
                H = init[1]
                t[H:2 * H] = 0.5
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
