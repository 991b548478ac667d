"""How far the bf16 recurrence's backward is from the exact VJP: the
port's (K2-bwd-bf16's plain twin, through ``bidir_lstm``'s autograd) and
the JAX package's (``jax.vjp`` of its bf16 ``_bidir_core_scan``, whose
reverse scan carries the ``w_hh`` cotangent as a bf16 running sum), each
against a float64 VJP of the same bf16-valued inputs.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_port_bf16_gap.py \
        [T,B,H ...]

prints, for each shape, the largest error of dW_hh and of dxg relative to
the float64 output's largest magnitude.  tests/test_torch_port_train_bf16.py
asserts at T=12, B=3, H=16 that the port's dW_hh is no farther from float64
than JAX's.
"""

import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu.ops.rnn import _bidir_core_scan
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm


def bf16_case(T, B, H, seed):
    """Gates, W_hh, ragged prefix masks (the backward direction's flipped)
    and cotangents, each rounded to bf16 and held as float32 numpy."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    m_f = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    prim = [rng.randn(T, B, 4 * H), rng.randn(T, B, 4 * H), m_f,
            m_f[::-1].copy(), rng.randn(2, H, 4 * H) / np.sqrt(H)]
    cot = [rng.randn(T, B, H), rng.randn(T, B, H), rng.randn(2, B, H),
           rng.randn(2, B, H)]

    def bf(a):
        return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    return [bf(a) for a in prim], [bf(a) for a in cot]


def scan64(xg_f, xg_b, m_f, m_b, w):
    """The recurrence in float64 (JAX's step formulas), for autograd."""
    T, B, H4 = xg_f.shape
    ys, hT, cT = [], [], []
    for d, (xg, m) in enumerate(((xg_f, m_f), (xg_b, m_b))):
        h = c = xg.new_zeros((B, H4 // 4))
        out = []
        for t in range(T):
            i, f, g, o = torch.chunk(xg[t] + h @ w[d], 4, dim=-1)
            c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h2 = torch.sigmoid(o) * torch.tanh(c2)
            mt = m[t][:, None]
            y = h2 * mt
            out.append(y)
            h = y + (1.0 - mt) * h
            c = mt * c2 + (1.0 - mt) * c
        ys.append(torch.stack(out))
        hT.append(h)
        cT.append(c)
    return ys[0], ys[1], torch.stack(hT), torch.stack(cT)


def vjps(prim, cot):
    """(dxg_f, dxg_b, dW_hh) of the port (bf16), of JAX (bf16) and of the
    float64 reference, as float64 numpy."""
    ins = [torch.tensor(a, dtype=torch.bfloat16).requires_grad_(i in (0, 1, 4))
           for i, a in enumerate(prim)]
    out = tlstm.bidir_lstm(*ins)
    port = torch.autograd.grad(out, [ins[0], ins[1], ins[4]],
                               [torch.tensor(a, dtype=torch.bfloat16)
                                for a in cot])
    _, vjp = jax.vjp(_bidir_core_scan,
                     *(jnp.asarray(a, jnp.bfloat16) for a in prim))
    g = vjp(tuple(jnp.asarray(a, jnp.bfloat16) for a in cot))
    ref_in = [torch.tensor(a, dtype=torch.float64).requires_grad_(
        i in (0, 1, 4)) for i, a in enumerate(prim)]
    ref = torch.autograd.grad(scan64(*ref_in), [ref_in[0], ref_in[1],
                                                ref_in[4]],
                              [torch.tensor(a, dtype=torch.float64)
                               for a in cot])
    def as64(a):
        return np.asarray(a.float() if isinstance(a, torch.Tensor)
                          else a.astype(jnp.float32), np.float64)

    return ([as64(a) for a in port], [as64(g[i]) for i in (0, 1, 4)],
            [a.numpy() for a in ref])


def rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def gap(T, B, H, seed=0):
    """{"port"|"jax": {"dw": err, "dxg": err}}, each error relative to the
    float64 output's largest magnitude."""
    port, jx, ref = vjps(*bf16_case(T, B, H, seed))
    return {name: dict(dw=rel(v[2], ref[2]),
                       dxg=max(rel(v[0], ref[0]), rel(v[1], ref[1])))
            for name, v in (("port", port), ("jax", jx))}


if __name__ == "__main__":
    # the default: the tests' shape, and the flagship encoder layer's
    shapes = sys.argv[1:] or ["12,3,16", "332,32,256"]
    for s in shapes:
        T, B, H = map(int, s.split(","))
        print(f"T={T} B={B} H={H}: {gap(T, B, H)}", flush=True)
