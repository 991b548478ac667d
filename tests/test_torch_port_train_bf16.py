"""PyTorch port, bf16 mixed-precision training (``train.compute_dtype=
"bfloat16"``) against the JAX package's, on the CPU at tests/test_train.py's
SMALL config, from the same seeded numpy params and batches.

The port runs with CPU tensors, so the recurrence takes K2-bf16's plain twin
forward and K2-bwd-bf16's plain twin backward; JAX runs its bf16
``lax.scan`` and its VJP.  The two round at different points (JAX rounds
every op to bf16, the port computes each step in f32 and rounds the carries,
the kept gates and the stored cotangents), so they are compared at bf16
tolerances:

- the recurrence's dxg against ``jax.vjp`` of the bf16 scan: 1.6e-2 of each
  output's largest magnitude (K2-bf16's forward bound in
  tests/test_torch_port_bf16.py); measured 7.2e-3 and 8.2e-3;
- dW_hh: the port's error against a float64 VJP of the same bf16 inputs is
  no larger than JAX's, whose reverse scan sums it in bf16 over T steps
  (measured 4.8e-3 against 1.3e-2 of the largest magnitude;
  tests/torch_port_bf16_gap.py);
- the train step: loss within 2e-2 absolute (measured 7.6e-5), grad norm
  within 5 % (measured 0.07 %), each gradient leaf's cosine similarity with
  JAX's >= 0.98 (measured >= 0.99978), but for the two leaves where JAX's
  bf16 gradient is itself far from its f32 one (attention b_attn 0.970,
  w_hidden 0.983 against JAX's f32; the port's 0.956 and 0.984 against
  JAX's bf16, 0.998 and 0.994 against JAX's f32): those are held to JAX's
  f32 gradient instead, as the test says.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.ops.rnn import _bidir_core_scan
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train import step as tstep

from test_torch_port_train import (both_params, jbatch, make_batch, small,
                                   tbatch)
from torch_port_util import N
from torch_port_bf16_gap import bf16_case, gap

BF = dict(compute_dtype="bfloat16")
TOL_DXG = 1.6e-2


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# --------------------------------------------------------------------------
# (a) the recurrence's backward against jax.vjp of the bf16 scan
# --------------------------------------------------------------------------
def test_bf16_twin_matches_jax_vjp():
    """T=12, B=3, H=16, ragged prefix masks, nonzero final-state
    cotangents: the port's bf16 gradients through ``bidir_lstm`` against
    ``jax.vjp`` of the bf16 ``_bidir_core_scan``."""
    prim, cot = bf16_case(12, 3, 16, seed=0)
    _, vjp = jax.vjp(_bidir_core_scan,
                     *(jnp.asarray(a, jnp.bfloat16) for a in prim))
    want = vjp(tuple(jnp.asarray(a, jnp.bfloat16) for a in cot))
    ins = [torch.tensor(a, dtype=torch.bfloat16).requires_grad_(i in (0, 1, 4))
           for i, a in enumerate(prim)]
    out = tlstm.bidir_lstm(*ins)
    got = torch.autograd.grad(out, [ins[0], ins[1], ins[4]],
                              [torch.tensor(a, dtype=torch.bfloat16)
                               for a in cot])
    assert all(g.dtype == torch.bfloat16 for g in got)
    for g, i in zip(got[:2], (0, 1)):
        assert _rel(N(g.float()), np.asarray(want[i], np.float32)) \
            <= TOL_DXG


def test_bf16_dw_no_farther_from_f64_than_jax():
    """dW_hh accumulated in f32 and rounded once (the port) against JAX's
    bf16 running sum over the T steps, both held to a float64 VJP of the
    same bf16 inputs."""
    g = gap(12, 3, 16, seed=0)
    assert g["port"]["dw"] <= g["jax"]["dw"], g
    assert g["port"]["dxg"] <= 1e-2 and g["jax"]["dxg"] <= 1e-2, g


# --------------------------------------------------------------------------
# (b) the train step in bf16 against JAX's
# --------------------------------------------------------------------------
def test_bf16_train_step_matches_jax():
    """One bf16 step from the same params and batch: loss and grad norm
    against JAX's bf16 ``value_and_grad`` of its ``loss_fn``; every gradient
    leaf against JAX's by cosine; the port's gradients come back float32.

    A leaf passes with cosine >= 0.98 against JAX's bf16 gradient, or, where
    JAX's bf16 gradient is itself farther from its f32 one (the attention's
    w_hidden and b_attn: sums of many cancelling terms, each op rounded to
    bf16; cosine 0.92-0.98 against f32 over three seeds), with a cosine
    against JAX's f32 gradient no lower than 0.98 and JAX bf16's own."""
    cfg_j, cfg_t = small(jcfg, **BF), small(tcfg, **BF)
    pj, pt = both_params(small(jcfg), seed=3)
    nb = make_batch(cfg_j, seed=11)

    def jax_grads(cfg):
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: jstep.loss_fn(p, cfg, b), has_aux=True))(
                pj, jbatch(nb))
        return float(loss), toptim.flatten(
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), g))

    lj, gj = jax_grads(cfg_j)
    _, gj32 = jax_grads(small(jcfg))
    gnorm_j = float(np.sqrt(sum((v ** 2).sum() for v in gj.values())))
    tx = toptim.make_optimizer(cfg_t.train)
    _, _, mt = tstep.train_step(pt, tx.init(pt), cfg_t, tx, tbatch(nb))
    assert abs(float(mt["loss"]) - lj) <= 2e-2
    assert float(mt["grad_norm"]) == pytest.approx(gnorm_j, rel=5e-2)
    flat = {n: t.clone().requires_grad_(True)
            for n, t in toptim.flatten(pt).items()}
    loss, _ = tstep.loss_fn(toptim.unflatten(pt, flat), cfg_t, tbatch(nb))
    assert loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, list(flat.values()))

    def cos(a, b):
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    for n, gt in zip(flat, grads):
        assert gt.dtype == torch.float32, n
        a = N(gt).ravel().astype(np.float64)
        b16, b32 = gj[n].ravel(), gj32[n].ravel()
        ok16 = cos(a, b16) >= 0.98
        ok32 = cos(a, b32) >= max(0.98, cos(b16, b32))
        assert ok16 or ok32, (n, cos(a, b16), cos(a, b32), cos(b16, b32))


# --------------------------------------------------------------------------
# (c) tests/test_train.py::test_train_step_mixed_precision_bf16, on the port
# --------------------------------------------------------------------------
def test_bf16_train_step_tracks_f32_and_overfits():
    """The first bf16 loss within 0.05 of the f32 one; 30 bf16 steps
    overfit the tiny batch to under 0.7x the first loss; master params and
    optimizer state stay float32."""
    cfg32 = small(tcfg, l2_decay=0.0)
    cfg = cfg32.with_("train", **BF)
    _, pt = both_params(small(jcfg))
    tx = toptim.make_optimizer(cfg.train)
    ot = tx.init(pt)
    b = tbatch(make_batch(cfg, ragged=False))
    _, _, m16 = tstep.train_step(pt, ot, cfg, tx, b)
    _, _, m32 = tstep.train_step(pt, ot, cfg32, tx, b)
    assert abs(float(m16["loss"]) - float(m32["loss"])) < 0.05
    losses = []
    for _ in range(30):
        pt, ot, m = tstep.train_step(pt, ot, cfg, tx, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses[-1]) and losses[-1] < 0.7 * losses[0], losses
    assert all(t.dtype == torch.float32
               for t in toptim.flatten(pt).values())
    assert all(v.dtype == torch.float32 for v in ot.values()
               if v.is_floating_point())


# --------------------------------------------------------------------------
# (d) remat in bf16
# --------------------------------------------------------------------------
def test_bf16_remat_matches_no_remat():
    """train.remat recomputes each decoder step in bf16 exactly as the
    forward ran it: the loss and every gradient are the same."""
    cfg = small(tcfg, **BF)
    _, pt = both_params(small(jcfg), seed=2)
    b = tbatch(make_batch(cfg, seed=9))
    out = []
    for remat in (False, True):
        c = cfg.with_("train", remat=remat)
        flat = {n: t.clone().requires_grad_(True)
                for n, t in toptim.flatten(pt).items()}
        loss, _ = tstep.loss_fn(toptim.unflatten(pt, flat), c, b)
        out.append((loss.item(),
                    torch.autograd.grad(loss, list(flat.values()))))
    assert out[0][0] == out[1][0]
    for g0, g1 in zip(out[0][1], out[1][1]):
        assert torch.equal(g0, g1)
