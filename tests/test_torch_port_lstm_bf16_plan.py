"""K2-bwd-bf16's pass 1 as three stages (``ops/cuda/lstm.py``: the rebuild
of hs, the f32 product hs @ W_hh, the activation and c's roll; on the card
two kernels of ``csrc/lstm_bwd.cu`` around a cuBLAS bmm) and the bf16
kernels' cluster plan, on the CPU.

The staged plain pass 1 is held against the intermediates of the one-loop
pass 1 of ``bidir_lstm_time_loop_bwd_plain`` (``bwd_pass1_plain``), and,
composed with its pass 2 (``bwd_pass2_plain``), against the whole plain
backward and JAX's VJP of the bf16 (and f32) ``_bidir_core_scan``, in bf16
and f32, with random non-prefix masks, at T = 0, B = 1 and B not a
multiple of 16.  Tolerances:

- hs: exact (both rebuild it from ys and 0/1 masks the same way);
- the gates and c: the staged product sums hs @ W_hh as one batched
  product, the loop one step at a time, so their f32 sums may differ in
  the last bits: f32 1e-5 of max(1, |ref|); bf16, where a sum within an
  f32 rounding of a bf16 boundary lands one bf16 ulp (2^-8 relative)
  apart and c carries it on, 3e-2 (chip_smoke.py's TOL_LSTM_BWD_BF16);
- the composed backward against the plain one: the same bounds; against
  JAX's bf16 VJP, 1.6e-2 of each dxg's largest magnitude
  (tests/test_torch_port_train_bf16.py's TOL_DXG); against JAX's f32 VJP,
  1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu.ops.rnn import _bidir_core_scan
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
TOL_JAX = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (T, B, H): the JAX twin's test shape, B not a multiple of 16, B = 1,
# T = 0, and a hidden size of the cluster kernels
SHAPES = [(12, 3, 16), (9, 17, 16), (7, 1, 32), (0, 4, 16), (5, 2, 64)]
DTYPES = [torch.float32, torch.bfloat16]


def _case(T, B, H, seed, dt):
    """numpy-seeded operands of the backward in ``dt``: gates, W_hh,
    random non-prefix masks (row 0 never masked), ys from the forward
    twin, cotangents of ys and of the final state."""
    rng = np.random.RandomState(seed)
    m = (rng.rand(2, T, B) > 0.3).astype(np.float32)
    m[:, :, 0] = 1.0
    prim = [rng.randn(T, B, 4 * H), rng.randn(T, B, 4 * H), m[0], m[1],
            rng.randn(2, H, 4 * H) / np.sqrt(H)]
    prim = [torch.tensor(a, dtype=torch.float32).to(dt) for a in prim]
    ys_f, ys_b, _, _ = tlstm.bidir_lstm_time_loop_plain(*prim)
    cot = [torch.tensor(a, dtype=torch.float32).to(dt)
           for a in (rng.randn(T, B, H), rng.randn(T, B, H),
                     rng.randn(2, B, H), rng.randn(2, B, H))]
    return tuple(prim) + (ys_f, ys_b) + tuple(cot)


def _amax(t) -> float:
    return float(t.float().abs().max()) if t.numel() else 0.0


def _rel(got, ref) -> float:
    """The largest error of each pair relative to max(1, its scale)."""
    return max(_amax(a.float() - b.float()) / max(1.0, _amax(b))
               for a, b in zip(got, ref))


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_staged_pass1_matches_pass1_intermediates(T, B, H, dt):
    args = _case(T, B, H, seed=T + 7 * B + H, dt=dt)
    hs, acts, cs = tlstm.bwd_pass1_plain(*args[:7])
    s_hs, s_acts, s_cs = tlstm.bwd_pass1_staged_plain(*args[:7])
    assert s_hs.shape == (2, T, B, H) and s_acts.shape == (2, T, B, 4 * H)
    assert s_cs.shape == (2, T, B, H)
    assert all(a.dtype == dt for a in (s_hs, s_acts, s_cs))
    assert torch.equal(s_hs.float(), hs)
    assert _rel([s_acts, s_cs], [acts, cs]) <= TOL[dt]
    # each stage alone: (b) is f32 however the operands are typed
    pre = tlstm.pre_gates(s_hs, args[4])
    assert pre.dtype == torch.float32 and pre.shape == (2, T, B, 4 * H)
    assert torch.equal(tlstm.rebuild_hs(args[5], args[6], args[2], args[3]),
                       s_hs)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("T,B,H", SHAPES)
def test_staged_backward_matches_plain_and_jax_vjp(T, B, H, dt):
    """Staged pass 1 + pass 2 + dW_hh against the one-loop plain backward
    and against ``jax.vjp`` of ``_bidir_core_scan`` in the same type."""
    args = _case(T, B, H, seed=3 * T + B + H, dt=dt)
    got = tlstm.bwd_pass2_plain(args[2], args[3], args[4], *args[7:],
                                *(a.float() for a in
                                  tlstm.bwd_pass1_staged_plain(*args[:7])))
    ref = tlstm.bidir_lstm_time_loop_bwd_plain(*args)
    assert all(a.dtype == dt and a.shape == b.shape
               for a, b in zip(got, ref))
    assert _rel(got, ref) <= TOL[dt]
    if T == 0:
        assert all(_amax(a) == 0.0 for a in got)
        return
    jdt = JDT[dt]
    _, vjp = jax.vjp(_bidir_core_scan,
                     *(jnp.asarray(a.float().numpy(), jdt)
                       for a in args[:5]))
    want = vjp(tuple(jnp.asarray(a.float().numpy(), jdt)
                     for a in args[7:]))
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w, np.float32)
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= TOL_JAX[dt], err


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H", [16, 64, 128, 192, 256])
def test_cluster_plan_rule(H, dt):
    """``cluster_shape``, the Python mirror of csrc/tc.cuh's rule (on the
    card ``plan`` and ``bwd_plan`` report the same rows, CTAs and
    clusters): bf16 runs 16 rows a cluster at every B, 8 CTAs while both
    directions' clusters of 8 fit the card at once (B <= 112), else 4, so
    that B = 128 is 16 clusters of 4; f32 keeps clusters of 8 and 32 rows
    from B = 113 on; other H take the simple kernel."""
    for B in range(1, 300):
        shape = tlstm.cluster_shape(B, H, dt)
        if H == 16:
            assert shape is None
            continue
        fits = B <= 112
        if dt == torch.bfloat16:
            assert shape["rows"] == 16
            assert shape["ctas"] == (8 if fits else 4)
        else:
            assert shape["ctas"] == 8
            assert shape["rows"] == (16 if fits else 32)
        rows = shape["rows"]
        assert shape["clusters"] == 2 * -(-B // rows)
        assert (shape["clusters"] // 2 - 1) * rows < B
    if H == 256 and dt == torch.bfloat16:
        assert tlstm.cluster_shape(128, H, dt) == dict(rows=16, ctas=4,
                                                       clusters=16)
        assert tlstm.cluster_shape(32, H, dt) == dict(rows=16, ctas=8,
                                                      clusters=4)
