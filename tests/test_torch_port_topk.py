"""PyTorch port: K3's plain top-k twin against the Pallas kernel
(interpret mode) and jax.lax.top_k, and K4's fused twin against
``top_k_fused`` (interpret mode) and the beam's unfused stage 1.  K3's
values and indices are compared exactly: the twin must reproduce the tie
order (lower column first), NaN ranking above +inf (reported as NaN),
and all -inf rows yielding their lowest columns in order.  K4's values
agree to the logsumexp's summation order (1e-5)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chinese_asr_tpu.ops.pallas import topk as jtopk
from chinese_asr_tpu_torch.ops.cuda import topk as ttopk

from torch_port_util import N, T


def _edge_rows(R, V, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, V)).astype(np.float32)
    x[0, [3, 17, 29, V - 1]] = 7.0              # 4-way tie at the top
    x[1, 11] = np.nan
    x[2, 5] = np.inf
    x[2, 9] = np.nan                            # NaN above +inf
    x[3, :] = -np.inf                           # all -inf (beam step 0)
    x[4, :] = 1.25                              # all tied
    x[5, ::2] = -np.inf
    x[6, :] = np.nan
    x[7, -4:] = 9.0                             # winners in the ragged tail
    x[8] = np.round(x[8])                       # many small-integer ties
    return x


def _assert_same(got, want):
    np.testing.assert_array_equal(N(got[0]), N(want[0]))      # NaN == NaN
    np.testing.assert_array_equal(N(got[1]), N(want[1]))


@pytest.mark.parametrize("R,V,k", [(12, 40, 4), (16, 300, 17), (9, 1000, 6),
                                   (10, 5004, 17), (10, 5004, 20)])
@pytest.mark.parametrize("grouped", ["0", "1"])
def test_plain_top_k_matches_pallas_exactly(R, V, k, grouped, monkeypatch):
    monkeypatch.setenv("CHINESE_ASR_TOPK_GROUPED", grouped)
    x = _edge_rows(R, V, seed=R + V + k)
    want = jtopk.top_k(jnp.asarray(x), k, interpret=True)
    got = ttopk.top_k(T(x), k)                        # CPU -> the twin
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    _assert_same(got, want)
    assert N(got[1])[3].tolist() == list(range(k))
    assert N(got[1])[0, :4].tolist() == [3, 17, 29, V - 1]


def test_plain_top_k_matches_lax_top_k_without_nan():
    rng = np.random.default_rng(0)
    x = np.round(rng.standard_normal((64, 777)) * 4).astype(np.float32)
    x[5] = -np.inf
    want = jax.lax.top_k(jnp.asarray(x), 9)
    _assert_same(ttopk.top_k(T(x), 9), want)


def _fused_case(R, V, seed):
    rng = np.random.default_rng(seed)
    logit = (3 * rng.standard_normal((R, V))).astype(np.float32)
    bias = (-20 * rng.random((R, 1))).astype(np.float32)
    bias[1::4] = -np.inf                        # the beam's step-0 rows
    logit[2, V // 3] = np.nan                   # poisons row 2's lse
    logit[5, 3] = np.nan                        # ...row 5 is -inf anyway
    logit[6, 11] = np.inf                       # lse NaN as well
    logit[7] = np.round(logit[7])               # exact ties
    logit[8, -3:] = 40.0                        # winners in the ragged tail
    return logit, bias


@pytest.mark.parametrize("R,V,k,temp", [(12, 40, 4, 1.0), (16, 300, 17, 0.7),
                                        (10, 5004, 17, 1.0),
                                        (9, 5004, 5, 1.3)])
def test_plain_fused_top_k_matches_pallas(R, V, k, temp):
    """top_k_fused's twin against the Pallas kernel in interpret mode:
    NaN rows read NaN, -inf-bias rows give their lowest columns at -inf
    (even over a NaN logit), values agree to f32 summation order (1e-5)
    and indices exactly on rows whose values are that far apart."""
    logit, bias = _fused_case(R, V, seed=R * V + k)
    want = jtopk.top_k_fused(jnp.asarray(logit), jnp.asarray(bias), k,
                             temp, interpret=True)
    vals, idx = ttopk.top_k_fused(T(logit), T(bias), k, temp)   # the twin
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    wv, wi, gv, gi = N(want[0]), N(want[1]), N(vals), N(idx)
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
    np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
    fin = np.isfinite(wv)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=1e-5)
    with np.errstate(invalid="ignore"):         # -inf - -inf rows
        sep = (np.diff(wv, axis=1) < -1e-5).all(axis=1) | ~fin.any(axis=1)
    np.testing.assert_array_equal(gi[sep], wi[sep])
    assert np.isnan(gv[[2, 6]]).all() and np.isneginf(gv[1::4]).all()
    assert gi[5].tolist() == list(range(k))
    assert gi[8, :3].tolist() == [V - 3, V - 2, V - 1]


def test_fused_twin_equals_unfused_composition():
    """With finite logits the twin is the beam's unfused stage 1 (the
    logp transform, -inf rows, K3's twin) up to the logsumexp's order."""
    rng = np.random.default_rng(4)
    logit = T((4 * rng.standard_normal((32, 500))).astype(np.float32))
    bias = T((-10 * rng.random((32, 1))).astype(np.float32))
    bias[8:] = float("-inf")
    got = ttopk.top_k_fused_plain(logit, bias, 9, 1.0)
    lp = logit - torch.logsumexp(logit, dim=1, keepdim=True) + bias
    want = ttopk.top_k_plain(lp, 9)
    assert torch.equal(got[1], want[1])
    assert torch.allclose(got[0][:8], want[0][:8], rtol=0, atol=1e-5)
    assert torch.equal(got[0][8:], want[0][8:])


def test_fused_wrapper_validates_and_never_falls_back():
    logit, bias = torch.randn(4, 10), torch.zeros(4, 1)
    with pytest.raises(ValueError):
        ttopk.top_k_fused(logit, bias, 11)
    with pytest.raises(ValueError):
        ttopk.top_k_fused(logit, bias[:, 0], 2)           # bias [R] not [R, 1]
    before = (ttopk.launches, ttopk.fused_launches)
    ttopk.top_k_fused(logit, bias, 3)
    assert (ttopk.launches, ttopk.fused_launches) == before   # twin: no launch
    with pytest.raises(ValueError):
        ttopk.top_k_fused(torch.empty(4, 10, device="meta"),
                          torch.empty(4, 1, device="meta"), 3)


def test_beam_fused_logp_matches_default(monkeypatch):
    """The opt-in fused stage 1 (CHINESE_ASR_PALLAS_FUSED) reproduces the
    default path within 1e-6, as tests/test_beam.py pins for JAX; the
    argument's None reads the variable."""
    from chinese_asr_tpu_torch import config as tcfg
    from chinese_asr_tpu_torch.decode import beam as tbeam
    from chinese_asr_tpu_torch.models import las as tlas
    from torch_port_util import small_cfg
    cfg = small_cfg(tcfg)
    params = tlas.init_params(cfg, 9, "cpu")
    rng = np.random.default_rng(3)
    feats = T(rng.standard_normal((3, 11, cfg.audio.feat_dim))
              .astype(np.float32))
    lens = T(np.array([11, 7, 4], np.int32))
    r0 = tbeam.beam_decode(params, cfg, 4, feats, lens, fused_logp=False)
    r1 = tbeam.beam_decode(params, cfg, 4, feats, lens, fused_logp=True)
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", "1")
    assert tbeam.use_fused_logp()
    r2 = tbeam.beam_decode(params, cfg, 4, feats, lens)
    for a, b, c in zip(r0, r1, r2):
        np.testing.assert_allclose(N(a), N(b), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(N(b), N(c))
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", "0")
    assert not tbeam.use_fused_logp()


def test_top_k_wrapper_validates_and_never_falls_back():
    x = torch.randn(4, 10)
    with pytest.raises(ValueError):
        ttopk.top_k(x, 11)
    with pytest.raises(ValueError):
        ttopk.top_k(x[0], 2)
    before = ttopk.launches
    ttopk.top_k(x, 3)
    assert ttopk.launches == before                  # the twin is no launch
    # a tensor on neither the CPU nor a GPU is refused, not computed
    with pytest.raises(ValueError):
        ttopk.top_k(torch.empty(4, 10, device="meta"), 3)
