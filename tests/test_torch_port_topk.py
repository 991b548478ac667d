"""PyTorch port: K3's plain top-k twin against the Pallas kernel
(interpret mode) and jax.lax.top_k.  Values and indices are compared
exactly: the twin must reproduce the tie order (lower column first), NaN
ranking above +inf (reported as NaN), and all -inf rows yielding their
lowest columns in order."""

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
                                   (10, 5004, 17)])
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
