"""PyTorch port: BiLSTM core (K2's plain twin), encoder, encode prologue and
weight loading against the JAX package (CPU).

Tolerances: the recurrences are f32 on both sides with matmuls summed in
different orders (XLA:CPU vs torch); over a dozen steps the outputs agree
to ~1e-6, compared at atol 1e-5.  The encode prologue at the golden/small
configs (2 layers, a few dozen frames) is compared at atol 1e-5 as well.
Weight loading is exact.
"""

import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.ops import rnn as jrnn
from chinese_asr_tpu.ops.masks import length_mask as jlength_mask
from chinese_asr_tpu.ops.pallas import lstm as jpallas_lstm
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops import rnn as trnn
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint

from torch_port_util import (GOLD, N, T, golden_cfg, jax_params_numpy,
                             small_cfg)

ATOL = 1e-5


def _core_inputs(T_, B, H, lens, seed=0):
    rng = np.random.default_rng(seed)
    xg_f = rng.standard_normal((T_, B, 4 * H)).astype(np.float32)
    xg_b = rng.standard_normal((T_, B, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    m_f = (np.arange(T_)[:, None] < np.asarray(lens)[None, :]).astype(np.float32)
    return xg_f, xg_b, m_f, np.ascontiguousarray(m_f[::-1]), w_hh


@pytest.mark.parametrize("T_,B,H,lens", [(11, 3, 8, [11, 7, 4]),
                                         (9, 5, 16, [9, 9, 1, 3, 6])])
def test_plain_bilstm_core_matches_scan_and_pallas(T_, B, H, lens):
    args = _core_inputs(T_, B, H, lens)
    ref_scan = jrnn._bidir_core_scan(*map(jnp.asarray, args))
    ref_pal = jpallas_lstm.bidir_lstm_time_loop(*map(jnp.asarray, args),
                                                interpret=True)
    before = tlstm.launches
    got = tlstm.bidir_lstm_time_loop(*map(T, args))      # CPU -> twin
    assert tlstm.launches == before
    for g, rs, rp in zip(got, ref_scan, ref_pal):
        np.testing.assert_allclose(N(g), N(rs), rtol=0, atol=ATOL)
        np.testing.assert_allclose(N(g), N(rp), rtol=0, atol=ATOL)
    # masked tail steps emit exact zeros and freeze the carry
    ys_f = N(got[0])
    for b, l in enumerate(lens):
        assert np.abs(ys_f[l:, b]).max(initial=0.0) == 0.0


def test_bidir_layer_matches_jax():
    rng = np.random.default_rng(1)
    B, T_, D, H = 3, 10, 6, 8
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    p_f = jrnn.init_rnn_layer(k1, "LSTM", D, H)
    p_b = jrnn.init_rnn_layer(k2, "LSTM", D, H)
    x = rng.standard_normal((T_, B, D)).astype(np.float32)
    lens = np.array([10, 6, 2], np.int32)
    m = (np.arange(T_)[:, None] < lens[None, :]).astype(np.float32)
    y, s_f, s_b = jrnn._bidir_lstm_layer_tm(p_f, p_b, jnp.asarray(x),
                                            jnp.asarray(m))
    ty, ts_f, ts_b = trnn._bidir_lstm_layer_tm(
        tlas.params_from_numpy(jax_params_numpy(p_f)),
        tlas.params_from_numpy(jax_params_numpy(p_b)), T(x), T(m))
    np.testing.assert_allclose(N(ty), N(y), rtol=0, atol=ATOL)
    for a, b in zip(ts_f + ts_b, s_f + s_b):
        np.testing.assert_allclose(N(a), N(b), rtol=0, atol=ATOL)


def _encode_both(cfg_j, cfg_t, feats, lens, seed=0):
    params = jlas.init_params(jax.random.PRNGKey(seed), cfg_j)
    eb = jlas.encode(params, cfg_j, jnp.asarray(feats), jnp.asarray(lens))
    tparams = tlas.params_from_numpy(jax_params_numpy(params))
    teb = tlas.encode(tparams, cfg_t, T(feats), T(lens))
    return eb, teb


@pytest.mark.parametrize("which", ["golden", "small", "small_skip2_nores"])
def test_encode_matches_jax_every_field(which):
    if which == "golden":
        cj, ct = golden_cfg(jcfg), golden_cfg(tcfg)
    elif which == "small":
        cj, ct = small_cfg(jcfg), small_cfg(tcfg)
    else:
        kw = dict(skip_step=2, residual=False, num_layers=3)
        cj, ct = small_cfg(jcfg, **kw), small_cfg(tcfg, **kw)
    rng = np.random.default_rng(2)
    B, T_ = 3, 13
    feats = rng.standard_normal((B, T_, cj.audio.feat_dim)).astype(np.float32)
    lens = np.array([13, 8, 1], np.int32)
    feats *= (np.arange(T_)[None, :, None] < lens[:, None, None])
    eb, teb = _encode_both(cj, ct, feats, lens)
    for name in ("enc_out", "mask", "keys", "values"):
        a, b = N(getattr(teb, name)), N(getattr(eb, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
    assert len(teb.init_cell_state) == len(eb.init_cell_state)
    for (th, tc), (h, c) in zip(teb.init_cell_state, eb.init_cell_state):
        np.testing.assert_allclose(N(th), N(h), rtol=0, atol=ATOL)
        np.testing.assert_allclose(N(tc), N(c), rtol=0, atol=ATOL)


@pytest.mark.parametrize("which", ["golden", "flagship"])
def test_init_params_tree_matches_jax_layout(which):
    cj = golden_cfg(jcfg) if which == "golden" else jcfg.Config()
    ct = golden_cfg(tcfg) if which == "golden" else tcfg.Config()
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     jax.eval_shape(lambda: jlas.init_params(
                                         jax.random.PRNGKey(0), cj)))
    tp = tlas.init_params(ct, seed=0, device="cpu")
    tshapes = tlas.tree_map(lambda t: tuple(t.shape), tp)
    assert jax.tree_util.tree_structure(jshapes) == \
        jax.tree_util.tree_structure(tshapes)
    assert jax.tree_util.tree_leaves(jshapes) == \
        jax.tree_util.tree_leaves(tshapes)
    # seeded: same seed -> same weights; pad embedding row is zero
    tp2 = tlas.init_params(ct, seed=0, device="cpu")
    torch.testing.assert_close(tp["decoder"]["proj_w"],
                               tp2["decoder"]["proj_w"], rtol=0, atol=0)
    assert float(tp["decoder"]["embedding"][ct.vocab.pad].abs().max()) == 0.0
    w = tp["encoder"]["layers"][0]["fwd"]["w_hh"]           # [H, 4H]
    torch.testing.assert_close(w @ w.T, torch.eye(w.shape[0]),
                               rtol=0, atol=1e-5)           # orthogonal


def test_golden_checkpoint_loads_exactly(tmp_path):
    path = os.path.join(GOLD, "model.ckpt")
    payload = load_checkpoint(path)
    with open(path, "rb") as f:
        raw = pickle.load(f)["params"]
    tp = tlas.params_from_numpy(payload["params"], device="cpu")
    flat_raw = jax.tree_util.tree_leaves(raw)
    flat_t = jax.tree_util.tree_leaves(tlas.tree_map(N, tp))
    assert len(flat_raw) == len(flat_t) == 27
    for a, b in zip(flat_raw, flat_t):
        np.testing.assert_array_equal(a, b)
    bad = tmp_path / "other.ckpt"
    bad.write_bytes(pickle.dumps({"format": "something.else"}))
    with pytest.raises(ValueError):
        load_checkpoint(str(bad))


def test_reference_torch_checkpoint_import_matches_jax(tmp_path):
    """A reference-schema .ckpt written by the JAX package's exporter loads
    into the port with the same weights the JAX importer gives."""
    cj, ct = golden_cfg(jcfg), golden_cfg(tcfg)
    params = jlas.init_params(jax.random.PRNGKey(4), cj)
    path = str(tmp_path / "ref.ckpt")
    jlas.save_torch_checkpoint(path, params, cj)
    want = jax_params_numpy(jlas.load_torch_checkpoint(path, cj))
    got = tlas.load_torch_checkpoint(path, ct, device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(tlas.tree_map(N, got))):
        np.testing.assert_array_equal(a, b)
        assert b.flags["C_CONTIGUOUS"]


def test_length_and_softmax_masks_match_jax():
    from chinese_asr_tpu.ops import masks as jm
    from chinese_asr_tpu_torch.ops import masks as tm
    lens = np.array([0, 3, 5], np.int32)
    np.testing.assert_array_equal(N(tm.length_mask(T(lens), 5)),
                                  N(jlength_mask(jnp.asarray(lens), 5)))
    np.testing.assert_array_equal(N(tm.softmax_mask(T(lens), 5)),
                                  N(jm.softmax_mask(jnp.asarray(lens), 5)))
