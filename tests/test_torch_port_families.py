"""PyTorch port, the encoder families: every op of ``ops/conv.py``,
``ops/self_attention.py`` and ``ops/conv_lstm.py``, the GRU / RNN /
unidirectional / ``local_rnn`` paths of ``ops/rnn.py``, each of the 11
non-LSTM encoder families, the reference state-dict import and one
BatchNorm train step, against the JAX package on the same seeded numpy
inputs (params carried by ``params_from_numpy``; JAX on the CPU).

Tolerances (float32 on both sides, sums in other orders): each op 1e-5
max abs error; BatchNorm's recorded (mean, var, n) 1e-5; each family's
encoder output 1e-4 (a few layers of convs, recurrences and softmaxes
compound the rounding), its lens exactly; padding rows exactly 0; the
state-dict import bit for bit; the BN train step's loss 1e-5 relative,
params 2e-5 absolute and its running stats as tests/test_train.py
checks them (1e-5 relative, 1e-6 absolute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.models import encoder as jenc
from chinese_asr_tpu.models import encoders_extra as jextra
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.ops import conv as jconv
from chinese_asr_tpu.ops import conv_lstm as jcl
from chinese_asr_tpu.ops import rnn as jrnn
from chinese_asr_tpu.ops import self_attention as jsa
from chinese_asr_tpu.train import optim as joptim
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data.dataset import Batch as TBatch
from chinese_asr_tpu_torch.models import encoder as tenc
from chinese_asr_tpu_torch.models import encoders_extra as textra
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops import conv as tconv
from chinese_asr_tpu_torch.ops import conv_lstm as tcl
from chinese_asr_tpu_torch.ops import rnn as trnn
from chinese_asr_tpu_torch.ops import self_attention as tsa
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train import step as tstep

from torch_port_util import N, T, jax_params_numpy

ATOL_OP = 1e-5
ATOL_ENC = 1e-4

FAMILIES = ["CNN1D", "CNN2D", "GRU", "RNN_TANH", "RNN_RELU",
            "SELF_ATTENTION", "SELF_LOCAL_ATTENTION", "CNN1D_RNN",
            "CNN1D_SELF_ATTENTION", "CRNN", "DCNN"]
BN_FAMILIES = ["CNN1D", "CNN2D", "CNN1D_RNN", "CNN1D_SELF_ATTENTION", "CRNN",
               "DCNN"]


def small(m, et, **enc):
    """tests/test_encoders_extra.py's config (8 mels with deltas: 3
    channels), in either package."""
    kw = dict(encoder_type=et, hidden_size=16, num_layers=2, ks=3,
              stride=(2, 2), self_attn_heads=2, ffn_size=24, conv_channels=4,
              dcnn_middle=1, ws=5)
    kw.update(enc)
    return (m.Config()
            .with_("audio", n_mels=8, delta_delta=True, downsample=False)
            .with_("encoder", **kw)
            .with_("decoder", hidden_size=16, embed_dim=8)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=16)
            .with_("decode", max_len=6))


def feats(D, B=3, T_=13, lens=(13, 9, 4), seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T_, D).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    x[np.arange(T_)[None, :] >= lens[:, None]] = 0.0
    return x, lens


def close(got, ref, atol=ATOL_OP, msg=""):
    np.testing.assert_allclose(N(got), N(ref), rtol=0, atol=atol, err_msg=msg)


def jinit(fn, seed, *args):
    """A JAX init ``fn(key, *args)`` compiled (jit is quicker than eager
    dispatch on the CPU)."""
    return jax.jit(lambda k: fn(k, *args))(jax.random.PRNGKey(seed))


def carry(jp):
    return tlas.params_from_numpy(jax_params_numpy(jp))


def mask_of(lens, T_):
    return (np.arange(T_)[None, :] < lens[:, None]).astype(np.float32)


# --------------------------------------------------------------------------
# ops/rnn.py: GRU / RNN / unidirectional / local_rnn
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["GRU", "RNN_TANH", "RNN_RELU", "LSTM"])
def test_rnn_layer_and_cell_stack_match_jax(mode):
    x, lens = feats(6, T_=11, lens=(11, 7, 3))
    m = mask_of(lens, 11)
    jp = jinit(jrnn.init_rnn_layer, 2, mode, 6, 8)
    tp = carry(jp)
    jy, js = jax.jit(lambda p, x, m: jrnn.rnn_layer(mode, p, x, m))(
        jp, jnp.asarray(x), jnp.asarray(m))
    ty, ts = trnn.rnn_layer(mode, tp, T(x), T(m))
    close(ty, jy)
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        close(a, b)
    assert np.abs(N(ty)[2, 3:]).max() == 0.0
    # the decoder's cell stack: 2 layers, one step from a given state
    jl = jinit(jrnn.init_cell_stack, 3, mode, 6, 8, 2)
    tl = carry(jl)
    h = np.random.RandomState(1).randn(3, 8).astype(np.float32)
    st = [(h, -h) if mode == "LSTM" else h, None]
    jst = [jax.tree_util.tree_map(jnp.asarray, s) if s is not None else None
           for s in st]
    tst = [jax.tree_util.tree_map(T, s) if s is not None else None
           for s in st]
    jo = jax.jit(lambda l, x, s: jrnn.cell_stack_step(mode, l, x, s))(
        jl, jnp.asarray(x[:, 0]), jst)
    to = trnn.cell_stack_step(mode, tl, T(x[:, 0]), tst)
    for a, b in zip(jax.tree_util.tree_leaves(to),
                    jax.tree_util.tree_leaves(jo)):
        close(a, b)


def test_reverse_sequence_matches_jax():
    x, lens = feats(4, T_=9, lens=(9, 5, 1))
    close(trnn.reverse_sequence(T(x), T(lens)),
          jrnn.reverse_sequence(jnp.asarray(x), jnp.asarray(lens)), atol=0)


@pytest.mark.parametrize("mode,bidir,skip", [("GRU", True, 0),
                                             ("RNN_TANH", True, 2),
                                             ("LSTM", False, 2),
                                             ("RNN_RELU", False, 0)])
def test_rnn_stack_matches_jax(mode, bidir, skip):
    x, lens = feats(6, T_=12, lens=(12, 8, 3))
    m = mask_of(lens, 12)
    jl = jinit(jrnn.init_rnn_stack, 4, mode, 6, 8, 3, bidir)
    before = tlstm.launches
    jy, js, jlens, jm = jax.jit(lambda l, x, n, m: jrnn.rnn_stack(
        mode, l, x, n, m, skip_step=skip))(jl, jnp.asarray(x),
                                           jnp.asarray(lens), jnp.asarray(m))
    ty, ts, tlens, tm = trnn.rnn_stack(mode, carry(jl), T(x), T(lens), T(m),
                                       skip_step=skip)
    assert tlstm.launches == before
    close(ty, jy)
    np.testing.assert_array_equal(N(tlens), N(jlens))
    np.testing.assert_array_equal(N(tm), N(jm))
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        close(a, b)


@pytest.mark.parametrize("mode,bidir", [("GRU", True), ("LSTM", True),
                                        ("RNN_TANH", False)])
def test_local_rnn_matches_jax(mode, bidir):
    x, lens = feats(6, T_=13, lens=(13, 8, 5))
    m = mask_of(lens, 13)
    jl = jinit(jrnn.init_rnn_stack, 5, mode, 6, 8, 2, bidir)
    args = dict(residual=False, skip_steps=[2, 3])
    jy, js, jlens, _ = jax.jit(lambda l, x, n, m: jrnn.local_rnn(
        mode, l, x, n, m, **args))(jl, jnp.asarray(x), jnp.asarray(lens),
                                   jnp.asarray(m))
    ty, ts, tlens, _ = trnn.local_rnn(mode, carry(jl), T(x), T(lens), T(m),
                                      **args)
    close(ty, jy)
    np.testing.assert_array_equal(N(tlens), N(jlens))          # ceil-div
    assert len(ts) == len(js) == 2
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        close(a, b)


# --------------------------------------------------------------------------
# ops/conv.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("act,norm,train,skip,stride",
                         [("RELU", "BN", True, False, 2),
                          ("GLU", "BN", False, False, 2),
                          ("SIGMOID", "LN", False, False, 3),
                          ("TANH", "IN", False, True, 1),
                          ("NONE", "NONE", False, True, 2)])
def test_conv1d_block_matches_jax(act, norm, train, skip, stride):
    x, lens = feats(8, T_=14, lens=(14, 9, 2))
    oc = 16 if act == "GLU" else 8
    jp = jconv.init_conv1d(jax.random.PRNGKey(6), 8, oc, 3, norm)
    if norm == "BN":             # running stats away from their init
        jp = dict(jp, bn_mean=jnp.linspace(-0.5, 0.5, oc),
                  bn_var=jnp.linspace(0.5, 2.0, oc))
    jup, tup = [], []
    jy, jl = jconv.conv1d_block(jp, jnp.asarray(x), jnp.asarray(lens), 3,
                                stride, act, norm, skip, train, updates=jup)
    ty, tl = tconv.conv1d_block(carry(jp), T(x), T(lens), 3, stride, act,
                                norm, skip, train, updates=tup)
    close(ty, jy)
    np.testing.assert_array_equal(N(tl), N(jl))
    assert len(tup) == len(jup) == (1 if train else 0)
    for (_, tm, tv, tn), (_, jm, jv, jn) in zip(tup, jup):
        close(tm, jm)
        close(tv, jv)
        assert tn == jn


@pytest.mark.parametrize("ks,stride,freq_pad,skip", [(3, (2, 1), 1, False),
                                                     ((3, 2), (2, 2), None,
                                                      False),
                                                     (3, 1, None, True),
                                                     (1, 1, None, False)])
def test_conv2d_block_matches_jax(ks, stride, freq_pad, skip):
    rng = np.random.RandomState(3)
    x = rng.randn(3, 11, 7, 4).astype(np.float32)
    lens = np.array([11, 6, 3], np.int32)
    x[np.arange(11)[None, :] >= lens[:, None]] = 0.0
    jp = jconv.init_conv2d(jax.random.PRNGKey(7), 4, 4, ks, "BN")
    jup, tup = [], []
    jy, jl = jconv.conv2d_block(jp, jnp.asarray(x), jnp.asarray(lens), ks,
                                stride, "RELU", "BN", skip, True, freq_pad,
                                updates=jup)
    ty, tl = tconv.conv2d_block(carry(jp), T(x), T(lens), ks, stride,
                                "RELU", "BN", skip, True, freq_pad,
                                updates=tup)
    close(ty, jy)
    np.testing.assert_array_equal(N(tl), N(jl))
    (_, tm, tv, tn), = tup
    (_, jm, jv, jn), = jup
    close(tm, jm)
    close(tv, jv)
    assert tn == jn
    # same_conv2d (3x3 and the 1x1 down projection)
    for k in (3, 1):
        sp = jconv.init_same_conv2d(jax.random.PRNGKey(k), 4, 6, k)
        close(tconv.same_conv2d(carry(sp), T(x)),
              jconv.same_conv2d(sp, jnp.asarray(x)))
    np.testing.assert_array_equal(
        N(tconv.conv_out_len(T(lens), 3, 2)),
        N(jconv.conv_out_len(jnp.asarray(lens), 3, 2)))


def test_bn_stats_tree_and_merge_match_jax():
    """The recordings become a tree mirroring the params (unbiased var),
    and the merge is torch's momentum-0.1 moving average."""
    x, lens = feats(8, T_=10, lens=(10, 7, 5))
    jp = {"convs": [jconv.init_conv1d(jax.random.PRNGKey(i), 8, 8, 3, "BN")
                    for i in range(2)], "other": {"w": jnp.ones(3)}}
    tp = carry(jp)
    jup, tup = [], []
    jy, jt = jnp.asarray(x), T(x)
    jl, tl = jnp.asarray(lens), T(lens)
    for i in range(2):
        jy, jl = jconv.conv1d_block(jp["convs"][i], jy, jl, 3, 1, "RELU",
                                    "BN", train=True, updates=jup)
        jt, tl = tconv.conv1d_block(tp["convs"][i], jt, tl, 3, 1, "RELU",
                                    "BN", train=True, updates=tup)
    js = jconv.bn_stats_tree(jp, jup)
    ts = tconv.bn_stats_tree(tp, tup)
    assert ts["other"] is None and js["other"] is None
    for i in range(2):
        (tm, tv), (jm, jv) = ts["convs"][i]["__bn__"], js["convs"][i]["__bn__"]
        close(tm, jm)
        close(tv, jv)
        n = tup[i][3]
        close(tv, N(tup[i][2]) * n / (n - 1))
    jn = jconv.merge_bn_stats(jp, js)
    tn = tconv.merge_bn_stats(tp, ts)
    for i in range(2):
        for k in ("bn_mean", "bn_var"):
            close(tn["convs"][i][k], jn["convs"][i][k])
    assert tconv.bn_stats_tree(tp, []) is None
    assert tconv.merge_bn_stats(tp, None) is tp


# --------------------------------------------------------------------------
# ops/self_attention.py
# --------------------------------------------------------------------------
def _qkv(B=2, L=9, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, L, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("heads,proj", [(1, False), (2, False), (2, True)])
def test_self_attention_matches_jax(heads, proj):
    q, k, v = _qkv()
    lens = np.array([9, 5], np.int32)
    pw = np.random.RandomState(9).randn(8, 8).astype(np.float32) \
        if proj else None
    ja, jal = jsa.self_attention(*map(jnp.asarray, (q, k, v, lens)), heads,
                                 None if pw is None else jnp.asarray(pw))
    ta, tal = tsa.self_attention(*map(T, (q, k, v, lens)), heads,
                                 None if pw is None else T(pw))
    close(ta, ja)
    close(tal, jal)


@pytest.mark.parametrize("ws,heads,lens", [(5, 1, (9, 5)), (3, 2, (9, 2)),
                                           (11, 2, (9, 7)), (4, 1, (9, 3))])
def test_self_local_attention_matches_jax(ws, heads, lens):
    """The window's start clamped to [0, len-ws], -inf on slots past the
    length, the gather index clamped to L-1 (ws > L included)."""
    q, k, v = _qkv(seed=1)
    lens = np.asarray(lens, np.int32)
    ja, jal = jsa.self_local_attention(*map(jnp.asarray, (q, k, v, lens)),
                                       ws, heads)
    ta, tal = tsa.self_local_attention(*map(T, (q, k, v, lens)), ws, heads)
    close(ta, ja)
    fin = np.isfinite(N(jal))
    np.testing.assert_array_equal(np.isfinite(N(tal)), fin)
    close(N(tal)[fin], N(jal)[fin])


@pytest.mark.parametrize("ws", [None, 5])
def test_attention_block_and_parts_match_jax(ws):
    x, lens = feats(12, B=2, T_=9, lens=(9, 6))
    jp = jinit(jsa.init_block, 8, 12, 16, True, 20)
    tp = carry(jp)
    close(tsa.attention_block(tp, T(x), T(lens), 4, ws),
          jax.jit(lambda p, x, n: jsa.attention_block(p, x, n, 4, ws))(
              jp, jnp.asarray(x), jnp.asarray(lens)))
    close(tsa.qkv_attention(tp["attn"], T(x), T(lens), 2, ws),
          jax.jit(lambda p, x, n: jsa.qkv_attention(p, x, n, 2, ws))(
              jp["attn"], jnp.asarray(x), jnp.asarray(lens)))
    h = np.random.RandomState(2).randn(2, 9, 16).astype(np.float32)
    close(tsa.ffn(tp["ffn"], T(h)), jsa.ffn(jp["ffn"], jnp.asarray(h)))
    close(tsa.layer_norm(tp["ln1_scale"] + 0.5, tp["ln1_bias"] - 1, T(h)),
          jsa.layer_norm(jp["ln1_scale"] + 0.5, jp["ln1_bias"] - 1,
                         jnp.asarray(h)))
    close(tsa.sin_pos_embedding(17, 12), jsa.sin_pos_embedding(17, 12),
          atol=0)


def test_mha_cache_matches_jax_and_full():
    """tests/test_config_variants.py's incremental-cache case: each step
    against JAX's step, and the steps against the causal full pass."""
    jp = jsa.init_mha(jax.random.PRNGKey(0), 16, 4)
    tp = dict(carry({k: v for k, v in jp.items() if k != "heads"}), heads=4)
    x = np.random.RandomState(0).randn(2, 7, 16).astype(np.float32)
    full = tsa.mha_full(tp, T(x))
    close(full, jsa.mha_full(jp, jnp.asarray(x)))
    jc, tc = jsa.mha_init_cache(2, 7, 16), tsa.mha_init_cache(2, 7, 16)
    jstep_ = jax.jit(lambda p, x, c: jsa.mha_step(dict(p, heads=4), x, c))
    jw = {k: v for k, v in jp.items() if k != "heads"}
    for t in range(7):
        jy, jc = jstep_(jw, jnp.asarray(x[:, t]), jc)
        ty, tc = tsa.mha_step(tp, T(x[:, t]), tc)
        close(ty, jy)
        close(ty, full[:, t])


# --------------------------------------------------------------------------
# ops/conv_lstm.py
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ks", [3, 2])
def test_conv_lstm_matches_jax(ks):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 8, 5, 2).astype(np.float32)
    lens = np.array([8, 5, 2], np.int32)
    x[np.arange(8)[None, :] >= lens[:, None]] = 0.0
    jp = jcl.init_conv_lstm(jax.random.PRNGKey(1), 2, 3, ks)
    jp = dict(jp, b=jnp.linspace(-1, 1, 12))
    tp = carry(jp)
    h0 = rng.randn(3, 5, 3).astype(np.float32)
    close(tcl._freq_conv(T(x[:, 0]), tp["w_x"]),
          jcl._freq_conv(jnp.asarray(x[:, 0]), jp["w_x"]))
    jy, (jh, jc) = jax.jit(jcl.conv_lstm)(jp, jnp.asarray(x),
                                          jnp.asarray(lens),
                                          (jnp.asarray(h0), jnp.asarray(-h0)))
    ty, (th, tc) = tcl.conv_lstm(tp, T(x), T(lens), (T(h0), T(-h0)))
    for a, b in ((ty, jy), (th, jh), (tc, jc)):
        close(a, b)
    jbp = jinit(jcl.init_bconv_lstm, 2, 2, 3, ks)
    jy, js = jax.jit(jcl.bconv_lstm)(jbp, jnp.asarray(x), jnp.asarray(lens))
    ty, ts = tcl.bconv_lstm(carry(jbp), T(x), T(lens))
    close(ty, jy)
    for a, b in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        close(a, b)
    assert np.abs(N(ty)[2, 2:]).max() == 0.0


# --------------------------------------------------------------------------
# the encoder families
# --------------------------------------------------------------------------
def jencode(jp, cj, x, lens, modes=(False,)):
    """JAX's apply_encoder compiled, once for each train mode in ``modes``
    -> [(EncoderOut, [(None, mean, var, n)] as ``bn_updates`` records
    them)]."""
    ns = {}

    def f(p, x, n):
        res = []
        for train in modes:
            up = []
            out = jenc.apply_encoder(p, cj, x, n, train=train, bn_updates=up)
            ns[train] = [u[3] for u in up]
            res.append((out, [(m, v) for _, m, v, _ in up]))
        return res

    res = jax.jit(f)(jp, jnp.asarray(x), jnp.asarray(lens))
    return [(out, [(None, m, v, n) for (m, v), n in zip(mv, ns[train])])
            for train, (out, mv) in zip(modes, res)]


@pytest.mark.parametrize("et", FAMILIES)
def test_family_encoder_matches_jax(et):
    """apply_encoder in eval mode (BatchNorm on running stats moved off
    their init) and in train mode with the BN recordings, its lens and
    its final state; padding rows exactly 0."""
    cj, ct = small(jcfg, et), small(tcfg, et)
    jp = jinit(jenc.init_encoder, 0, cj)
    rs = np.random.RandomState(1)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rs.uniform(0.5, 1.5, a.shape),
                                     jnp.float32)
                         if str(path[-1]).find("bn_var") >= 0 else
                         jnp.asarray(0.2 * rs.randn(*a.shape), jnp.float32)
                         if str(path[-1]).find("bn_mean") >= 0 else a), jp)
    tp = carry(jp)
    x, lens = feats(cj.audio.feat_dim, T_=15, lens=(15, 10, 5))
    assert tenc.encoder_output_size(ct) == jenc.encoder_output_size(cj)
    for train, (jo, jup) in zip((False, True),
                                jencode(jp, cj, x, lens, (False, True))):
        tup = []
        to = tenc.apply_encoder(tp, ct, T(x), T(lens), train=train,
                                bn_updates=tup)
        close(to.out, jo.out, ATOL_ENC, f"{et} train={train}")
        np.testing.assert_array_equal(N(to.out_lens), N(jo.out_lens))
        assert to.out.shape[-1] == tenc.encoder_output_size(ct)
        assert (to.state is None) == (jo.state is None)
        if jo.state is not None:
            assert isinstance(to.state, torch.Tensor)         # h alone
            close(to.state, jo.state, ATOL_ENC)
        y, ol = N(to.out), N(to.out_lens)
        for b in range(3):
            assert np.abs(y[b, ol[b]:]).max(initial=0.0) == 0.0, (et, b)
        assert len(tup) == len(jup)
        assert bool(tup) == (train and et in BN_FAMILIES)
        for (_, tm, tv, tn), (_, jm, jv, jn) in zip(tup, jup):
            close(tm, jm)
            close(tv, jv)
            assert tn == jn


def test_glu_cnn1d_and_residual_cnn2d_match_jax():
    for et, enc in (("CNN1D", dict(act="GLU", hidden_size=32)),
                    ("CNN2D", dict(norm="LN", act="TANH", stride=(1, 1),
                                   hidden_size=6))):
        cj, ct = small(jcfg, et, **enc), small(tcfg, et, **enc)
        jp = jinit(jenc.init_encoder, 3, cj)
        x, lens = feats(cj.audio.feat_dim, T_=12, lens=(12, 7, 4))
        [(jo, _)] = jencode(jp, cj, x, lens)
        to = tenc.apply_encoder(carry(jp), ct, T(x), T(lens))
        close(to.out, jo.out, ATOL_ENC, et)
        assert to.out.shape[-1] == tenc.encoder_output_size(ct)


def test_res_cnn_block_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 9, 5, 3).astype(np.float32)
    lens = np.array([9, 4], np.int32)
    for out_c in (3, 4):
        jp = jinit(jextra.init_res_cnn, out_c, 3, out_c)
        jup, tup = [], []
        jy = jax.jit(lambda p, x, n: jextra.res_cnn(p, x, n, True, jup)[0])(
            jp, jnp.asarray(x), jnp.asarray(lens))
        ty, _ = textra.res_cnn(carry(jp), T(x), T(lens), True, tup)
        close(ty, jy)
        assert len(tup) == len(jup) == 2


# --------------------------------------------------------------------------
# reference state-dict import
# --------------------------------------------------------------------------
def _t(shape, axes=None):
    """A shape permuted as ``transpose(axes)`` would (reversed without)."""
    return tuple(shape[a] for a in axes) if axes else tuple(shape)[::-1]


def _conv_sd(sd, pre, p, axes, rng, bias):
    sd[pre + "conv.weight"] = rng.randn(*_t(p["w"].shape, axes)).astype(
        np.float32)
    if bias:
        sd[pre + "conv.bias"] = rng.randn(p["b"].shape[0]).astype(np.float32)
    if "norm_scale" in p:
        for n in ("weight", "bias"):
            sd[pre + "norm." + n] = rng.randn(p["b"].shape[0]).astype(
                np.float32)
    if "bn_mean" in p:
        for n in ("running_mean", "running_var"):
            sd[pre + "norm." + n] = rng.rand(p["b"].shape[0]).astype(
                np.float32)


def _rnn_sd(sd, pre, layers, rng):
    for i, layer in enumerate(layers):
        for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
            if d in layer:
                for n, k in (("weight_ih_l0", "w_ih"),
                             ("weight_hh_l0", "w_hh"),
                             ("bias_ih_l0", "b_ih"), ("bias_hh_l0", "b_hh")):
                    sd[f"{pre}{i}.{n}{sfx}"] = rng.randn(
                        *_t(layer[d][k].shape)).astype(np.float32)


def _sa_sd(sd, pre, blocks, rng, local):
    for i, blk in enumerate(blocks):
        b = f"{pre}{i}."
        a = b + ("sla." if local else "mha.")
        w1, w2 = blk["ffn"]["w1"], blk["ffn"]["w2"]
        for name, shape in ((a + "weight", _t(blk["attn"]["w_qkv"].shape)),
                            (a + "bias", blk["attn"]["b_qkv"].shape),
                            (b + "ffn.weight_1", _t(w1.shape)),
                            (b + "ffn.weight_2", _t(w2.shape)),
                            (b + "ffn.bias", (w1.shape[1] + w2.shape[1],)),
                            (b + "ln_1.weight", blk["ln1_scale"].shape),
                            (b + "ln_1.bias", blk["ln1_bias"].shape),
                            (b + "ln_2.weight", blk["ln2_scale"].shape),
                            (b + "ln_2.bias", blk["ln2_bias"].shape)):
            sd[name] = rng.randn(*shape).astype(np.float32)
        if "w_proj" in blk["attn"]:
            sd[a + "proj_weight"] = rng.randn(
                *blk["attn"]["w_proj"].shape).astype(np.float32)


def _cl_sd(sd, pre, p, rng):
    for n, k in (("conv_x", "w_x"), ("conv_h", "w_h")):
        sd[f"{pre}{n}.weight"] = rng.randn(*_t(p[k].shape)).astype(
            np.float32)
        sd[f"{pre}{n}.bias"] = rng.randn(p["b"].shape[0]).astype(np.float32)


def reference_sd(cfg, seed):
    """A random state dict in the reference encoder's names and
    orientations for ``cfg``'s family, its shapes from the JAX init."""
    rng = np.random.RandomState(seed)
    p = jax.eval_shape(lambda: jenc.init_encoder(jax.random.PRNGKey(0), cfg))
    et, sd = cfg.encoder.encoder_type, {}
    if et in ("CNN1D", "CNN2D"):
        axes = (2, 1, 0) if et == "CNN1D" else (3, 2, 1, 0)
        for i, c in enumerate(p["convs"]):
            _conv_sd(sd, f"convs.{i}.", c, axes, rng, bias=et == "CNN2D")
    elif et in ("CNN1D_RNN", "CNN1D_SELF_ATTENTION"):
        for i, c in enumerate(p["front"]["convs"]):
            _conv_sd(sd, f"cnn1d.convs.{i}.", c, (2, 1, 0), rng, bias=False)
        if et == "CNN1D_RNN":
            _rnn_sd(sd, "rnn.rnn.rnn.", p["rnn"], rng)
        else:
            _sa_sd(sd, "sa.blocks.", p["sa"]["blocks"], rng, local=False)
    elif et in ("SELF_ATTENTION", "SELF_LOCAL_ATTENTION"):
        _sa_sd(sd, "blocks.", p["blocks"], rng,
               local=et == "SELF_LOCAL_ATTENTION")
    elif et == "CRNN":
        for i, c in enumerate(p["heads"]):
            _conv_sd(sd, f"heads.{i}.", c, (3, 2, 1, 0), rng, bias=False)
        for i, c in enumerate(p["conv_lstm"]):
            _cl_sd(sd, f"conv_lstm.{i}.", c, rng)
    return sd


def assert_trees_equal(tp, jp):
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tlas.tree_paths(tp)
    assert [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
            for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(N(b), np.asarray(a), err_msg=str(path))


@pytest.mark.parametrize("et", ["CNN1D", "CNN2D", "CNN1D_RNN",
                                "CNN1D_SELF_ATTENTION", "SELF_ATTENTION",
                                "SELF_LOCAL_ATTENTION", "CRNN", "DCNN"])
def test_encoder_from_torch_state_matches_jax(et):
    """One random reference-format state dict per family: the port's tree
    equals JAX's bit for bit (DCNN has no converter in either)."""
    cj, ct = small(jcfg, et), small(tcfg, et)
    sd = reference_sd(cj, seed=FAMILIES.index(et))
    if et == "DCNN":
        with pytest.raises(ValueError, match="no torch converter"):
            jextra.encoder_from_torch_state(sd, cj)
        with pytest.raises(ValueError, match="no torch converter"):
            textra.encoder_from_torch_state(sd, ct)
        return
    jp = jextra.encoder_from_torch_state(sd, cj)
    assert_trees_equal(tlas.params_from_numpy(
        textra.encoder_from_torch_state(sd, ct)), jp)
    # and the model-level import dispatches there
    rng = np.random.RandomState(1)
    shapes = jax.eval_shape(lambda: jlas.init_params(jax.random.PRNGKey(0),
                                                     cj))
    ap, dp = shapes["attention"], shapes["decoder"]
    c0 = dp["cells"][0]
    dec = {"embedding.weight": dp["embedding"].shape,
           "proj_linear.weight": dp["proj_w"].shape[::-1],
           "proj_linear.bias": dp["proj_b"].shape,
           "cell.cell.0.weight_ih": c0["w_ih"].shape[::-1],
           "cell.cell.0.weight_hh": c0["w_hh"].shape[::-1],
           "cell.cell.0.bias_ih": c0["b_ih"].shape,
           "cell.cell.0.bias_hh": c0["b_hh"].shape,
           "attn_mechanism.W_enc": ap["w_enc"].shape,
           "attn_mechanism.b_attn": ap["b_attn"].shape,
           "attn_mechanism.W_hidden": ap["w_hidden"].shape,
           "attn_mechanism.v": ap["v"].shape}
    dec = {k: rng.randn(*v).astype(np.float32) for k, v in dec.items()}
    assert_trees_equal(tlas.params_from_torch_state(sd, dec, ct),
                       jlas.params_from_torch_state(sd, dec, cj))


# --------------------------------------------------------------------------
# one BatchNorm train step (tests/test_train.py:320-400)
# --------------------------------------------------------------------------
def _bn_cfg(m, **train):
    tr = dict(label_smooth=0.1, base_lr=3e-3, l2_decay=1e-2, optimizer="SGD")
    tr.update(train)
    return (m.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", encoder_type="CNN1D", hidden_size=16,
                   num_layers=2, conv_channels=8, norm="BN", act="RELU",
                   ks=3, stride=(2, 2))
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("train", **tr))


def _bn_batch(cfg, seed=0, B=4, T_=12, S=6):
    """tests/test_train.py make_batch."""
    rng = np.random.RandomState(seed)
    f = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
    text = rng.randint(4, cfg.vocab.vocab_size, size=(B, S - 1))
    tin = np.concatenate([np.full((B, 1), cfg.vocab.sos), text], axis=1)
    tout = np.concatenate([text, np.full((B, 1), cfg.vocab.eos)], axis=1)
    return (f, np.full(B, T_, np.int32), tin.astype(np.int32),
            tout.astype(np.int32), np.full(B, S, np.int32))


def test_bn_train_step_matches_jax():
    """Loss and params against JAX's step; the running stats move by
    exactly 0.9 * running + 0.1 * batch stat (unbiased var), with no
    optimizer or weight-decay update on them (L2 1e-2 would show).

    SGD, not Adam: a conv bias just before a BatchNorm has a zero
    gradient up to rounding (the batch mean removes it), and Adam's
    normalization turns that rounding noise into a full-lr step of
    either sign in each framework."""
    cj, ct = _bn_cfg(jcfg), _bn_cfg(tcfg)
    pj = jinit(jlas.init_params, 0, cj)
    pt = carry(pj)
    nb = _bn_batch(cj)
    tx_j = joptim.make_optimizer(cj.train, pj)
    tx_t = toptim.make_optimizer(ct.train)
    tape = []
    tenc.apply_encoder(pt["encoder"], ct, T(nb[0]), T(nb[1]), train=True,
                       bn_updates=tape)
    assert len(tape) == len(pt["encoder"]["convs"]) == 2
    expect = [(N(m), N(v) * n / (n - 1)) for _, m, v, n in tape]
    pj2, _, mj = jax.jit(lambda p, o, b: jstep.train_step(p, o, cj, tx_j, b))(
        pj, tx_j.init(pj), jstep.Batch(*map(jnp.asarray, nb)))
    pt2, _, mt = tstep.train_step(pt, tx_t.init(pt), ct, tx_t,
                                  TBatch(*map(T, nb)))
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    assert "bn_stats" not in mt
    for (path, a), (_, b) in zip(tlas.tree_paths(pt2),
                                 tlas.tree_paths(jax_params_numpy(pj2))):
        np.testing.assert_allclose(N(a), b, rtol=0, atol=2e-5,
                                   err_msg=str(path))
    for i, (m, v) in enumerate(expect):
        blk = pt2["encoder"]["convs"][i]
        np.testing.assert_allclose(N(blk["bn_mean"]), 0.1 * m, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(N(blk["bn_var"]), 0.9 + 0.1 * v,
                                   rtol=1e-5, atol=1e-6)
    # the optimizer keeps no moments of the buffers
    assert not any("bn_" in k for k in tx_t.init(pt))


def test_bn_train_step_bf16_keeps_f32_running_stats():
    """Mixed precision: the running stats stay float32 and follow the
    moving average of the batch statistics of the bf16 forward."""
    ct = _bn_cfg(tcfg, compute_dtype="bfloat16")
    pt = carry(jinit(jlas.init_params, 0, _bn_cfg(jcfg)))
    nb = _bn_batch(ct)
    tx = toptim.make_optimizer(ct.train)
    bf = tlas.tree_map(lambda t: t.to(torch.bfloat16), pt)
    tape = []
    tenc.apply_encoder(bf["encoder"], ct, T(nb[0]).to(torch.bfloat16),
                       T(nb[1]), train=True, bn_updates=tape)
    expect = [(m.float(), (v * (n / (n - 1))).float()) for _, m, v, n in tape]
    pt2, _, mt = tstep.train_step(pt, tx.init(pt), ct, tx,
                                  TBatch(*map(T, nb)))
    assert np.isfinite(float(mt["loss"]))
    for i, (m, v) in enumerate(expect):
        blk = pt2["encoder"]["convs"][i]
        assert blk["bn_mean"].dtype == blk["bn_var"].dtype == torch.float32
        np.testing.assert_allclose(N(blk["bn_mean"]), 0.1 * N(m), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(N(blk["bn_var"]), 0.9 + 0.1 * N(v),
                                   rtol=1e-5, atol=1e-6)
