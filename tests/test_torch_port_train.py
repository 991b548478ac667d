"""PyTorch port, training: the port's loss, teacher-forced forward, train
step and optimizers against the JAX package's on the same seeded numpy
inputs (params carried by ``params_from_numpy``), and the K2 autograd
Function's gradients against ``jax.vjp`` of the JAX scan.

JAX runs on the CPU through its ``lax.scan`` LSTM (the path its own
tests take); the port runs with CPU tensors, so its K2 wrapper takes the
plain twin forward and K2-bwd's plain twin backward.

Tolerances (float32 on both sides, sums in other orders): logits and
losses 2e-5 relative; gradients and grad norms 1e-4 relative; params after
optimizer steps 2e-5 absolute (an Adam step is ~lr = 3e-3 in size, and
the steps differ by the rounding of their moments); the recurrence's
gradients 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.ops.rnn import _bidir_core_scan
from chinese_asr_tpu.train import optim as joptim
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu.train.loss import label_smoothed_ce as j_ce
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data.dataset import Batch as TBatch
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train import step as tstep
from chinese_asr_tpu_torch.train.loss import label_smoothed_ce as t_ce

from torch_port_util import N, T, jax_params_numpy


def small(config_module, **train):
    """tests/test_train.py's SMALL, with L2 on."""
    tr = dict(label_smooth=0.1, base_lr=3e-3, l2_decay=1e-4)
    tr.update(train)
    return (config_module.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("train", **tr))


def make_batch(cfg, seed=0, B=4, T_=9, S=6, ragged=True):
    """Numpy batch (tests/test_train.py make_batch, with ragged lengths)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
    feat_lens = np.full(B, T_, np.int32)
    text_lens = np.full(B, S, np.int32)
    if ragged:
        feat_lens[1:] = rng.randint(T_ // 2, T_ + 1, B - 1)
        feats[np.arange(T_)[None, :] >= feat_lens[:, None]] = 0.0
        text_lens[1:] = rng.randint(2, S + 1, B - 1)
    text = rng.randint(4, cfg.vocab.vocab_size, size=(B, S - 1))
    tokens_in = np.concatenate([np.full((B, 1), cfg.vocab.sos), text], axis=1)
    tokens_out = np.concatenate([text, np.full((B, 1), cfg.vocab.eos)], axis=1)
    for b in range(B):
        tokens_out[b, text_lens[b] - 1] = cfg.vocab.eos
        tokens_out[b, text_lens[b]:] = cfg.vocab.pad
        tokens_in[b, text_lens[b]:] = cfg.vocab.pad
    return (feats, feat_lens, tokens_in.astype(np.int32),
            tokens_out.astype(np.int32), text_lens)


def jbatch(nb):
    return jstep.Batch(*map(jnp.asarray, nb))


def tbatch(nb):
    return TBatch(*map(T, nb))


def both_params(cfg_j, seed=0):
    pj = jlas.init_params(jax.random.PRNGKey(seed), cfg_j)
    return pj, tlas.params_from_numpy(jax_params_numpy(pj))


def assert_tree_close(tree_t, tree_j, rtol, atol):
    flat_t = toptim.flatten(tree_t)
    flat_j = toptim.flatten(jax.tree_util.tree_map(np.asarray, tree_j))
    assert flat_t.keys() == flat_j.keys()
    for n in flat_t:
        np.testing.assert_allclose(N(flat_t[n]), flat_j[n], rtol=rtol,
                                   atol=atol, err_msg=n)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ls", [0.0, 0.1])
@pytest.mark.parametrize("with_mask", [False, True])
def test_label_smoothed_ce_matches_jax(ls, with_mask):
    rng = np.random.RandomState(3)
    logits = (3 * rng.randn(4, 5, 11)).astype(np.float32)
    tgt = rng.randint(0, 11, size=(4, 5))
    mask = rng.rand(4, 5) > 0.3 if with_mask else None
    want = j_ce(jnp.asarray(logits), jnp.asarray(tgt),
                None if mask is None else jnp.asarray(mask), ls)
    got = t_ce(T(logits), T(tgt), None if mask is None else T(mask), ls)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-6)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
@pytest.mark.parametrize("form", ["hoisted", "gate_hoist", "ss_1"])
def test_forward_logits_matches_jax(form):
    """The three loop forms: teacher forcing with the hoisted products, the
    layer-0 gate hoist, and scheduled sampling at ss=1.0 (every input
    after t=0 is the model's own argmax, so the path is deterministic)."""
    cfg_j, cfg_t = small(jcfg), small(tcfg)
    pj, pt = both_params(cfg_j, seed=1)
    nb = make_batch(cfg_j, seed=5)
    kw_j, kw_t = {}, {}
    if form == "gate_hoist":
        kw_j = kw_t = dict(gate_hoist=True)
    if form == "ss_1":
        kw_j = dict(rng=jax.random.PRNGKey(0), ss=1.0)
        kw_t = dict(gen=torch.Generator().manual_seed(0), ss=1.0)
    want = np.asarray(jstep.forward_logits(pj, cfg_j, jbatch(nb), **kw_j))
    got = N(tstep.forward_logits(pt, cfg_t, tbatch(nb), **kw_t))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("ss", [0.0, 0.3])
def test_remat_matches_no_remat(ss):
    """train.remat (torch.utils.checkpoint around each decoder step) leaves
    the loss and every gradient as they are."""
    cfg = small(tcfg, ss=ss)
    _, pt = both_params(small(jcfg), seed=2)
    b = tbatch(make_batch(cfg, seed=9))
    out = []
    for remat in (False, True):
        c = cfg.with_("train", remat=remat)
        flat = {n: t.clone().requires_grad_(True)
                for n, t in toptim.flatten(pt).items()}
        loss, _ = tstep.loss_fn(toptim.unflatten(pt, flat), c, b,
                                torch.Generator().manual_seed(4))
        out.append((loss.item(),
                    torch.autograd.grad(loss, list(flat.values()))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for g0, g1 in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(N(g1), N(g0), rtol=1e-5, atol=1e-7)


def test_scheduled_sampling_uses_its_generator():
    cfg = small(tcfg, ss=0.5)
    _, pt = both_params(small(jcfg))
    b = tbatch(make_batch(cfg))
    l1 = float(tstep.loss_fn(pt, cfg, b, torch.Generator().manual_seed(1))[0])
    l1b = float(tstep.loss_fn(pt, cfg, b, torch.Generator().manual_seed(1))[0])
    l0 = float(tstep.loss_fn(pt, cfg, b, None)[0])
    assert l1 == l1b and np.isfinite(l1) and l1 != l0


# --------------------------------------------------------------------------
# train step and optimizers
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["ADAM", "SGD", "ADABOUND", "ADABOUNDW"])
def test_train_step_matches_jax(kind):
    """Three updates under each optimizer with the global-norm clip and L2
    on: loss, grad norm and every parameter after each step.  The clip is
    set below the gradient norm so that it acts on every step."""
    tr = dict(optimizer=kind, clip=0.1)
    cfg_j, cfg_t = small(jcfg, **tr), small(tcfg, **tr)
    pj, pt = both_params(cfg_j, seed=3)
    tx_j = joptim.make_optimizer(cfg_j.train, pj)
    tx_t = toptim.make_optimizer(cfg_t.train)
    oj, ot = tx_j.init(pj), tx_t.init(pt)
    step_j = jax.jit(lambda p, o, b: jstep.train_step(p, o, cfg_j, tx_j, b))
    for i in range(3):
        nb = make_batch(cfg_j, seed=10 + i)
        pj, oj, mj = step_j(pj, oj, jbatch(nb))
        pt, ot, mt = tstep.train_step(pt, ot, cfg_t, tx_t, tbatch(nb))
        assert float(mj["grad_norm"]) > cfg_j.train.clip
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-4)
        assert not bool(mt["skipped"])
        assert_tree_close(pt, pj, rtol=0, atol=2e-5)


def test_fine_tune_freezes_all_but_projection_and_attention():
    cfg_j, cfg_t = (small(m, fine_tune=True) for m in (jcfg, tcfg))
    pj, pt = both_params(cfg_j, seed=4)
    tx_j = joptim.make_optimizer(cfg_j.train, pj)
    tx_t = toptim.make_optimizer(cfg_t.train)
    nb = make_batch(cfg_j, seed=2)
    pj2, _, _ = jax.jit(lambda p, o, b: jstep.train_step(p, o, cfg_j, tx_j, b))(
        pj, tx_j.init(pj), jbatch(nb))
    pt2, _, _ = tstep.train_step(pt, tx_t.init(pt), cfg_t, tx_t, tbatch(nb))
    assert_tree_close(pt2, pj2, rtol=0, atol=2e-5)
    moved = {n for n, v in toptim.flatten(pt2).items()
             if not torch.equal(v, toptim.flatten(pt)[n])}
    assert moved and all(n.startswith("attention/")
                         or n.startswith("decoder/proj_") for n in moved)


def test_train_step_skips_nonfinite():
    cfg = small(tcfg)
    _, pt = both_params(small(jcfg))
    tx = toptim.make_optimizer(cfg.train)
    ot = tx.init(pt)
    nb = make_batch(cfg)
    nb[0][0, 0, 0] = np.nan
    p2, o2, m = tstep.train_step(pt, ot, cfg, tx, tbatch(nb))
    assert bool(m["skipped"]) and not np.isfinite(float(m["loss"]))
    for a, b in zip(tlas.tree_leaves(pt), tlas.tree_leaves(p2)):
        assert torch.equal(a, b)
    for k in ot:
        assert torch.equal(ot[k], o2[k])


def test_train_step_overfits_tiny_batch():
    cfg = small(tcfg, l2_decay=0.0)
    _, pt = both_params(small(jcfg))
    tx = toptim.make_optimizer(cfg.train)
    ot = tx.init(pt)
    b = tbatch(make_batch(cfg, ragged=False))
    losses = []
    for _ in range(30):
        pt, ot, m = tstep.train_step(pt, ot, cfg, tx, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.7 * losses[0], losses


def test_bf16_training_waits_for_a_later_slice():
    """``train.compute_dtype="bfloat16"``: the bf16 ``loss_fn`` against
    JAX's on the same params and batch, within 2e-2 (both round to bf16,
    at other points; tests/test_torch_port_train_bf16.py has the step,
    its gradients and the recurrence's VJP), the loss in float32."""
    cfg_j = small(jcfg, compute_dtype="bfloat16")
    cfg = small(tcfg, compute_dtype="bfloat16")
    pj, pt = both_params(small(jcfg))
    nb = make_batch(cfg)
    want, _ = jax.jit(lambda p, b: jstep.loss_fn(p, cfg_j, b))(pj, jbatch(nb))
    got, aux = tstep.loss_fn(pt, cfg, tbatch(nb))
    assert got.dtype == torch.float32 and int(aux["num_tokens"]) > 0
    assert abs(float(got) - float(want)) <= 2e-2


# --------------------------------------------------------------------------
# LR control
# --------------------------------------------------------------------------
def test_ramp_up_set_get_lr_and_plateau_match_jax():
    for args in [(1.0, 0, 10), (1.0, 9, 10), (1.0, 50, 10), (1.0, 0, 0),
                 (3e-3, 4, 7)]:
        assert toptim.ramp_up_lr(*args) == joptim.ramp_up_lr(*args)
    cfg_j, cfg_t = small(jcfg), small(tcfg)
    pj, pt = both_params(cfg_j)
    oj = joptim.make_optimizer(cfg_j.train).init(pj)
    ot = toptim.make_optimizer(cfg_t.train).init(pt)
    assert toptim.get_lr(ot) == pytest.approx(joptim.get_lr(oj))
    oj, ot = joptim.set_lr(oj, 1e-4), toptim.set_lr(ot, 1e-4)
    assert toptim.get_lr(ot) == joptim.get_lr(oj)
    kw = dict(patience=2, factor=0.5, base_lr=1e-3, min_lr=1e-4,
              dec_rate_threshold=0.01)
    pl_j = joptim.PlateauLR(small(jcfg, **kw).train)
    pl_t = toptim.PlateauLR(small(tcfg, **kw).train)
    for metric in [0.5, 0.6, 0.6, 0.6, 0.4, 0.399, 0.41, 0.5, 0.5, 0.5,
                   0.5, 0.5, 0.5, 0.5]:
        assert pl_t.step(metric) == pl_j.step(metric)
        assert (pl_t.lr, pl_t.best, pl_t.num_no_imprv) == \
            (pl_j.lr, pl_j.best, pl_j.num_no_imprv)


# --------------------------------------------------------------------------
# K2's autograd Function and K2-bwd's twin
# --------------------------------------------------------------------------
def _lstm_case(Tn, B, H, seed):
    """Random non-prefix masks (tests/test_pallas_lstm.py:111-140), the
    backward direction's flipped, and nonzero final-state cotangents."""
    rng = np.random.RandomState(seed)
    xg_f, xg_b = (rng.randn(Tn, B, 4 * H).astype(np.float32)
                  for _ in range(2))
    w = (rng.randn(2, H, 4 * H) / np.sqrt(H)).astype(np.float32)
    m_f = (rng.rand(Tn, B) > 0.3).astype(np.float32)
    m_b = (rng.rand(Tn, B) > 0.3).astype(np.float32)[::-1].copy()
    cot = [rng.randn(Tn, B, H).astype(np.float32) for _ in range(2)] + \
        [rng.randn(2, B, H).astype(np.float32) for _ in range(2)]
    return (xg_f, xg_b, m_f, m_b, w), cot


@pytest.mark.parametrize("shape", [(7, 3, 8, 0), (12, 5, 16, 1),
                                   (5, 2, 12, 2), (9, 17, 64, 3)])
def test_k2_function_gradients_match_jax_vjp(shape):
    """(T, B, H, seed); H=64 is the cluster K2-bwd's smallest hidden size
    on the card, B=17 a ragged second row tile."""
    prim, cot = _lstm_case(*shape)
    out_j, vjp = jax.vjp(_bidir_core_scan, *map(jnp.asarray, prim))
    g_j = vjp(tuple(map(jnp.asarray, cot)))
    ins = [T(a).requires_grad_(i in (0, 1, 4)) for i, a in enumerate(prim)]
    out_t = tlstm.bidir_lstm(*ins)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(N(a), np.asarray(b), atol=1e-5)
    g_t = torch.autograd.grad(out_t, [ins[0], ins[1], ins[4]],
                              list(map(T, cot)))
    for a, i in zip(g_t, (0, 1, 4)):
        np.testing.assert_allclose(N(a), np.asarray(g_j[i]), atol=1e-5)


def test_k2_bwd_twin_equals_autograd_through_the_forward_twin():
    prim, cot = _lstm_case(9, 4, 16, 3)
    ins = [T(a).requires_grad_(i in (0, 1, 4)) for i, a in enumerate(prim)]
    out = tlstm.bidir_lstm_time_loop_plain(*ins)
    want = torch.autograd.grad(out, [ins[0], ins[1], ins[4]],
                               list(map(T, cot)))
    got = tlstm.bidir_lstm_time_loop_bwd_plain(
        *map(T, prim), out[0].detach(), out[1].detach(), *map(T, cot))
    for a, b in zip(got, want):
        np.testing.assert_allclose(N(a), N(b), atol=1e-5)


def test_k2_function_is_the_plain_call_without_grad():
    prim, _ = _lstm_case(5, 2, 8, 4)
    ins = [T(a).requires_grad_(i in (0, 1, 4)) for i, a in enumerate(prim)]
    with torch.no_grad():
        out = tlstm.bidir_lstm(*ins)
    assert all(o.grad_fn is None for o in out)
    ref = tlstm.bidir_lstm_time_loop_plain(*map(T, prim))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    out = tlstm.bidir_lstm(*ins)
    with pytest.raises(RuntimeError):
        g = torch.autograd.grad(out[0].sum(), ins[4], create_graph=True)[0]
        torch.autograd.grad(g.sum(), ins[0])
    # bf16: the gradients are the bf16 twin's, in bf16, and the outputs
    # the loss does not reach give it bf16 zeros as their cotangents
    ins16 = [t.detach().to(torch.bfloat16).requires_grad_(t.requires_grad)
             for t in ins]
    out16 = tlstm.bidir_lstm(*ins16)
    assert all(o.dtype == torch.bfloat16 for o in out16)
    gy = torch.linspace(-1, 1, out16[0].numel()).view_as(out16[0]).to(
        torch.bfloat16)
    got = torch.autograd.grad(out16[0], [ins16[0], ins16[1], ins16[4]], gy)
    zs = torch.zeros_like(out16[2])
    want = tlstm.bidir_lstm_time_loop_bwd_plain(
        *(t.detach() for t in ins16), out16[0].detach(), out16[1].detach(),
        gy, torch.zeros_like(gy), zs, zs)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert float(got[0].float().abs().max()) > 0
