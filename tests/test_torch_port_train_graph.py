"""PyTorch port, the compiled train step (``train/step.py``
``CompiledStep``, JAX's jitted train step with params and optimizer state
donated) and ``Trainer.evaluate`` through ``greedy_decode_jit``, on the
CPU, where the compiled step runs its code eagerly and writes the new
state into the trainer's tensors.

* the port's ``Trainer.fit`` against JAX's over steps that cross two
  (T, S) buckets, ADAM with LR ramp-up, no BatchNorm, ``ss`` = 0 (JAX
  draws its coins from ``jax.random``): loss 1e-5 relative at every step,
  final params 2e-5 absolute (PERF.md section 2's f32 bounds);
* with ``ss`` > 0 the compiled step equals the eager ``train_step`` bit
  for bit, and leaves the coins' generator where the eager step does;
* the state tensors keep their identity across steps, and ``set_lr`` and
  ``resume`` write into them;
* ``evaluate`` decodes through ``greedy_decode_jit``, with the eager
  greedy's CER.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.train import optim as joptim
from chinese_asr_tpu.train import step as jstep
from chinese_asr_tpu.train.trainer import Trainer as JTrainer
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data import dataset
from chinese_asr_tpu_torch.data.dataset import Batch as TBatch
from chinese_asr_tpu_torch.decode import greedy as tgreedy
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops.metrics import cer
from chinese_asr_tpu_torch.train import optim as toptim
from chinese_asr_tpu_torch.train import step as tstep
from chinese_asr_tpu_torch.train import trainer as ttrainer
from chinese_asr_tpu_torch.train.trainer import Trainer
from chinese_asr_tpu_torch.utils.checkpoint import load_checkpoint
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, N, T, golden_cfg, \
    golden_wav_paths, jax_params_numpy

# (T, S) of each step: two buckets, visited out of order
BUCKETS = [(9, 6), (13, 8), (9, 6), (13, 8), (13, 8)]


def small(config_module, tmp_path, tag, **train):
    """tests/test_torch_port_train.py's small config (an LSTM encoder: no
    BatchNorm), ADAM with a ramp-up over 3 steps."""
    tr = dict(label_smooth=0.1, base_lr=3e-3, l2_decay=1e-4, clip=1.0,
              ramp_up_iters=3, epochs=1, num_eval_steps=1000,
              save_dir=str(tmp_path / tag))
    tr.update(train)
    return (config_module.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("train", **tr))


def make_batch(cfg, seed, B, T_, S):
    """A seeded numpy batch with ragged feature and text lengths."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T_, cfg.audio.feat_dim).astype(np.float32)
    feat_lens = np.full(B, T_, np.int32)
    text_lens = np.full(B, S, np.int32)
    feat_lens[1:] = rng.randint(T_ // 2, T_ + 1, B - 1)
    feats[np.arange(T_)[None, :] >= feat_lens[:, None]] = 0.0
    text_lens[1:] = rng.randint(2, S + 1, B - 1)
    text = rng.randint(4, cfg.vocab.vocab_size, size=(B, S - 1))
    tokens_in = np.concatenate([np.full((B, 1), cfg.vocab.sos), text], 1)
    tokens_out = np.concatenate([text, np.full((B, 1), cfg.vocab.eos)], 1)
    for b in range(B):
        tokens_out[b, text_lens[b] - 1] = cfg.vocab.eos
        tokens_out[b, text_lens[b]:] = cfg.vocab.pad
        tokens_in[b, text_lens[b]:] = cfg.vocab.pad
    return (feats, feat_lens, tokens_in.astype(np.int32),
            tokens_out.astype(np.int32), text_lens)


def batches(cfg, B=4):
    return [make_batch(cfg, i, B, t, s) for i, (t, s) in enumerate(BUCKETS)]


def spy_losses(tr):
    """Record each step's loss from the trainer's step function."""
    losses, orig = [], tr._step_fn

    def wrapped(*a):
        out = orig(*a)
        losses.append(float(out[2]["loss"]))
        return out

    tr._step_fn = wrapped
    return losses


def state_tensors(tr):
    return tlas.tree_leaves(tr.params) + list(tr.opt_state.values())


# --------------------------------------------------------------------------
# Trainer.fit against JAX's
# --------------------------------------------------------------------------
def test_fit_over_two_buckets_matches_jax(tmp_path):
    cfg_j = small(jcfg, tmp_path, "jax")
    cfg_t = small(tcfg, tmp_path, "torch")
    pj = jlas.init_params(jax.random.PRNGKey(0), cfg_j)
    nbs = batches(cfg_t)

    jtr = JTrainer(cfg_j, pj)
    jlosses = spy_losses(jtr)
    jtr.fit(lambda: iter([jstep.Batch(*map(jnp.asarray, nb)) for nb in nbs]),
            None, max_steps=len(nbs))

    tr = Trainer(cfg_t, tlas.params_from_numpy(jax_params_numpy(pj)),
                 device="cpu")
    assert isinstance(tr._step_fn, tstep.CompiledStep)
    tlosses = spy_losses(tr)
    tr.fit(lambda: iter([TBatch(*map(T, nb)) for nb in nbs]), None,
           max_steps=len(nbs))

    assert len(tlosses) == len(jlosses) == len(BUCKETS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tr.tv.step == jtr.tv.step == len(BUCKETS)
    assert toptim.get_lr(tr.opt_state) == joptim.get_lr(jtr.opt_state)
    flat_t = toptim.flatten(tr.params)
    flat_j = toptim.flatten(jax.tree_util.tree_map(np.asarray, jtr.params))
    assert flat_t.keys() == flat_j.keys()
    moved = 0.0
    for n in flat_t:
        np.testing.assert_allclose(N(flat_t[n]), flat_j[n], rtol=0,
                                   atol=2e-5, err_msg=n)
        moved = max(moved, float(np.abs(flat_j[n] - np.asarray(
            toptim.flatten(pj)[n])).max()))
    assert moved > 1e-3          # the steps moved the params past the bound


# --------------------------------------------------------------------------
# the compiled step against the eager one, scheduled sampling on
# --------------------------------------------------------------------------
def test_compiled_step_with_scheduled_sampling_equals_eager_train_step(
        tmp_path):
    cfg = small(tcfg, tmp_path, "ss", ss=0.4)
    tx = toptim.make_optimizer(cfg.train)
    p_c = tlas.init_params(cfg, 3)
    o_c = tx.init(p_c)
    p_e = tlas.tree_map(torch.clone, p_c)
    o_e = tx.init(p_e)
    g_c = torch.Generator().manual_seed(7)
    g_e = torch.Generator().manual_seed(7)
    step = tstep.CompiledStep(cfg, tx)
    ids = [id(t) for t in tlas.tree_leaves(p_c) + list(o_c.values())]
    for nb in batches(cfg):
        b = TBatch(*map(T, nb))
        p, o, m_c = step(p_c, o_c, b, g_c)
        assert p is p_c and o is o_c
        p_e, o_e, m_e = tstep.train_step(p_e, o_e, cfg, tx, b, g_e)
        assert torch.equal(m_c["loss"], m_e["loss"])
        assert torch.equal(m_c["grad_norm"], m_e["grad_norm"])
        assert torch.equal(m_c["accuracy"], m_e["accuracy"])
        # the coins came out of the generator alike
        assert torch.equal(g_c.get_state(), g_e.get_state())
    assert ids == [id(t) for t in tlas.tree_leaves(p_c) + list(o_c.values())]
    for a, b in zip(tlas.tree_leaves(p_c), tlas.tree_leaves(p_e)):
        assert torch.equal(a, b)
    assert o_c.keys() == o_e.keys()
    for k in o_c:
        assert torch.equal(o_c[k], o_e[k]), k


def test_coins_are_drawn_as_the_eager_step_draws_them():
    """``draw_coins`` consumes the generator as the eager forward did:
    one [S, B] uniform draw, compared with ``ss``."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    coins = tstep.draw_coins(g1, 6, 4, 0.25)
    want = torch.rand((6, 4), generator=g2) < 0.25
    assert coins.dtype == torch.bool and torch.equal(coins, want)
    assert torch.equal(g1.get_state(), g2.get_state())


# --------------------------------------------------------------------------
# the state stays put
# --------------------------------------------------------------------------
def test_state_keeps_its_tensors_and_set_lr_and_resume_write_in_place(
        tmp_path):
    cfg = small(tcfg, tmp_path, "ck")
    params0 = tlas.init_params(cfg, 0)
    tr = Trainer(cfg, params0, device="cpu")
    # the trainer's copy, not the caller's tensors
    assert all(a is not b and a.data_ptr() != b.data_ptr() for a, b in
               zip(tlas.tree_leaves(tr.params), tlas.tree_leaves(params0)))
    before = [(id(t), t.data_ptr()) for t in state_tensors(tr)]
    lr_t = tr.opt_state["learning_rate"]
    first = tlas.tree_map(torch.clone, tr.params)
    nbs = batches(cfg)
    tr.fit(lambda: iter([TBatch(*map(T, nb)) for nb in nbs]), None,
           max_steps=len(nbs))
    assert [(id(t), t.data_ptr()) for t in state_tensors(tr)] == before
    assert not all(torch.equal(a, b) for a, b in
                   zip(tlas.tree_leaves(tr.params), tlas.tree_leaves(first)))
    # the ramp-up reached base_lr through the same tensor
    assert tr.opt_state["learning_rate"] is lr_t
    assert float(lr_t) == pytest.approx(cfg.train.base_lr)
    assert toptim.set_lr(tr.opt_state, 1e-4) is tr.opt_state
    assert tr.opt_state["learning_rate"] is lr_t and float(lr_t) == \
        pytest.approx(1e-4)
    ckpt = tr.ckpt.latest_checkpoint()
    assert ckpt is not None

    tr2 = Trainer(cfg, tlas.init_params(cfg, 1), device="cpu")
    before2 = [(id(t), t.data_ptr()) for t in state_tensors(tr2)]
    assert tr2.resume(ckpt)
    assert [(id(t), t.data_ptr()) for t in state_tensors(tr2)] == before2
    saved = load_checkpoint(ckpt)
    for (path, a), (_, b) in zip(tlas.tree_paths(saved["params"]),
                                 tlas.tree_paths(tr2.params)):
        np.testing.assert_array_equal(a, N(b), err_msg=str(path))
    for k, v in saved["opt_state"].items():
        np.testing.assert_array_equal(np.asarray(v), N(tr2.opt_state[k]),
                                      err_msg=k)
    assert toptim.get_lr(tr2.opt_state) == pytest.approx(tr2.tv.lr)

    # a checkpoint of another model does not fit the trainer's tensors
    wide = cfg.with_("decoder", hidden_size=48)
    tr3 = Trainer(wide, tlas.init_params(wide, 0), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        tr3.resume(ckpt)


# --------------------------------------------------------------------------
# evaluate through greedy_decode_jit
# --------------------------------------------------------------------------
def test_evaluate_decodes_through_greedy_decode_jit(tmp_path, monkeypatch):
    cfg = golden_cfg(tcfg).with_("train", eval_batch_size=4,
                                 save_dir=str(tmp_path / "ck"))
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        want = json.load(f)["modes"]["greedy"]
    # reference texts the model gets partly wrong
    refs = [w[::-1] or CHARS[i] for i, w in enumerate(want)]
    utts = [dataset.Utterance(p, r) for p, r in zip(golden_wav_paths(),
                                                    refs)]
    mpath = str(tmp_path / "m.tsv")
    dataset.write_manifest(mpath, utts)
    params = tlas.params_from_numpy(
        load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"])
    tr = Trainer(cfg, params, vocab, device="cpu")

    calls = []
    jit = ttrainer.greedy_decode_jit

    def spy(*a, **kw):
        calls.append(a[2].shape)
        return jit(*a, **kw)

    def eager(*a, **kw):
        raise AssertionError("Trainer.evaluate called the eager greedy")

    monkeypatch.setattr(ttrainer, "greedy_decode_jit", spy)
    monkeypatch.setattr(ttrainer, "greedy_decode", eager)

    def loader():
        return dataset.batches_to_device(
            dataset.make_eval_loader(mpath, cfg, vocab), cfg, "cpu")

    got = tr.evaluate(loader())
    assert len(calls) == 2                       # batches of 4 and 2
    monkeypatch.undo()

    # the eager greedy's CER over the same batches, weighted by rows
    cers, rows, texts = [], [], []
    for b in loader():
        res = tgreedy.greedy_decode(tr.params, cfg, b.feats, b.feat_lens)
        out = tgreedy.finalize_greedy(res, vocab)
        ref = [refs[len(texts) + i] for i in range(len(out.pred_text))]
        texts += out.pred_text
        cers.append(np.mean([cer(p, r) for p, r in zip(out.pred_text,
                                                        ref)]))
        rows.append(len(ref))
    assert texts == want
    assert got == pytest.approx(float(np.average(cers, weights=rows)),
                                abs=1e-12)
    assert 0 < got < 1


def test_memory_tool_keys_are_the_loaders(tmp_path):
    """``tools/step_memory.py``'s keys of an epoch (rows, padded samples,
    padded tokens) are those the port's train loader makes of the same
    lengths, batch by batch in its order; and its corpus model is
    AISHELL-1's size."""
    from chinese_asr_tpu_torch.data import audio_io
    from chinese_asr_tpu_torch.tools import step_memory

    rng = np.random.RandomState(3)
    n = 30
    samples = rng.randint(800, 20000, n)
    chars = rng.randint(1, 12, n)
    utts = []
    for i in range(n):
        path = str(tmp_path / f"{i}.wav")
        audio_io.write_wav(path, (rng.randn(samples[i]) * 1000)
                           .astype(np.int16))
        text = "".join(CHARS[j % len(CHARS)] for j in range(chars[i]))
        utts.append(dataset.Utterance(path, text))
    manifest = str(tmp_path / "m.tsv")
    dataset.write_manifest(manifest, utts)
    cfg = tcfg.Config().with_("train", batch_size=4, shuffle_updates=2)
    vocab = Vocab.build([CHARS], max_num_words=len(CHARS))
    got = [(len(wl), wm.shape[1], ti.shape[1]) for wm, wl, ti, _, _ in
           dataset.make_train_loader(manifest, cfg, vocab, seed=0)]
    assert got == step_memory.epoch_keys(cfg, samples.astype(np.int64),
                                         chars.astype(np.int64), seed=0)
    assert len(set(got)) > 2 and got[-1][0] == n % 4
    s, c = step_memory.corpus()
    assert len(s) == step_memory.UTTERANCES == 120_098
    assert 140 < s.sum() / step_memory.RATE / 3600 < 160      # ~150 h
