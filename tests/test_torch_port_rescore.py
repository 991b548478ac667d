"""PyTorch port: the LM second pass (``decode/rescore.py``, the beam's
passive LM track, ``compact_nbest``/``finalize_beam``) against the JAX
package, on the golden shard's overfit model and trigram LM.

Tolerances: LM totals are sums of f32 log10 terms taken in another order
(the beam's running left fold vs a post-hoc sum, and across frameworks),
so they are compared at atol 2e-4, the JAX package's own bound between
its device and host second passes.  Winners, tokens, lengths and counts
are compared exactly: the overfit model decides every step by a wide
margin.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.decode import rescore as jrescore
from chinese_asr_tpu.lm import device_ngram as jdn
from chinese_asr_tpu.lm import ngram as jngram
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.decode import rescore as trescore
from chinese_asr_tpu_torch.lm import device_ngram as tdn
from chinese_asr_tpu_torch.lm import ngram as tngram
from chinese_asr_tpu_torch.vocab import Vocab

from test_lm import _random_arpa
from test_torch_port_decode import golden  # noqa: F401  (fixture)
from torch_port_util import CHARS, GOLD, N, T, golden_cfg, golden_wav_paths

ATOL_LM = 2e-4
LM = os.path.join(GOLD, "lm.arpa")


def _vocab():
    return Vocab.build([CHARS * 3], max_num_words=8)


@pytest.fixture(scope="module")
def lms():
    """(jax DeviceNgramLM, torch DeviceNgramLM, jax tok2lm, torch tok2lm,
    bos, eos) for the golden LM: the tuple layout on both sides."""
    j = jdn.DeviceNgramLM.from_arpa(LM)
    t = tdn.DeviceNgramLM.from_arpa(LM, "cpu")
    table = t.token_id_table(_vocab())
    np.testing.assert_array_equal(table, j.token_id_table(_vocab()))
    bos, eos = (int(x) for x in t.word_ids(["<s>", "</s>"]))
    return j, t, jnp.asarray(table), T(table).long(), bos, eos


@pytest.mark.parametrize("seed", [0, 1])
def test_score_sequences_match_jax_and_host(tmp_path, seed):
    """Full-sentence scores incl. the empty hypothesis (</s> alone) and
    OOV words, orders 2-5, against JAX and PyNgramLM.score."""
    rng = np.random.RandomState(30 + seed)
    for idx, order in enumerate([None, None, 4, 5]):
        path, vocab_w = _random_arpa(
            tmp_path, rng, 10 * seed + idx, order=order,
            nvocab=None if order is None else 30,
            n_per_order=None if order is None else 150)
        py = tngram.PyNgramLM(path)
        t = tdn.DeviceNgramLM.from_arpa(path, "cpu")
        j = jdn.DeviceNgramLM.from_arpa(path)
        bos, eos = (int(x) for x in t.word_ids(["<s>", "</s>"]))
        words = vocab_w + ["oovword", "<unk>"]
        Q, L = 9, 6
        lens = rng.randint(0, L + 1, Q).astype(np.int32)
        lens[0] = 0
        sents = [[py._vocab_map(str(rng.choice(words))) for _ in range(L)]
                 for _ in range(Q)]
        toks = np.stack([t.word_ids(s) for s in sents]).astype(np.int32)
        got = trescore.score_sequences(t, T(toks), T(lens), bos, eos)
        want = jrescore.score_sequences(j, jnp.asarray(toks),
                                        jnp.asarray(lens), bos, eos)
        np.testing.assert_allclose(N(got), N(want), rtol=0, atol=ATOL_LM)
        for q in range(Q):
            assert float(got[q]) == pytest.approx(
                py.score(" ".join(sents[q][: lens[q]])), abs=ATOL_LM)


@pytest.mark.parametrize("bw", [2, 4])
def test_tracked_beam_matches_jax(golden, lms, bw):  # noqa: F811
    """beam_decode(lm_track=...): the acoustic n-best is that of the
    untracked decode and of JAX's, and fin_lm matches JAX's harvest."""
    cj, ct, jp, tp, feats, flens = golden
    jl, tl, jt, tt, bos, eos = lms
    jr, jfin = jbeam.beam_decode(jp, cj, bw, jnp.asarray(feats),
                                 jnp.asarray(flens), use_pallas=False,
                                 lm_track=(jl, jt, bos, eos))
    tr, tfin = tbeam.beam_decode(tp, ct, bw, T(feats), T(flens),
                                 lm_track=(tl, tt, bos, eos))
    plain = tbeam.beam_decode(tp, ct, bw, T(feats), T(flens))
    for a, b in zip(tr, plain):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert tr.l_final == int(jr.l_final)
    np.testing.assert_array_equal(N(tr.fin_count), N(jr.fin_count))
    finite = np.isfinite(N(jr.fin_scores))
    np.testing.assert_array_equal(np.isfinite(N(tr.fin_scores)), finite)
    assert finite.any()
    np.testing.assert_array_equal(N(tr.fin_tokens)[finite],
                                  N(jr.fin_tokens).astype(np.int32)[finite])
    assert tfin.shape == tr.fin_scores.shape
    np.testing.assert_allclose(N(tfin), N(jfin), rtol=0, atol=ATOL_LM)
    assert (N(tfin)[~finite] == 0).all()
    # the harvested totals are the post-hoc full-sentence scores
    toks = tt[tr.fin_tokens.long()].reshape(-1, tr.fin_tokens.shape[2])
    post = trescore.score_sequences(tl, toks, tr.fin_lens.reshape(-1),
                                    bos, eos).reshape(tfin.shape)
    np.testing.assert_allclose(N(tfin)[finite], N(post)[finite], rtol=0,
                               atol=ATOL_LM)


@pytest.mark.parametrize("bw", [2, 4])
def test_selection_and_host_finalize_pick_jax_winners(golden, lms, bw):  # noqa: F811
    cj, ct, jp, tp, feats, flens = golden
    jl, tl, jt, tt, bos, eos = lms
    w_lm, w_len = ct.decode.lm_weight, ct.decode.length_weight
    vocab = _vocab()
    jr, jfin = jbeam.beam_decode(jp, cj, bw, jnp.asarray(feats),
                                 jnp.asarray(flens), use_pallas=False,
                                 lm_track=(jl, jt, bos, eos))
    tr, tfin = tbeam.beam_decode(tp, ct, bw, T(feats), T(flens),
                                 lm_track=(tl, tt, bos, eos))
    jb = jrescore.select_rescored(jr, jfin, w_lm, w_len)
    tb = trescore.select_rescored(tr, tfin, w_lm, w_len)
    for name in ("tokens", "lens", "finished"):
        np.testing.assert_array_equal(N(getattr(tb, name)),
                                      N(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(N(tb.scores), N(jb.scores), rtol=0,
                               atol=1e-4)
    # the post-hoc device rescore on the compacted n-best picks the same
    tc, jc = tbeam.compact_nbest(tr, bucket=4), jbeam.compact_nbest(
        jr, bucket=4)
    assert tc.fin_scores.shape == jc.fin_scores.shape
    np.testing.assert_array_equal(N(tc.fin_lens), N(jc.fin_lens))
    post = trescore.rescore_select(tc, tl, tt, w_lm, w_len, bos, eos)
    np.testing.assert_array_equal(N(post.tokens), N(tb.tokens))
    # the host second pass (PyNgramLM's string path) on both sides
    th = tbeam.finalize_beam(tc, ct, vocab, lm_model=tngram.PyNgramLM(LM),
                             second_pass=True, lm_weight=w_lm,
                             length_weight=w_len)
    jh = jbeam.finalize_beam(jc, cj, vocab, lm_model=jngram.NgramLM(LM),
                             second_pass=True, lm_weight=w_lm,
                             length_weight=w_len)
    assert th.pred_text == jh.pred_text
    assert th.pred_text == tbeam.finalize_best(tb, vocab).pred_text
    np.testing.assert_allclose(th.score, jh.score, rtol=0, atol=1e-4)
    # without the second pass: the raw-logp winner, as select_best picks
    plain = tbeam.finalize_beam(tr, ct, vocab)
    assert plain.pred_text == tbeam.finalize_best(
        tbeam.select_best(tr, w_len), vocab).pred_text


def test_crafted_nbest_len0_and_live_fallback(lms):
    """A length-0 finished hypothesis (scored as </s> after <s>), the LM
    overruling the raw-logp leader, and a sample with nothing finished
    (the live fallback): device rescore == host finalize == JAX."""
    jl, tl, jt, tt, bos, eos = lms
    cfg_j, cfg_t = golden_cfg(jcfg), golden_cfg(tcfg)
    vocab = _vocab()
    B, cap, L, k = 2, 4, cfg_t.decode.max_len, 2
    rng = np.random.RandomState(9)
    fin_tokens = np.zeros((B, cap, L), np.int32)
    fin_tokens[0, 1, :2] = [4, 5]
    fin_tokens[0, 2, :3] = [6, 4, 7]
    fin_lens = np.zeros((B, cap), np.int32)
    fin_lens[0] = [0, 2, 3, 0]
    fin_scores = np.full((B, cap), -np.inf, np.float32)
    fin_scores[0, :3] = [-1.0, -0.5, -0.55]
    live_tokens = rng.randint(4, 12, (B, k, L)).astype(np.int32)
    live_scores = np.array([[-2.0, -1.0], [-3.0, -0.25]], np.float32)
    count = np.array([3, 0], np.int32)
    tr = tbeam.BeamResult(T(fin_tokens), T(fin_lens), T(fin_scores),
                          T(count), T(live_tokens), T(live_scores), L - 2)
    jr = jbeam.BeamResult(*(jnp.asarray(a) for a in (
        fin_tokens, fin_lens, fin_scores, count, live_tokens, live_scores)),
        jnp.int32(L - 2))
    w_lm, w_len = cfg_t.decode.lm_weight, cfg_t.decode.length_weight
    dev = tbeam.finalize_best(trescore.rescore_select(
        tr, tl, tt, w_lm, w_len, bos, eos), vocab)
    host = tbeam.finalize_beam(tr, cfg_t, vocab,
                               lm_model=tngram.PyNgramLM(LM),
                               second_pass=True, lm_weight=w_lm,
                               length_weight=w_len)
    jax_dev = jbeam.finalize_best(jrescore.rescore_select(
        jr, jl, jt, w_lm, w_len, bos, eos), vocab)
    assert dev.pred_text == host.pred_text == jax_dev.pred_text
    np.testing.assert_allclose(dev.score, host.score, atol=ATOL_LM)
    np.testing.assert_allclose(dev.score, jax_dev.score, atol=1e-6)


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)["modes"]


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("lm_mode", ["second", "second_host"])
def test_golden_lm_modes_reproduced(expected, lm_mode, fused, monkeypatch):
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", fused)
    asr = tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                   cfg=golden_cfg(tcfg), vocab=_vocab(), device="cpu", bw=4,
                   lm_path=LM, lm_mode=lm_mode)
    assert (asr.dlm is not None) == (lm_mode == "second")
    assert (asr.lm is not None) == (lm_mode == "second_host")
    got = asr.transcribe_files(golden_wav_paths())
    assert got == expected["lm_" + lm_mode]
    assert got != expected["beam_bw4"]            # the LM changed rows


def test_lm_loads_only_for_beams_and_cli(capsys):
    """main.py:78-84: no LM for greedy; the CLI's --lm/--lm-mode."""
    asr = tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", bw=1, lm_path=LM)
    assert asr.dlm is None and asr.lm is None
    with pytest.raises(ValueError, match="lm_mode"):
        tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", bw=4, lm_path=LM,
                 lm_mode="third")
    tapi.main(["--wav", golden_wav_paths()[0], "--bw", "2", "--device",
               "cpu", "--lm", LM, "--lm-mode", "second"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split("\t")[0] == golden_wav_paths()[0]
    # the LM-driven first pass, and a KenLM binary
    klm = os.path.join(os.path.dirname(GOLD), "data",
                       "golden_tri_probing.klm")
    for lm in (LM, klm):
        tapi.main(["--wav", golden_wav_paths()[0], "--bw", "2", "--device",
                   "cpu", "--lm", lm, "--lm-mode", "first"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.split("\t")[0] == golden_wav_paths()[0]
