"""PyTorch port: the compiled decode entry points (``*_jit``) and the
guarded decode loop behind them, on the CPU (where a ``*_jit`` form runs
the guarded loop eagerly; the CUDA-graph replay is
tests/test_torch_port_cuda.py's).

* The guarded loops (``BeamLoop`` with and without the LM track,
  ``GreedyLoop``, ``LmFusedLoop``, run by ``utils.graphs.run_loop``) with
  ``unroll`` in {1, 3, 40} equal the breaking loop -- the eager Python
  loop that reads the stop flag every step and breaks, kept below as the
  oracle -- in every result field, ``l_final`` included: on the golden
  shard's overfit model, which stops early (so the frozen steps run), and
  at seeded random weights.
* ``beam_decode(unroll=3)`` equals JAX's ``beam_decode(unroll=3)``.
* The golden shard's five modes through the ``*_jit`` forms reproduce
  ``expected.json``.
* Only a step after the first of its chunk is guarded (at ``unroll=1``
  none but the beam's stopping rule); the program cache evicts by the
  bytes its programs hold, then by count; ``clone_tree`` copies every
  leaf.

Tolerances: the guarded and the breaking loop run the same operations on
the same inputs, so every field is compared exactly (``torch.equal``).
Against JAX as tests/test_torch_port_decode.py: tokens, lengths, counts
and ``l_final`` exact, scores to 1e-4 (f32 reductions in other orders).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.utils.checkpoint import load_checkpoint as jload
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data import audio_io
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.decode import greedy as tgreedy
from chinese_asr_tpu_torch.decode import lm_fused as tlmf
from chinese_asr_tpu_torch.decode import rescore as trescore
from chinese_asr_tpu_torch.lm import device_ngram as tdlm
from chinese_asr_tpu_torch.models import decoder as dec_ops
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.ops.cuda import topk as topk_k
from chinese_asr_tpu_torch.ops.rnn import map_state
from chinese_asr_tpu_torch.utils import graphs
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import (CHARS, GOLD, N, golden_cfg, golden_wav_paths,
                             random_wavs, small_cfg)

ATOL_SCORE = 1e-4
# lm_fused's proposals a beam: the golden vocab has 12 tokens, and at 4
# the golden model stops early in this mode too
TOPN = {"golden": 4, "random": 8}


# --------------------------------------------------------------------------
# the oracle: the breaking loops (one host read of the stop flag a step,
# ``break`` at the stop), as the port ran them before the guarded step
# --------------------------------------------------------------------------
def _tile_cell(eb, dcfg, feats, n, k):
    cell = eb.init_cell_state
    if cell is None:
        return dec_ops.zero_cell_state(dcfg, feats, n)
    return map_state(lambda e: e.repeat_interleave(k, dim=0), cell)


def _pack(fin_tokens, fin_scores, hist, live_scores, l_final):
    B, max_len, k = fin_scores.shape
    cap = k * max_len
    fin_scores = fin_scores.reshape(B, cap)
    return tbeam.BeamResult(
        fin_tokens=fin_tokens.reshape(B, cap, max_len),
        fin_lens=torch.arange(max_len, dtype=torch.int32).repeat_interleave(
            k)[None, :].expand(B, cap),
        fin_scores=fin_scores,
        fin_count=torch.isfinite(fin_scores).sum(dim=1).to(torch.int32),
        live_tokens=hist[:, 1:].reshape(B, k, max_len).to(torch.int32),
        live_scores=live_scores.reshape(B, k),
        l_final=torch.tensor(l_final, dtype=torch.int32))


@torch.no_grad()
def breaking_beam(params, cfg, k, feats, feat_lens, lm_track=None):
    B, V, max_len = feats.shape[0], cfg.vocab.vocab_size, cfg.decode.max_len
    cand, eos = 2 * k, cfg.vocab.eos
    dcfg, acfg = cfg.decoder, cfg.attention
    eb = las.encode(params, cfg, feats, feat_lens)
    cell = _tile_cell(eb, dcfg, feats, B * k, k)
    hist = torch.full((B * k, max_len + 1), cfg.vocab.pad, dtype=torch.int64)
    hist[:, 0] = cfg.vocab.sos
    logp_scores = torch.zeros(B * k)
    attn_hidden = feats.new_zeros(
        (B * k, dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])))
    top_beam_finished = torch.zeros(B, dtype=torch.bool)
    fin_tokens = torch.zeros((B, max_len, k, max_len), dtype=torch.int32)
    fin_scores = torch.full((B, max_len, k), float("-inf"))
    l_final = max_len - 1
    if lm_track is not None:
        dlm, tok2lm, lm_bos, lm_eos = lm_track
        lm_ctx = torch.full((B * k, max(dlm.order - 1, 1)), -1,
                            dtype=torch.int64)
        if dlm.order > 1:
            lm_ctx[:, -1] = lm_bos
        lm_cum = torch.zeros(B * k)
        fin_lm = torch.zeros((B, max_len, k))
        eos_col = torch.full((B * k, 1), lm_eos, dtype=torch.int64)
    for l in range(max_len):
        out = dec_ops.decoder_step_beam(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, hist[:, l], cell, attn_hidden)
        logit = out.logit.to(torch.float32) / dcfg.temperature
        logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
        logp = logp + logp_scores[:, None]
        if l == 0:
            logp.view(B, k, V)[:, 1:] = float("-inf")
        v1, t1 = topk_k.top_k(logp, k + 1)
        cand_scores, i2 = tbeam._stable_top(v1.reshape(B, k * (k + 1)), cand)
        cand_beams = torch.div(i2, k + 1, rounding_mode="floor")
        cand_tokens = torch.gather(t1.reshape(B, k * (k + 1)), 1,
                                   i2).to(torch.int64)
        top_tokens = cand_tokens[:, :k]
        fmask = top_tokens == eos
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens[:, l] = tbeam._rows(hist3, cand_beams[:, :k])[:, :, 1:].to(
            torch.int32)
        fin_scores[:, l] = torch.where(fmask, cand_scores[:, :k],
                                       float("-inf"))
        if lm_track is not None:
            eos_base = tdlm.score_candidates(dlm, lm_ctx, eos_col)[:, 0]
            lm_tot = (lm_cum + eos_base).reshape(B, k)
            fin_lm[:, l] = torch.where(
                fmask, torch.gather(lm_tot, 1, cand_beams[:, :k]), 0.0)
        top_beam_finished |= top_tokens[:, 0] == eos
        if bool(top_beam_finished.all()):
            l_final = l
            break
        rank = (torch.arange(cand)[None, :]
                + (cand_tokens == eos).to(torch.int64) * cand)
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)
        k_toks = torch.gather(cand_tokens, 1, active)
        logp_scores = torch.gather(cand_scores, 1, active).reshape(-1)
        hist = tbeam._rows(hist3, k_beams).reshape(B * k, max_len + 1)
        hist[:, l + 1] = k_toks.reshape(-1)

        def reorder(t):
            return tbeam._rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        cell = map_state(reorder, out.cell_state)
        attn_hidden = reorder(out.attn_hidden_state)
        if lm_track is not None:
            ctx_sel = reorder(lm_ctx)
            chosen = tok2lm[k_toks.reshape(-1)]
            base = tdlm.score_candidates(dlm, ctx_sel, chosen[:, None])
            lm_cum = reorder(lm_cum[:, None])[:, 0] + base[:, 0]
            lm_ctx = tdlm.advance_context(ctx_sel, chosen)
    res = _pack(fin_tokens, fin_scores, hist, logp_scores, l_final)
    if lm_track is not None:
        return res, fin_lm.reshape(B, -1)
    return res


@torch.no_grad()
def breaking_greedy(params, cfg, feats, feat_lens):
    B, max_len = feats.shape[0], cfg.decode.max_len
    dcfg, acfg = cfg.decoder, cfg.attention
    eb = las.encode(params, cfg, feats, feat_lens)
    cell = _tile_cell(eb, dcfg, feats, B, 1)
    tokens = torch.full((B,), cfg.vocab.sos, dtype=torch.int64)
    attn_hidden = feats.new_zeros(
        (B, dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])))
    finished = torch.zeros(B, dtype=torch.bool)
    final_lens = torch.zeros(B, dtype=torch.int32)
    accum = torch.zeros(B)
    out = torch.full((B, max_len), cfg.vocab.pad, dtype=torch.int32)
    align = feats.new_zeros((B, max_len, eb.enc_out.shape[1]))
    for l in range(max_len):
        step = dec_ops.decoder_step(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, tokens, cell, attn_hidden)
        logit = step.logit.to(torch.float32)
        logp = logit - torch.logsumexp(logit, dim=1, keepdim=True)
        lp, tok = torch.max(logp, dim=1)
        cur_fin = tok == cfg.vocab.eos
        accum = accum + torch.where(~finished & cur_fin, lp,
                                    torch.zeros_like(lp))
        finished = finished | cur_fin
        final_lens = final_lens + (~finished).to(torch.int32)
        accum = accum + torch.where(~finished, lp, torch.zeros_like(lp))
        out[:, l] = tok.to(torch.int32)
        align[:, l, :] = (step.alignment if acfg.heads == 1
                          else step.alignment[..., 0])
        tokens, cell, attn_hidden = tok, step.cell_state, \
            step.attn_hidden_state
        if bool(finished.all()):
            break
    return tgreedy.GreedyResult(out, final_lens, accum, finished, align)


@torch.no_grad()
def breaking_lm_fused(params, cfg, k, feats, feat_lens, dlm, tok2lm, topn):
    B, max_len = feats.shape[0], cfg.decode.max_len
    cand, eos, pool_w = 2 * k, cfg.vocab.eos, k * topn
    dcfg, acfg = cfg.decoder, cfg.attention
    eb = las.encode(params, cfg, feats, feat_lens)
    cell = _tile_cell(eb, dcfg, feats, B * k, k)
    attn_hidden = feats.new_zeros(
        (B * k, dec_ops.attn_hidden_width(acfg, eb.values.shape[-1])))
    hist = torch.full((B * k, max_len + 1), cfg.vocab.pad, dtype=torch.int64)
    hist[:, 0] = cfg.vocab.sos
    cum = torch.zeros(B * k)
    lm_ctx = torch.full((B * k, max(dlm.order - 1, 1)), -1, dtype=torch.int64)
    has_finished = torch.zeros(B, dtype=torch.bool)
    fin_tokens = torch.zeros((B, max_len, k, max_len), dtype=torch.int32)
    fin_scores = torch.full((B, max_len, k), float("-inf"))
    l_final = max_len - 1
    for l in range(max_len):
        out = dec_ops.decoder_step_beam(
            params["decoder"], params["attention"], dcfg, acfg, eb.mask,
            eb.keys, eb.values, hist[:, l], cell, attn_hidden)
        _, top = topk_k.top_k(out.logit.to(torch.float32), topn)
        top_toks = torch.sort(top.to(torch.int64), dim=1).values
        base = tdlm.score_candidates(dlm, lm_ctx, tok2lm[top_toks])
        pool_sc = (cum[:, None] + base).reshape(B, pool_w)
        pool_tok = top_toks.reshape(B, pool_w)
        if l == 0:
            pool_sc[:, topn:] = float("-inf")
        cand_scores, i2 = tbeam._stable_top(pool_sc, cand)
        cand_beams = torch.div(i2, topn, rounding_mode="floor")
        cand_toks = torch.gather(pool_tok, 1, i2)
        fmask = cand_toks[:, :k] == eos
        hist3 = hist.reshape(B, k, max_len + 1)
        fin_tokens[:, l] = tbeam._rows(hist3, cand_beams[:, :k])[:, :, 1:].to(
            torch.int32)
        fin_scores[:, l] = torch.where(fmask, cand_scores[:, :k],
                                       float("-inf"))
        has_finished |= fmask.any(dim=1)
        rank = (torch.arange(cand)[None, :]
                + (cand_toks == eos).to(torch.int64) * cand)
        active = torch.argsort(rank, dim=1)[:, :k]
        k_beams = torch.gather(cand_beams, 1, active)
        k_toks = torch.gather(cand_toks, 1, active)
        cum = torch.gather(cand_scores, 1, active).reshape(-1)

        def reorder(t):
            return tbeam._rows(t.reshape(B, k, -1), k_beams).reshape(B * k, -1)

        hist = tbeam._rows(hist3, k_beams).reshape(B * k, max_len + 1)
        hist[:, l + 1] = k_toks.reshape(-1)
        lm_ctx = tdlm.advance_context(reorder(lm_ctx),
                                      tok2lm[k_toks.reshape(-1)])
        cell = map_state(reorder, out.cell_state)
        attn_hidden = reorder(out.attn_hidden_state)
        if bool(has_finished.all()):
            l_final = l
            break
    return _pack(fin_tokens, fin_scores, hist, cum, l_final)


# --------------------------------------------------------------------------
# models and inputs
# --------------------------------------------------------------------------
def _golden_asr(**kw):
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg),
                    vocab=Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", **kw)


def _golden_feats(asr):
    wavs = [audio_io.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    scales = [audio_io.peak_scale(w) for w in wavs]
    return asr._featurize(asr._upload(asr._prep(wavs, scales)))


@pytest.fixture(scope="module")
def models():
    """name -> (params, cfg, feats, lens, dlm, tok2lm): the golden overfit
    model on the golden shard (stops early) and a seeded random model of
    the flagship front end on three random wavs."""
    golden = _golden_asr()
    rand = tapi.ASR(cfg=small_cfg(tcfg), device="cpu", seed=3)
    rng = np.random.default_rng(11)
    out = {}
    for name, asr, feats in (
            ("golden", golden, _golden_feats(golden)),
            ("random", rand, rand._featurize(rand._upload(rand._prep(
                random_wavs(rng, [16000, 9000, 12500]), None))))):
        dlm = tdlm.DeviceNgramLM.from_path(os.path.join(GOLD, "lm.arpa"),
                                           "cpu")
        tok2lm = torch.from_numpy(dlm.token_id_table(asr.vocab)).long()
        out[name] = (asr.params, asr.cfg, *feats, dlm, tok2lm)
    return out


def _assert_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    elif hasattr(want, "_fields"):
        for name, w in want._asdict().items():
            assert torch.equal(getattr(got, name), w), name
    else:
        for g, w in zip(got, want):
            _assert_equal(g, w)


def _bos_eos(dlm):
    return tuple(int(x) for x in dlm.word_ids(["<s>", "</s>"]))


@pytest.mark.parametrize("unroll", [1, 3, 40])
@pytest.mark.parametrize("model", ["golden", "random"])
@pytest.mark.parametrize("mode", ["beam", "beam_lm_track", "greedy",
                                  "lm_fused"])
def test_guarded_loop_equals_breaking_loop(models, mode, model, unroll):
    params, cfg, feats, lens, dlm, tok2lm = models[model]
    bw = 4 if model == "golden" else 3
    track = (dlm, tok2lm, *_bos_eos(dlm))
    if mode == "beam":
        got = tbeam.beam_decode(params, cfg, bw, feats, lens, unroll=unroll)
        want = breaking_beam(params, cfg, bw, feats, lens)
    elif mode == "beam_lm_track":
        got = tbeam.beam_decode(params, cfg, bw, feats, lens,
                                lm_track=track, unroll=unroll)
        want = breaking_beam(params, cfg, bw, feats, lens, lm_track=track)
    elif mode == "greedy":
        got = tgreedy.greedy_decode(params, cfg, feats, lens, unroll=unroll)
        want = breaking_greedy(params, cfg, feats, lens)
    else:
        got = tlmf.lm_fused_decode(params, cfg, bw, feats, lens, dlm,
                                   tok2lm, TOPN[model], unroll=unroll)
        want = breaking_lm_fused(params, cfg, bw, feats, lens, dlm, tok2lm,
                                 TOPN[model])
    _assert_equal(got, want)
    if model == "golden":
        # the overfit model stops early: the frozen steps ran
        if mode == "greedy":
            assert bool(got.finished.all())
            assert bool((got.tokens[:, -1] == cfg.vocab.pad).all())
        else:
            res = got[0] if mode == "beam_lm_track" else got
            assert int(res.l_final) < cfg.decode.max_len - 1


def test_beam_decode_unroll_equals_jax():
    """``beam_decode(unroll=3)`` against JAX's ``beam_decode(unroll=3)``
    on the golden model and shard (features made by the port, fed to
    both)."""
    asr = _golden_asr()
    feats, lens = _golden_feats(asr)
    cj = golden_cfg(jcfg)
    jp = jax.tree_util.tree_map(
        jnp.asarray, jload(os.path.join(GOLD, "model.ckpt"))["params"])
    jr = jax.jit(lambda p, f, n: jbeam.beam_decode(p, cj, 4, f, n, unroll=3))(
        jp, jnp.asarray(N(feats)), jnp.asarray(N(lens)))
    tr = tbeam.beam_decode(asr.params, asr.cfg, 4, feats, lens, unroll=3)
    assert int(tr.l_final) == int(jr.l_final) < cj.decode.max_len - 1
    for f in ("fin_count", "fin_lens", "live_tokens"):
        np.testing.assert_array_equal(N(getattr(tr, f)),
                                      N(getattr(jr, f)).astype(np.int32),
                                      err_msg=f)
    js, ts = N(jr.fin_scores), N(tr.fin_scores)
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), finite)
    np.testing.assert_allclose(ts[finite], js[finite], rtol=0,
                               atol=ATOL_SCORE)
    np.testing.assert_array_equal(N(tr.fin_tokens)[finite],
                                  N(jr.fin_tokens).astype(np.int32)[finite])
    np.testing.assert_allclose(N(tr.live_scores), N(jr.live_scores), rtol=0,
                               atol=ATOL_SCORE)


@pytest.mark.parametrize("mode", ["greedy", "beam_bw4", "lm_second",
                                  "lm_second_host", "lm_first"])
def test_golden_modes_through_jit_forms(mode):
    """Each mode's ``*_jit`` entry point, called directly on the golden
    features, reproduces ``expected.json``; on the CPU no program is
    cached."""
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"][mode]
    asr = _golden_asr()
    feats, lens = _golden_feats(asr)
    cfg, p, vocab, dc = asr.cfg, asr.params, asr.vocab, asr.cfg.decode
    dlm = tdlm.DeviceNgramLM.from_path(os.path.join(GOLD, "lm.arpa"), "cpu")
    tok2lm = torch.from_numpy(dlm.token_id_table(vocab)).long()
    bos, eos = _bos_eos(dlm)
    if mode == "greedy":
        texts = tgreedy.finalize_greedy(
            tgreedy.greedy_decode_jit(p, cfg, feats, lens), vocab).pred_text
    elif mode == "lm_second_host":
        from chinese_asr_tpu_torch.lm import ngram
        texts = tbeam.finalize_beam(
            tbeam.compact_nbest(tbeam.beam_decode_jit(p, cfg, 4, feats,
                                                      lens)),
            cfg, vocab, lm_model=ngram.load_lm(os.path.join(GOLD, "lm.arpa")),
            second_pass=True, lm_weight=dc.lm_weight,
            length_weight=dc.length_weight).pred_text
    else:
        if mode == "beam_bw4":
            best = tbeam.beam_decode_best_jit(p, cfg, 4, feats, lens)
        elif mode == "lm_second":
            best = trescore.beam_rescored_best_jit(
                p, cfg, 4, feats, lens, dlm, tok2lm, dc.lm_weight,
                dc.length_weight, bos, eos)
            # the evaluation form: the decode, then the rescore apart
            again = trescore.rescore_select_jit(
                tbeam.compact_nbest(tbeam.beam_decode_jit(p, cfg, 4, feats,
                                                          lens)),
                dlm, tok2lm, dc.lm_weight, dc.length_weight, bos, eos)
            assert tbeam.finalize_best(again, vocab).pred_text == expected
        else:
            best = tlmf.lm_fused_decode_best_jit(p, cfg, 4, feats, lens, dlm,
                                                 tok2lm, 8)
        texts = tbeam.finalize_best(best, vocab).pred_text
    assert texts == expected
    assert graphs.programs() == []


def test_tree_helpers_and_keys():
    """``where_tree`` selects leaf by leaf over nested state, ``copy_tree``
    writes into the destination's tensors, and ``tensor_ids`` changes when
    a leaf is rebound to a new tensor (a new program)."""
    flag = torch.tensor(True)
    old = {"a": torch.zeros(2), "c": [(torch.zeros(1), torch.ones(1))]}
    new = {"a": torch.ones(2), "c": [(torch.ones(1), torch.zeros(1))]}
    got = graphs.where_tree(flag, old, new)
    assert torch.equal(got["a"], old["a"])
    assert torch.equal(got["c"][0][1], old["c"][0][1])
    got = graphs.where_tree(~flag, old, new)
    assert torch.equal(got["c"][0][0], new["c"][0][0])
    dst_a = old["a"]
    graphs.copy_tree(old, new)
    assert old["a"] is dst_a and torch.equal(dst_a, torch.ones(2))
    params = {"w": torch.zeros(3), "cells": [{"b": torch.ones(2)}]}
    key = graphs.tensor_ids(params)
    assert graphs.tensor_ids(params) == key
    params["cells"][0]["b"] = params["cells"][0]["b"] + 1
    assert graphs.tensor_ids(params) != key
    with pytest.raises(ValueError):
        graphs.run_loop(None, (), 0)


@pytest.mark.parametrize("mode", ["beam", "greedy", "lm_fused"])
def test_only_steps_inside_a_chunk_are_guarded(models, mode, monkeypatch):
    """``step(s, l, guard)`` gets ``guard`` only for a step after the
    first of its chunk (the host read before a chunk found the loop
    running), so at ``unroll=1`` no ``done`` guard runs: the beam keeps
    only its stopping rule (``new_done``), the others no selection at
    all.  At ``unroll=3`` the other steps are guarded."""
    params, cfg, feats, lens, dlm, tok2lm = models["golden"]
    loops = {"beam": tbeam.BeamLoop, "greedy": tgreedy.GreedyLoop,
             "lm_fused": tlmf.LmFusedLoop}
    seen, flags = [], []
    step = loops[mode].step

    def spy(self, s, l, guard=True):
        seen.append((l, guard))
        return step(self, s, l, guard)

    where = graphs.where_tree
    depth = [0]

    def spy_where(flag, old, new):      # the step's calls, not the nested
        if depth[0] == 0:
            flags.append(flag)
        depth[0] += 1
        try:
            return where(flag, old, new)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(loops[mode], "step", spy)
    monkeypatch.setattr(graphs, "where_tree", spy_where)
    for unroll in (1, 3):
        seen.clear()
        flags.clear()
        if mode == "beam":
            tbeam.beam_decode(params, cfg, 4, feats, lens, unroll=unroll)
        elif mode == "greedy":
            tgreedy.greedy_decode(params, cfg, feats, lens, unroll=unroll)
        else:
            tlmf.lm_fused_decode(params, cfg, 4, feats, lens, dlm, tok2lm,
                                 TOPN["golden"], unroll=unroll)
        assert [g for _, g in seen] == [l % unroll > 0 for l, _ in seen]
        guarded = [f for f in flags if f is not None]
        if unroll == 1:
            # the beam's survivors, held at its stopping step, one a step
            assert len(guarded) == (len(seen) if mode == "beam" else 0)
        else:
            assert len(guarded) > len(seen)


class _Prog:
    def __init__(self, nbytes):
        self.reserved_bytes = nbytes


@pytest.mark.parametrize("case", [
    # (programs' bytes oldest first, budget, max programs, bytes left)
    ([10, 20, 30, 40], 75, 8, [30, 40]),       # over the budget
    ([1, 1, 1, 1, 1], 100, 3, [1, 1, 1]),      # over the count
    ([10, 500], 100, 8, [500]),                # the newest always stays
    ([10, 20], 30, 2, [10, 20]),               # at the bound: none go
], ids=["bytes", "count", "newest_stays", "at_bound"])
def test_cache_evicts_least_recent_by_bytes_then_count(case):
    """``graphs.evict`` drops the least recently used programs until the
    rest hold at most the byte budget and number at most the count."""
    sizes, budget, most, left = case
    from collections import OrderedDict
    cache = OrderedDict((i, _Prog(n)) for i, n in enumerate(sizes))
    newest = list(cache)[-1]
    gone = graphs.evict(cache, budget, most)
    assert [p.reserved_bytes for p in cache.values()] == left
    assert gone == len(sizes) - len(left) and newest in cache


def test_clone_tree_copies_every_leaf():
    """The ``*_jit`` forms return ``clone_tree`` of the graphs' outputs:
    new tensors of equal value, named tuples and nesting kept."""
    res = tgreedy.GreedyResult(*(torch.arange(3) + i for i in range(5)))
    out = graphs.clone_tree((res, {"x": [torch.ones(2)]}, 7))
    got, tree, seven = out
    assert type(got) is tgreedy.GreedyResult and seven == 7
    for a, b in zip(got, res):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert torch.equal(tree["x"][0], torch.ones(2))
