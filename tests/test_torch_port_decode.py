"""PyTorch port: decoder step, greedy and beam decode against the JAX
package, with JAX weights carried over by ``params_from_numpy`` and the
same numpy features fed to both (CPU; the beam's stage-1 top-k is K3's
plain twin).

Tolerances: logits, scores and alignments are f32 on both sides with
matmul/softmax/logsumexp reductions in different orders, so they agree
to ~1e-6; compared at atol 1e-5 (one step) and 1e-4 (scores accumulated
over a decode).  Tokens, lengths, n-best slots, counts and the stop step
are compared exactly: the golden shard's overfit model decides every
step by a wide margin, so reassociation cannot flip a choice.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.audio import features as jfeat
from chinese_asr_tpu.data import audio_io as jaudio
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.decode import greedy as jgreedy
from chinese_asr_tpu.models import decoder as jdec
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu.utils.checkpoint import load_checkpoint as jload
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.decode import greedy as tgreedy
from chinese_asr_tpu_torch.models import decoder as tdec
from chinese_asr_tpu_torch.models import las as tlas

from torch_port_util import (GOLD, N, T, golden_cfg, golden_wav_paths,
                             jax_params_numpy, pad_batch, small_cfg)

import os

ATOL_STEP = 1e-5
ATOL_SCORE = 1e-4


@pytest.fixture(scope="module")
def golden():
    """(jax cfg, torch cfg, jax params, torch params, feats, lens) for the
    golden shard's overfit model on its six wavs."""
    cj, ct = golden_cfg(jcfg), golden_cfg(tcfg)
    raw = jload(os.path.join(GOLD, "model.ckpt"))["params"]
    jp = jax.tree_util.tree_map(jnp.asarray, raw)
    tp = tlas.params_from_numpy(raw, device="cpu")
    wavs = [jaudio.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    scales = np.array([jaudio.peak_scale(w) for w in wavs], np.float32)
    mat, lens = pad_batch(wavs, 48000)
    feats, flens = jfeat.featurize_batch(jnp.asarray(mat), jnp.asarray(lens),
                                         cj.audio, norm_eps=1e-6,
                                         scale=jnp.asarray(scales))
    feats = np.asarray(feats)
    flens = np.maximum(np.asarray(flens), 1).astype(np.int32)
    return cj, ct, jp, tp, feats, flens


def _step_inputs(cfg, B, k=None, seed=0):
    rng = np.random.default_rng(seed)
    L, enc = 7, cfg.encoder.enc_size
    rows = B * (k or 1)
    return dict(
        enc_out=rng.standard_normal((B, L, enc)).astype(np.float32),
        lens=np.array([7, 3, 1][:B], np.int32),
        token=rng.integers(0, cfg.vocab.vocab_size, rows).astype(np.int32),
        h=rng.standard_normal((rows, cfg.decoder.hidden_size)).astype(np.float32),
        c=rng.standard_normal((rows, cfg.decoder.hidden_size)).astype(np.float32),
        ahs=rng.standard_normal((rows, enc)).astype(np.float32))


def _prologue(jp, tp, cj, ct, d):
    from chinese_asr_tpu.models import attention as jattn
    from chinese_asr_tpu.ops.masks import softmax_mask as jsm
    from chinese_asr_tpu_torch.models import attention as tattn
    from chinese_asr_tpu_torch.ops.masks import softmax_mask as tsm
    jk, jv = jattn.compute_key_value(jp["attention"], cj.attention,
                                     jnp.asarray(d["enc_out"]))
    tk, tv = tattn.compute_key_value(tp["attention"], ct.attention,
                                     T(d["enc_out"]))
    L = d["enc_out"].shape[1]
    return ((jsm(jnp.asarray(d["lens"]), L), jk, jv),
            (tsm(T(d["lens"]), L), tk, tv))


@pytest.mark.parametrize("beam", [False, True])
def test_decoder_step_matches_jax(beam):
    cj, ct = small_cfg(jcfg), small_cfg(tcfg)
    jp = jlas.init_params(jax.random.PRNGKey(1), cj)
    tp = tlas.params_from_numpy(jax_params_numpy(jp))
    B, k = 3, (4 if beam else None)
    d = _step_inputs(cj, B, k)
    (jm, jk, jv), (tm, tk, tv) = _prologue(jp, tp, cj, ct, d)
    jfn = jdec.decoder_step_beam if beam else jdec.decoder_step
    tfn = tdec.decoder_step_beam if beam else tdec.decoder_step
    jo = jfn(jp["decoder"], jp["attention"], cj.decoder, cj.attention, jm,
             jk, jv, jnp.asarray(d["token"]),
             [(jnp.asarray(d["h"]), jnp.asarray(d["c"]))],
             jnp.asarray(d["ahs"]))
    to = tfn(tp["decoder"], tp["attention"], ct.decoder, ct.attention, tm,
             tk, tv, T(d["token"]).long(), [(T(d["h"]), T(d["c"]))],
             T(d["ahs"]))
    for name in ("logit", "attn_hidden_state", "alignment"):
        np.testing.assert_allclose(N(getattr(to, name)), N(getattr(jo, name)),
                                   rtol=0, atol=ATOL_STEP, err_msg=name)
    for a, b in zip(to.cell_state[0], jo.cell_state[0]):
        np.testing.assert_allclose(N(a), N(b), rtol=0, atol=ATOL_STEP)


def test_greedy_decode_matches_jax(golden):
    cj, ct, jp, tp, feats, flens = golden
    jr = jgreedy.greedy_decode_jit(jp, cj, jnp.asarray(feats),
                                   jnp.asarray(flens))
    tr = tgreedy.greedy_decode(tp, ct, T(feats), T(flens))
    np.testing.assert_array_equal(N(tr.finished), N(jr.finished))
    np.testing.assert_array_equal(N(tr.final_lens), N(jr.final_lens))
    # positions past the batch-wide stop stay <pad> on both sides
    np.testing.assert_array_equal(N(tr.tokens), N(jr.tokens))
    np.testing.assert_allclose(N(tr.scores), N(jr.scores), rtol=0,
                               atol=ATOL_SCORE)
    np.testing.assert_allclose(N(tr.alignments), N(jr.alignments), rtol=0,
                               atol=ATOL_SCORE)
    from chinese_asr_tpu_torch.vocab import Vocab
    vocab = Vocab.build(["的一是不了人我在" * 3], max_num_words=8)
    out = tgreedy.finalize_greedy(tr, vocab)
    ref = jgreedy.finalize_greedy(jr, vocab)
    assert out.pred_text == ref.pred_text
    np.testing.assert_allclose(out.score, ref.score, rtol=0, atol=ATOL_SCORE)


@pytest.mark.parametrize("bw", [2, 4, 8])
def test_beam_decode_and_select_best_match_jax(golden, bw):
    cj, ct, jp, tp, feats, flens = golden
    jr = jbeam.beam_decode_jit(jp, cj, bw, jnp.asarray(feats),
                               jnp.asarray(flens))
    tr = tbeam.beam_decode(tp, ct, bw, T(feats), T(flens))
    assert tr.l_final == int(jr.l_final)
    np.testing.assert_array_equal(N(tr.fin_count), N(jr.fin_count))
    np.testing.assert_array_equal(N(tr.fin_lens), N(jr.fin_lens))
    js, ts = N(jr.fin_scores), N(tr.fin_scores)
    finite = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(ts), finite)
    np.testing.assert_allclose(ts[finite], js[finite], rtol=0,
                               atol=ATOL_SCORE)
    np.testing.assert_array_equal(N(tr.fin_tokens)[finite],
                                  N(jr.fin_tokens).astype(np.int32)[finite])
    np.testing.assert_array_equal(N(tr.live_tokens),
                                  N(jr.live_tokens).astype(np.int32))
    np.testing.assert_allclose(N(tr.live_scores), N(jr.live_scores), rtol=0,
                               atol=ATOL_SCORE)
    jb = jbeam.select_best(jr, cj.decode.length_weight)
    tb = tbeam.select_best(tr, ct.decode.length_weight)
    for name in ("tokens", "lens", "finished"):
        np.testing.assert_array_equal(N(getattr(tb, name)),
                                      N(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(N(tb.scores), N(jb.scores), rtol=0,
                               atol=ATOL_SCORE)


def test_live_fallback_matches_jax(golden):
    """A decode cut at max_len=2 finishes nothing, so every row takes the
    reference's never-finished live-beam fallback (model.py:961-972)."""
    cj, ct, jp, tp, feats, flens = golden
    cj2 = cj.with_("decode", max_len=2)
    ct2 = ct.with_("decode", max_len=2)
    jr = jbeam.beam_decode_jit(jp, cj2, 3, jnp.asarray(feats),
                               jnp.asarray(flens))
    tr = tbeam.beam_decode(tp, ct2, 3, T(feats), T(flens))
    jb = jbeam.select_best(jr, cj2.decode.length_weight)
    tb = tbeam.select_best(tr, ct2.decode.length_weight)
    assert not N(tb.finished).any()
    for name in ("tokens", "lens", "finished"):
        np.testing.assert_array_equal(N(getattr(tb, name)),
                                      N(getattr(jb, name)), err_msg=name)
    np.testing.assert_allclose(N(tb.scores), N(jb.scores), rtol=0,
                               atol=ATOL_SCORE)
