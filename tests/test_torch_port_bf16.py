"""PyTorch port: bf16 inference (``compute_dtype="bfloat16"``) against the
JAX package, on the CPU (K2's bf16 twin, K3's and K4's twins).

* The overfit model of tests/test_bf16.py (the same cached fixture,
  recipe ``bf16_overfit_v1``, carried over by ``params_from_numpy``):
  port bf16 greedy and beam (bw 4, 8) tokens, lengths and n-best sets
  equal JAX's bf16 and f32; the scores stay float32 and within 0.1 of
  f32 (the JAX test's bound).
* K2's bf16 twin against JAX's bf16 ``_bidir_core_scan``.  JAX rounds
  every op of the step to bf16; the twin computes the step in f32 and
  rounds y, h and c once at its end (K2-bf16's rounding points).  Over
  these shapes they differ by at most 7.8e-3 (2 bf16 ulps of values in
  [1, 2)); stated atol 1.6e-2.  The twin sits closer to f32 than the
  scan: measured <= 3.7e-3 against the f32 twin where the scan reads
  <= 9.1e-3; stated bound 8e-3.
* ``ASR(compute_dtype="bfloat16", device="cpu")`` on the golden shard,
  greedy and beam_bw4, equals JAX's bf16 ASR on the CPU, and both equal
  ``expected.json``; ``lm_first`` given JAX's bf16 encoder output gives
  JAX's transcripts.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import ml_dtypes
import torch

from chinese_asr_tpu.api import ASR as JASR
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.decode import greedy as jgreedy
from chinese_asr_tpu.ops import rnn as jrnn
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.decode import greedy as tgreedy
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.ops.cuda import lstm as tlstm
from chinese_asr_tpu_torch.ops.cuda import topk as ttopk
from chinese_asr_tpu_torch.vocab import Vocab

from test_bf16 import _cast, overfit  # noqa: F401  (the shared fixture)
from torch_port_util import (CHARS, GOLD, N, golden_cfg, golden_wav_paths,
                             jax_params_numpy)

SCORE_DRIFT = 0.1          # |bf16 - f32| of a decode's f32 scores
ATOL_K2_VS_SCAN = 1.6e-2
ATOL_K2_VS_F32 = 8e-3


def _port(overfit):  # noqa: F811
    """(port cfg, port bf16 params, bf16 feats, lens) of the fixture."""
    cfg, params, feats, lens = overfit
    ct = tcfg.Config.from_json(cfg.to_json())
    tp = tlas.params_from_numpy(jax_params_numpy(params), device="cpu",
                                dtype=torch.bfloat16)
    tf = torch.from_numpy(np.array(feats)).to(torch.bfloat16)
    return ct, tp, tf, torch.from_numpy(np.array(lens))


def test_params_from_numpy_casts_floating_leaves_only():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {"a": w, "b": w.astype(ml_dtypes.bfloat16),
            "n": np.arange(4, dtype=np.int32)}
    bf = tlas.params_from_numpy(tree, dtype=torch.bfloat16)
    # bf16 leaves carry across bit for bit; f32 leaves round to nearest
    assert bf["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["b"].view(torch.int16).numpy(),
        np.asarray(tree["b"]).view(np.int16))
    np.testing.assert_array_equal(
        bf["a"].view(torch.int16).numpy(),
        np.asarray(jnp.asarray(w, jnp.bfloat16)).view(np.int16))
    assert bf["n"].dtype == torch.int32
    f32 = tlas.params_from_numpy(tree)
    assert f32["a"].dtype == torch.float32 and f32["n"].dtype == torch.int32
    np.testing.assert_array_equal(f32["b"].numpy(),
                                  np.asarray(tree["b"], np.float32))


def test_bf16_greedy_matches_jax_bf16_and_f32(overfit):  # noqa: F811
    cfg, params, feats, lens = overfit
    j32 = jgreedy.greedy_decode_jit(params, cfg, feats, lens)
    j16 = jgreedy.greedy_decode_jit(_cast(params, jnp.bfloat16), cfg,
                                    feats.astype(jnp.bfloat16), lens)
    ct, tp, tf, tl = _port(overfit)
    t16 = tgreedy.greedy_decode(tp, ct, tf, tl)
    for ref in (j16, j32):
        np.testing.assert_array_equal(N(t16.tokens), N(ref.tokens))
        np.testing.assert_array_equal(N(t16.final_lens), N(ref.final_lens))
    assert t16.scores.dtype == torch.float32        # score math stays f32
    d = np.abs(N(t16.scores) - N(j32.scores))
    assert float(d.max()) < SCORE_DRIFT, f"score drift {d.max()}"


@pytest.mark.parametrize("bw", [4, 8])
def test_bf16_beam_matches_jax_bf16_and_f32(overfit, bw):  # noqa: F811
    cfg, params, feats, lens = overfit
    j32 = jbeam.beam_decode_best_jit(params, cfg, bw, feats, lens)
    j16 = jbeam.beam_decode_best_jit(_cast(params, jnp.bfloat16), cfg, bw,
                                     feats.astype(jnp.bfloat16), lens)
    ct, tp, tf, tl = _port(overfit)
    t16 = tbeam.beam_decode_best(tp, ct, bw, tf, tl)
    for ref in (j16, j32):
        np.testing.assert_array_equal(N(t16.tokens), N(ref.tokens))
        np.testing.assert_array_equal(N(t16.lens), N(ref.lens))
    assert t16.scores.dtype == torch.float32
    s16 = N(t16.scores)
    assert np.isfinite(s16).all(), "bf16 produced non-finite beam scores"
    assert float(np.abs(s16 - N(j32.scores)).max()) < SCORE_DRIFT


def _nbest_sets(res):
    """Per row, the finished hypotheses as a sorted list of (length,
    tokens), and their scores in that order."""
    sc, lens, toks = N(res.fin_scores), N(res.fin_lens), N(res.fin_tokens)
    sets, scores = [], []
    for b in range(sc.shape[0]):
        hyps = sorted((int(lens[b, i]), tuple(int(x) for x in
                                              toks[b, i, :lens[b, i]]),
                       float(sc[b, i]))
                      for i in np.nonzero(np.isfinite(sc[b]))[0])
        sets.append([h[:2] for h in hyps])
        scores.append([h[2] for h in hyps])
    return sets, scores


def test_bf16_nbest_sets_match_jax(overfit):  # noqa: F811
    """The harvested n-best sets (what a second pass rescores) equal JAX's
    bf16 and f32 ones.  Compared as sets: one hypothesis of row 2 is
    harvested at candidate rank 3 of step 5 by the port and at rank 2 by
    JAX (bf16 and f32), a near-tie of two candidates' bf16 scores; it is
    the same hypothesis, and its score is within the drift bound."""
    cfg, params, feats, lens = overfit
    bw = 4
    j32 = jbeam.beam_decode_jit(params, cfg, bw, feats, lens)
    j16 = jbeam.beam_decode_jit(_cast(params, jnp.bfloat16), cfg, bw,
                                feats.astype(jnp.bfloat16), lens)
    ct, tp, tf, tl = _port(overfit)
    t16 = tbeam.beam_decode(tp, ct, bw, tf, tl)
    got, got_sc = _nbest_sets(t16)
    for ref in (j16, j32):
        np.testing.assert_array_equal(N(t16.fin_count), N(ref.fin_count))
        want, want_sc = _nbest_sets(ref)
        assert got == want
    for g, w in zip(got_sc, _nbest_sets(j32)[1]):
        assert np.abs(np.subtract(g, w)).max(initial=0.0) < SCORE_DRIFT


@pytest.mark.parametrize("T,B,H,seed", [(12, 5, 16, 0), (30, 4, 16, 3),
                                        (9, 7, 32, 2)])
def test_bf16_k2_twin_matches_jax_scan(T, B, H, seed):
    rng = np.random.default_rng(seed)
    xg_f = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    xg_b = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    m = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    args = (xg_f, xg_b, m, m[::-1].copy(), w)
    jo = jrnn._bidir_core_scan(*(jnp.asarray(a, jnp.bfloat16) for a in args))
    to = tlstm.bidir_lstm_time_loop(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in args))
    f32 = tlstm.bidir_lstm_time_loop_plain(*(torch.from_numpy(a)
                                             for a in args))
    for name, a, b, ref in zip(("ys_f", "ys_b", "hT", "cT"), to, jo, f32):
        assert a.dtype == torch.bfloat16, name      # outputs in xg's dtype
        got = a.float().numpy()
        np.testing.assert_allclose(got, np.asarray(b, np.float32), rtol=0,
                                   atol=ATOL_K2_VS_SCAN, err_msg=name)
        np.testing.assert_allclose(got, ref.numpy(), rtol=0,
                                   atol=ATOL_K2_VS_F32, err_msg=name)
    # masked steps emit exact zeros
    assert (to[0].float().numpy()[m == 0] == 0.0).all()


def _golden_asr(pkg, **kw):
    if pkg == "jax":
        from test_golden_shard import golden_cfg as jgolden_cfg
        return JASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=jgolden_cfg(),
                    vocab=JVocab.build([CHARS * 3], max_num_words=8), **kw)
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg),
                    vocab=Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", **kw)


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)["modes"]


@pytest.mark.parametrize("mode,bw", [("greedy", None), ("beam_bw4", 4)])
def test_golden_shard_bf16_matches_jax(expected, mode, bw):
    port = _golden_asr("port", bw=bw, compute_dtype="bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in _leaves(port.params))
    got = port.transcribe_files(golden_wav_paths())
    ref = _golden_asr("jax", bw=bw, compute_dtype="bfloat16"
                      ).transcribe_files(golden_wav_paths())
    assert got == ref
    assert got == expected[mode]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("lm_mode,fused", [("second", "0"), ("second", "1"),
                                           ("second_host", "0"),
                                           ("first", "0")])
def test_bf16_feeds_float32_to_the_top_k(expected, monkeypatch, lm_mode,
                                         fused):
    """In bf16 mode the decoder's logits are cast up before K3 and K4
    (JAX's decode casts them too): the kernels see float32.  The LM modes
    run in bf16; the second pass reproduces ``expected.json``."""
    seen = []
    for name in ("top_k", "top_k_fused"):
        real = getattr(ttopk, name)

        def spy(x, *a, _real=real, **k):
            seen.append(x.dtype)
            return _real(x, *a, **k)
        monkeypatch.setattr(ttopk, name, spy)
    monkeypatch.setenv("CHINESE_ASR_PALLAS_FUSED", fused)
    asr = _golden_asr("port", bw=4, compute_dtype="bfloat16",
                      lm_path=os.path.join(GOLD, "lm.arpa"),
                      lm_mode=lm_mode, lm_topn=8)
    got = asr.transcribe_files(golden_wav_paths())
    assert seen and set(seen) == {torch.float32}
    if lm_mode != "first":
        assert got == expected["lm_" + lm_mode]
    else:
        assert len(got) == 6 and all(isinstance(t, str) for t in got)


def test_compute_dtype_is_checked():
    with pytest.raises(ValueError, match="compute_dtype"):
        tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", compute_dtype="fp8")


def test_bf16_lm_first_decodes_jax_encoder_output_as_jax(expected,
                                                         monkeypatch):
    """bf16 ``lm_first`` on the golden shard: the port's first pass,
    given JAX's bf16 encoder output, gives JAX's transcripts.  (On its own
    encoder output the port differs from JAX on one row: K2-bf16's twin
    rounds once a step where JAX's scan rounds every op, and the LM-driven
    pass picks among 8 of 12 bf16 logits, where near-ties are common:
    row 5, and only row 5, may differ.)"""
    from chinese_asr_tpu.models import encoder as jenc
    from chinese_asr_tpu_torch.data import audio_io as taudio
    from chinese_asr_tpu_torch.models import encoder as tenc
    kw = dict(bw=4, compute_dtype="bfloat16", lm_mode="first", lm_topn=8,
              lm_path=os.path.join(GOLD, "lm.arpa"))
    ja = _golden_asr("jax", **kw)
    wavs = [taudio.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    scales = [taudio.peak_scale(w) for w in wavs]
    feats, flens = ja._featurize_flat_device(
        *ja._upload_flat(ja._prep_flat(wavs, scales)))
    enc = jenc.apply_encoder(ja.params["encoder"], ja.cfg, feats, flens)
    out = torch.from_numpy(np.asarray(enc.out, np.float32)).to(torch.bfloat16)
    state = tuple(torch.from_numpy(np.asarray(s, np.float32)).to(
        torch.bfloat16) for s in enc.state)
    real = tenc.apply_encoder

    def jax_encoder(p, cfg, x, lens, train=False, bn_updates=None):
        got = real(p, cfg, x, lens, train, bn_updates)
        assert got.out.shape == out.shape
        return got._replace(out=out, state=state)
    port = _golden_asr("port", **kw)
    want = ja.transcribe_wavs(wavs, scales=scales)
    own = port.transcribe_wavs(wavs, scales=scales)
    monkeypatch.setattr(tenc, "apply_encoder", jax_encoder)
    got = port.transcribe_wavs(wavs, scales=scales)
    assert got == want
    assert {i for i, (a, b) in enumerate(zip(own, want)) if a != b} <= {5}
