"""PyTorch port: the LM-driven first pass (``decode/lm_fused.py``, its
host-loop oracle ``decode/lm_first_pass.py``, ``ASR(lm_mode="first")``)
against the JAX package, on random letter LMs of orders 3 and 5 at the
sizes of tests/test_lm_fused.py (bw 2 and 4), and on the golden shard.

Both sides get the same numpy features and the JAX weights, and both
build the hashed device tables through their C++ readers (``from_path``),
so they number words alike.  Tolerances:
* fused decode, port against JAX: tokens, lengths, counts and the stop
  step exact; scores (f32 sums of the same LM terms) within 1e-5;
* host loop, port against JAX: the same C++ scores summed in f64 in the
  same order, so scores equal to 1e-9 and tokens exact;
* fused (f32) against host (f64): tokens exact, scores within 2e-4, the
  bound of tests/test_lm_fused.py.
"""

import functools
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import lm_first_pass as jfirst
from chinese_asr_tpu.decode import lm_fused as jfused
from chinese_asr_tpu.lm import device_ngram as jdn
from chinese_asr_tpu.lm import ngram as jngram
from chinese_asr_tpu.models import las as jlas
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.decode import lm_first_pass as tfirst
from chinese_asr_tpu_torch.decode import lm_fused as tfused
from chinese_asr_tpu_torch.lm import device_ngram as tdn
from chinese_asr_tpu_torch.lm import ngram as tngram
from chinese_asr_tpu_torch.models import las as tlas
from chinese_asr_tpu_torch.vocab import Vocab

from test_lm_binary import ARPA_TRI
from torch_port_util import (CHARS, GOLD, N, T, golden_cfg,
                             golden_wav_paths, jax_params_numpy)

LETTERS = "abcdefgh"
ATOL_FUSED = 1e-5
ATOL_HOST = 2e-4
KLM = os.path.join(os.path.dirname(GOLD), "data", "golden_tri_probing.klm")


def _small(config_module):
    """tests/test_lm_fused.py's SMALL config, from either package."""
    return (config_module.Config()
            .with_("audio", n_mels=8, delta_delta=False, downsample=False)
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=8)
            .with_("decode", max_len=5))


def _letter_vocab():
    return Vocab.build([LETTERS * 3], max_num_words=8)


def _letter_arpa(path, rng, order, n_per_order=25):
    """A random ARPA of ``order`` over the letter vocab: every letter a
    unigram, some without backoffs, higher orders with pruned holes (an
    n-gram's context need not be listed) and eos mass, so the LM both
    backs off and harvests at staggered steps."""
    def lp(lo=-4.0, hi=-0.05):
        return round(float(rng.uniform(lo, hi)), 4)

    letters = list(LETTERS)
    grams = {1: [f"{lp()}\t<unk>", f"{lp()}\t<s>\t{lp(-1, -0.1)}",
                 f"{lp(-1.0, -0.2)}\t</s>"]}
    for ch in letters:
        bo = f"\t{lp(-1, -0.1)}" if rng.rand() < 0.8 else ""
        grams[1].append(f"{lp()}\t{ch}{bo}")
    for o in range(2, order + 1):
        seen, grams[o] = set(), []
        for _ in range(n_per_order):
            key = ((str(rng.choice(letters + ["<s>"])),)
                   + tuple(str(rng.choice(letters)) for _ in range(o - 2))
                   + (str(rng.choice(letters + ["</s>"])),))
            if key in seen:
                continue
            seen.add(key)
            bo = f"\t{lp(-1, -0.1)}" if o < order and rng.rand() < 0.7 else ""
            grams[o].append(f"{lp()}\t{' '.join(key)}{bo}")
    lines = ["\\data\\"] + [f"ngram {o}={len(grams[o])}"
                            for o in range(1, order + 1)] + [""]
    for o in range(1, order + 1):
        lines += [f"\\{o}-grams:"] + grams[o] + [""]
    lines += ["\\end\\", ""]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return path


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """order -> (path, jax NgramLM, port NgramLM, jax dlm, port dlm, jax
    tok2lm, port tok2lm), both device LMs hashed through from_path."""
    d = tmp_path_factory.mktemp("lm_first")
    vocab = _letter_vocab()
    out = {}
    for order, seed in ((3, 11), (5, 12)):
        path = _letter_arpa(str(d / f"o{order}.arpa"),
                            np.random.RandomState(seed), order)
        jd = jdn.DeviceNgramLM.from_path(path)
        td = tdn.DeviceNgramLM.from_path(path, "cpu")
        assert jd.hashed and td.hashed
        table = td.token_id_table(vocab)
        np.testing.assert_array_equal(table, jd.token_id_table(vocab))
        out[order] = (path, jngram.NgramLM(path), tngram.NgramLM(path), jd,
                      td, jnp.asarray(table), T(table).long())
    return out


@functools.lru_cache(maxsize=None)
def _model(seed, B):
    """(jax cfg, port cfg, jax params, port params, jax feats/lens, port
    feats/lens): random weights and features from ``seed``."""
    cj, ct = _small(jcfg), _small(tcfg)
    jp = jlas.init_params(jax.random.PRNGKey(seed), cj)
    tp = tlas.params_from_numpy(jax_params_numpy(jp), device="cpu")
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 7, cj.audio.feat_dim).astype(np.float32)
    lens = np.full(B, 7, np.int32)
    lens[-1] = 4
    return (cj, ct, jp, tp, (jnp.asarray(x), jnp.asarray(lens)),
            (T(x), T(lens)))


# (LM order, bw, topn, seed): bw 2 and 4 at orders 3 and 5
CASES = [(3, 2, 6, 0), (3, 4, 8, 1), (5, 2, 6, 5), (5, 4, 8, 3)]


def _fused(lms, order, bw, topn, seed, legacy=False):
    _, _, _, jd, td, jt, tt = lms[order]
    cj, ct, jp, tp, (jx, jl), (tx, tl) = _model(seed, 3)
    want = jfused.lm_fused_decode(jp, cj, bw, jx, jl, jd, jt, topn=topn,
                                  legacy_select=legacy)
    got = tfused.lm_fused_decode(tp, ct, bw, tx, tl, td, tt, topn=topn)
    return got, want


def _assert_nbest(got, want, atol):
    assert len(got) == len(want)
    for hg, hw in zip(got, want):
        assert [ids for ids, _ in hg] == [ids for ids, _ in hw]
        np.testing.assert_allclose([s for _, s in hg], [s for _, s in hw],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("order,bw,topn,seed", CASES)
def test_fused_decode_matches_jax(lms, order, bw, topn, seed):
    got, want = _fused(lms, order, bw, topn, seed)
    assert got.l_final == int(want.l_final)
    for f in ("fin_tokens", "fin_lens", "fin_count", "live_tokens"):
        np.testing.assert_array_equal(N(getattr(got, f)),
                                      N(getattr(want, f)).astype(np.int32),
                                      err_msg=f)
    for f in ("fin_scores", "live_scores"):
        a, b = N(getattr(got, f)), N(getattr(want, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)],
                                   rtol=0, atol=ATOL_FUSED, err_msg=f)
    assert N(got.fin_count).sum() > 0, "no hypothesis finished"


@pytest.mark.parametrize("order,bw,topn,seed", CASES)
def test_fused_decode_matches_jax_legacy_body(lms, order, bw, topn, seed):
    """JAX's first-cut step body (``legacy_select``, not ported) as a
    second oracle of the same n-best lists."""
    got, want = _fused(lms, order, bw, topn, seed, legacy=True)
    _assert_nbest(tfused.nbest_lists(got), jfused.nbest_lists(want),
                  ATOL_FUSED)


@pytest.mark.parametrize("incremental", [True, False])
@pytest.mark.parametrize("order,bw,topn,seed", CASES)
def test_host_loop_matches_jax_and_fused(lms, order, bw, topn, seed,
                                         incremental):
    """The port's host loop against JAX's, and the port's fused decode's
    ``nbest_lists`` against both, on the incremental state path and on
    the full-prefix string path."""
    _, jlm, tlm, *_ = lms[order]
    cj, ct, jp, tp, (jx, jl), (tx, tl) = _model(seed, 3)
    vocab = _letter_vocab()
    want = jfirst.lm_first_pass_decode(jp, cj, bw, jx, jl, jlm, vocab,
                                       topn=topn, incremental=incremental)
    got = tfirst.lm_first_pass_decode(tp, ct, bw, tx, tl, tlm, vocab,
                                      topn=topn, incremental=incremental)
    _assert_nbest(got, want, 1e-9)
    fused, _ = _fused(lms, order, bw, topn, seed)
    _assert_nbest(tfused.nbest_lists(fused), want, ATOL_HOST)


def test_select_best_first_pass_matches_nbest_top(lms):
    """The winner picked on the device == ``nbest_lists(res)[b][0]``, also
    with nothing finished (the live beam-0 fallback, score 0)."""
    _, _, _, _, td, _, tt = lms[3]
    _, ct, _, tp, _, (tx, tl) = _model(8, 4)
    res = tfused.lm_fused_decode(tp, ct, 3, tx, tl, td, tt, topn=6)
    never = res._replace(fin_scores=torch.full_like(res.fin_scores,
                                                    float("-inf")),
                         fin_count=torch.zeros_like(res.fin_count))
    for r in (res, never):
        best = tfused.select_best_first_pass(r)
        for b, hyps in enumerate(tfused.nbest_lists(r)):
            ids, score = hyps[0]
            assert N(best.tokens)[b, : int(best.lens[b])].tolist() == ids
            assert float(best.scores[b]) == pytest.approx(score, abs=1e-6)
            assert bool(best.finished[b]) == (r is res and
                                              int(r.fin_count[b]) > 0)


def test_transcribe_lm_first_pass_and_profile(lms):
    _, jlm, tlm, *_ = lms[3]
    cj, ct, jp, tp, (jx, jl), (tx, tl) = _model(5, 3)
    vocab = _letter_vocab()
    prof = {}
    got = tfirst.lm_first_pass_decode(tp, ct, 2, tx, tl, tlm, vocab,
                                      topn=6, profile=prof)
    assert got == tfirst.lm_first_pass_decode(tp, ct, 2, tx, tl, tlm,
                                              vocab, topn=6)
    assert {"encode_prologue", "pull_top", "lm_score", "select",
            "reorder_dispatch", "harvest", "steps"} <= set(prof)
    assert 1 <= prof["steps"] <= ct.decode.max_len
    assert (tfirst.transcribe_lm_first_pass(tp, ct, 2, tx, tl, tlm, vocab,
                                            topn=6)
            == jfirst.transcribe_lm_first_pass(jp, cj, 2, jx, jl, jlm,
                                               vocab, topn=6))


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)["modes"]


def _golden_asr(lm_path, lm_mode, vocab=None, **kw):
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg),
                    vocab=vocab or Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", bw=4, lm_path=lm_path, lm_mode=lm_mode,
                    **kw)


@pytest.mark.parametrize("fmt", ["arpa", "probing", "trie"])
def test_golden_lm_first_exact(expected, tmp_path, fmt):
    """Golden ``lm_first`` (bw 4, topn 8) through ``ASR(device="cpu")``,
    from the ARPA and from ``.klm`` copies of it in two layouts."""
    path = os.path.join(GOLD, "lm.arpa")
    if fmt != "arpa":
        out = str(tmp_path / f"golden_{fmt}.klm")
        tngram.NgramLM(path).write_binary(out, layout=fmt)
        path = out
    asr = _golden_asr(path, "first", lm_topn=8)
    assert asr.dlm.hashed and asr.lm is None
    got = asr.transcribe_files(golden_wav_paths())
    assert got == expected["lm_first"]
    assert got != expected["beam_bw4"]


@pytest.mark.parametrize("lm_mode", ["second", "second_host", "first"])
def test_klm_fixture_equals_its_arpa(tmp_path, lm_mode):
    """The committed ``.klm`` fixture and the ARPA text it was built from
    give the same transcripts in every LM mode, with a vocab whose first
    two characters are the LM's words."""
    arpa = tmp_path / "tri.arpa"
    arpa.write_text(ARPA_TRI, encoding="utf-8")
    w2i = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "a": 4, "b": 5}
    for i, ch in enumerate(CHARS[2:]):
        w2i[ch] = 6 + i
    vocab = Vocab(w2i, {i: w for w, i in w2i.items()})
    texts = [_golden_asr(p, lm_mode, vocab=vocab, lm_topn=8)
             .transcribe_files(golden_wav_paths()) for p in (KLM, str(arpa))]
    assert texts[0] == texts[1]
    assert any("a" in t or "b" in t for t in texts[0])


def test_lm_first_without_a_compiler(expected, lms, monkeypatch):
    """Without the C++ reader, as JAX does: ``NgramLM`` falls back to the
    pure-Python ARPA scorer (no batch states: the host loop takes the
    string path), ``from_path`` builds the tuple layout, a ``.klm`` raises,
    and golden ``lm_first`` is still exact."""
    monkeypatch.setattr(tngram, "_lib_cache", {"lib": None, "tried": True})
    path = os.path.join(GOLD, "lm.arpa")
    lm = tngram.load_lm(path)
    assert lm._py is not None and not lm.has_batch_states
    assert lm.score("的 一 是") == tngram.PyNgramLM(path).score("的 一 是")
    with pytest.raises(ValueError, match="C\\+\\+ toolchain"):
        tngram.NgramLM(KLM)
    asr = _golden_asr(path, "first", lm_topn=8)
    assert not asr.dlm.hashed
    assert asr.transcribe_files(golden_wav_paths()) == expected["lm_first"]
    # the host loop's string path over the fallback scorer, against JAX's
    # incremental path over its C++ reader
    path3, jlm = lms[3][0], lms[3][1]
    cj, ct, jp, tp, (jx, jl), (tx, tl) = _model(6, 3)
    want = jfirst.lm_first_pass_decode(jp, cj, 2, jx, jl, jlm,
                                       _letter_vocab(), topn=6)
    got = tfirst.lm_first_pass_decode(tp, ct, 2, tx, tl,
                                      tngram.NgramLM(path3),
                                      _letter_vocab(), topn=6)
    _assert_nbest(got, want, 1e-6)
