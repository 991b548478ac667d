"""PyTorch port: the n-gram LM (``lm/ngram.py``, ``lm/device_ngram.py``)
against the JAX package on the same random ARPAs.

* ``PyNgramLM`` is a copy: its scores must be equal, not close.
* ``from_arpa`` runs the same numpy build, so its packed tables (narrow
  and wide levels, the dense unigram table, the probe counts) must be
  equal array for array.
* ``score_candidates`` gathers the same table rows and sums the same f32
  terms in the same order as JAX's, so it is compared at 1e-6 against
  JAX's ``from_arpa`` and ``from_path`` LMs (the latter takes the hashed
  key layout, as the port's ``from_path`` does since the C++ reader was
  ported; its scores are the same up to f32 rounding) on orders 2-5, with
  absent (-1) context words and OOV candidates.  The hashed layout itself
  is held against JAX's in tests/test_torch_port_ngram_cpp.py.
* The torch hash (int64 arithmetic) equals ``_hash_np`` bit for bit.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu.lm import device_ngram as jdn
from chinese_asr_tpu.lm import ngram as jngram
from chinese_asr_tpu_torch.lm import device_ngram as tdn
from chinese_asr_tpu_torch.lm import ngram as tngram

from test_lm import _random_arpa
from torch_port_util import GOLD, N, T

import os

ATOL = 1e-6


def _arpas(tmp_path, seed, n=4):
    """Random pruned ARPAs: the small fuzz regime, then orders 4 and 5."""
    rng = np.random.RandomState(seed)
    out = [_random_arpa(tmp_path, rng, seed * 10 + i) for i in range(n)]
    for i, order in enumerate((4, 5)):
        out.append(_random_arpa(tmp_path, rng, seed * 10 + n + i,
                                order=order, nvocab=30, n_per_order=150))
    return rng, out


def _queries(rng, py, word_ids, order, words, Q=24, C=5):
    """(ctx [Q, order-1] with left-padded -1 for short histories, the
    contexts as word tuples, candidates [Q, C], candidate words)."""
    M1 = max(order - 1, 1)
    ctx = np.full((Q, M1), -1, np.int32)
    ctx_w = []
    for q in range(Q):
        n = int(rng.randint(0, order))                 # 0..order-1 words
        picked = [py._vocab_map(str(rng.choice(words))) for _ in range(n)]
        ctx_w.append(tuple(picked))
        if n:
            ctx[q, -n:] = word_ids(picked)
    cand_w = [[py._vocab_map(str(rng.choice(words))) for _ in range(C)]
              for _ in range(Q)]
    cand = np.stack([word_ids(row) for row in cand_w]).astype(np.int32)
    return ctx, ctx_w, cand, cand_w


def test_pyngram_scores_equal_jax(tmp_path):
    _, arpas = _arpas(tmp_path, 1)
    rng = np.random.RandomState(2)
    for path, vocab in arpas:
        tp, jp = tngram.PyNgramLM(path), jngram.PyNgramLM(path)
        assert tp.order == jp.order and tp.grams == jp.grams
        words = vocab + ["oovword", "<unk>", "<s>"]
        for _ in range(20):
            sent = " ".join(str(rng.choice(words))
                            for _ in range(rng.randint(0, 7)))
            for bos in (True, False):
                for eos in (True, False):
                    assert tp.score(sent, bos, eos) == jp.score(sent, bos, eos)


KLMS = [os.path.join(os.path.dirname(GOLD), "data", f"golden_tri_{x}.klm")
        for x in ("probing", "trie", "quant_trie", "quant_array_trie")]


def test_load_lm_and_later_slice_binaries():
    """``load_lm`` returns the C++-backed ``NgramLM`` for ARPA text and for
    each ``.klm`` fixture (the four layouts), and its scores and device
    tables equal the JAX package's."""
    assert tngram.load_lm(None) is None
    for path in [os.path.join(GOLD, "lm.arpa")] + KLMS:
        lm = tngram.load_lm(path)
        want = jngram.load_lm(path)
        assert isinstance(lm, tngram.NgramLM) and lm._py is None
        assert (lm.order, lm.model_type, lm.num_ngrams()) == \
            (want.order, want.model_type, want.num_ngrams())
        for sent in ("a b", "a x b", "", "的 一 是", "b a b a </s>"):
            for bos in (True, False):
                assert lm.score(sent, bos=bos) == want.score(sent, bos=bos)
        t = tdn.DeviceNgramLM.from_path(path, "cpu")
        j = jdn.DeviceNgramLM.from_path(path)
        assert t.hashed and j.hashed and t.probes == j.probes
        for a, b in zip(t.tbls, j.tbls):
            np.testing.assert_array_equal(N(a), N(b))
        np.testing.assert_array_equal(N(t.uni), N(j.uni))
        words = ["a", "b", "的", "oov", "<s>", "</s>", "<unk>"]
        np.testing.assert_array_equal(t.word_ids(words), j.word_ids(words))
        np.testing.assert_array_equal(t.begin_context(2), j.begin_context(2))


@pytest.mark.parametrize("ctor", ["from_arpa", "from_path"])
def test_tables_default_to_the_gpu(monkeypatch, ctor):
    """With no device given the tables go to ``cuda``; without a GPU that
    raises instead of building them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tdn.DeviceNgramLM, ctor)(os.path.join(GOLD, "lm.arpa"))
    lm = getattr(tdn.DeviceNgramLM, ctor)(os.path.join(GOLD, "lm.arpa"),
                                          "cpu")
    assert all(t.device.type == "cpu" for t in (*lm.tbls, lm.uni))


def test_from_arpa_tables_equal_jax(tmp_path):
    """Array for array: narrow level 1, widened levels, dense unigrams,
    probe counts, word ids and contexts."""
    _, arpas = _arpas(tmp_path, 3)
    widened = 0
    for path, _ in arpas:
        j = jdn.DeviceNgramLM.from_arpa(path)
        t = tdn.DeviceNgramLM.from_arpa(path, "cpu")
        assert (t.order, t.probes, t.unk_id, t.word2id) == \
            (j.order, j.probes, j.unk_id, j.word2id)
        assert len(t.tbls) == len(j.tbls)
        for k, (a, b) in enumerate(zip(t.tbls, j.tbls)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(N(a), N(b), err_msg=str(k))
            if k > 0 and t.probes[k] > 1:
                widened += a.shape[1] == t.probes[k] * (k + 3)
        np.testing.assert_array_equal(N(t.uni), N(j.uni))
        np.testing.assert_array_equal(t.begin_context(3), j.begin_context(3))
        np.testing.assert_array_equal(t.null_context(2), j.null_context(2))
    assert widened > 0, "no level took the wide layout"


def test_table_build_and_narrow_lookup_equal_jax():
    """A level of 2000 random keys: the build, the budget gate of the wide
    layout (a tiny budget keeps it narrow) and both layouts' lookups."""
    rng = np.random.RandomState(7)
    keys = np.unique(rng.randint(-5, 2**31 - 1, size=(2000, 2),
                                 dtype=np.int32), axis=0)
    vals = rng.randn(len(keys), 2).astype(np.float32)
    tbl, probes = tdn._build_table(keys, vals)
    jtbl, jprobes = jdn._build_table(keys, vals)
    assert probes == jprobes and probes > 1
    np.testing.assert_array_equal(tbl, jtbl)
    narrow = tdn._widen_tables([tbl], [probes], budget=16)[0]
    wide = tdn._widen_tables([tbl], [probes])[0]
    np.testing.assert_array_equal(narrow, tbl)
    np.testing.assert_array_equal(
        wide, jdn._widen_tables([jtbl], [probes], budget=1 << 30)[0])
    assert wide.shape[1] == probes * 4
    miss = keys.copy()
    miss[:, 1] ^= 1
    query = np.concatenate([keys, miss, [[-1, -1]]])
    jhit, jlp, jbo = jdn._lookup(jnp.asarray(tbl), probes, jnp.asarray(query))
    for t in (narrow, wide):
        hit, lp, bo = tdn._lookup_cols(T(t), probes,
                                       [T(query[:, 0]), T(query[:, 1])])
        np.testing.assert_array_equal(N(hit), N(jhit))
        np.testing.assert_array_equal(N(lp), N(jlp))
        np.testing.assert_array_equal(N(bo), N(jbo))
    assert N(hit)[: len(keys)].all()


@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
def test_torch_hash_equals_numpy_hash(ncols):
    rng = np.random.RandomState(ncols)
    keys = rng.randint(-2**31, 2**31 - 1, size=(4096, ncols), dtype=np.int64)
    keys[:64] = -1                            # hashes as 0xFFFFFFFF words
    keys[64:128] = rng.randint(0, 6000, size=(64, ncols))
    keys = keys.astype(np.int32)
    want = jdn._hash_np(keys)
    np.testing.assert_array_equal(tdn._hash_np(keys), want)
    got = tdn._hash_cols([T(keys[:, j]) for j in range(ncols)])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(N(got).astype(np.uint32), want)
    assert int(got.min()) >= 0 and int(got.max()) <= 0xFFFFFFFF


@pytest.mark.parametrize("ctor", ["from_arpa", "from_path"])
def test_score_candidates_match_jax(tmp_path, ctor):
    rng, arpas = _arpas(tmp_path, 5 if ctor == "from_arpa" else 6)
    for path, vocab in arpas:
        py = tngram.PyNgramLM(path)
        t = tdn.DeviceNgramLM.from_arpa(path, "cpu")
        j = getattr(jdn.DeviceNgramLM, ctor)(path)
        words = vocab + ["oovword", "<unk>", "</s>", "<s>"]
        ctx, ctx_w, cand, cand_w = _queries(rng, py, t.word_ids, t.order,
                                            words)
        # the JAX LM's own ids (the hashed layout numbers words its way)
        jctx = np.full_like(ctx, -1)
        for q, cw in enumerate(ctx_w):
            if cw:
                jctx[q, -len(cw):] = j.word_ids(list(cw))
        jcand = np.stack([j.word_ids(row) for row in cand_w])
        want = N(jdn.score_candidates(j, jnp.asarray(jctx),
                                      jnp.asarray(jcand)))
        got = tdn.score_candidates(t, T(ctx).long(), T(cand).long())
        assert got.dtype == torch.float32 and got.shape == cand.shape
        np.testing.assert_allclose(N(got), want, rtol=0, atol=ATOL)
        for q in range(0, len(ctx), 5):          # and the host oracle
            for c in range(cand.shape[1]):
                assert float(got[q, c]) == pytest.approx(
                    py._score_one(ctx_w[q], cand_w[q][c]), abs=1e-5)


def test_sentence_chain_matches_score(tmp_path):
    """begin_context + advance_context walks kenlm's state path: the sum
    of per-word scores equals PyNgramLM.score(bos=True, eos=True)."""
    rng, arpas = _arpas(tmp_path, 8, n=2)
    for path, vocab in arpas:
        py = tngram.PyNgramLM(path)
        t = tdn.DeviceNgramLM.from_arpa(path, "cpu")
        sent = [py._vocab_map(str(rng.choice(vocab + ["oovword"])))
                for _ in range(5)]
        ctx = T(t.begin_context(1)).long()
        total = 0.0
        for w in sent + ["</s>"]:
            wid = T(t.word_ids([w])).long()
            total += float(tdn.score_candidates(t, ctx, wid[:, None])[0, 0])
            ctx = tdn.advance_context(ctx, wid)
        assert total == pytest.approx(py.score(" ".join(sent)), abs=1e-4)
