"""PyTorch port: the C++ host runtime (``runtime/native.py`` over
``runtime/cpp``), the ``NgramLM`` it backs, the hashed device key layout,
``ops/metrics.py`` and ``finalize_beam``'s zero-string path, against the
JAX package on the same inputs.

* ``NgramLM`` runs a copy of the JAX package's C++ reader, so its scores,
  batch scores, states and per-order enumerations must be equal, not
  close, on ARPA text and on the four ``.klm`` fixtures.
* The hashed ``score_candidates`` gathers the same table rows and sums
  the same f32 terms in the same order as JAX's ``from_lm`` tables, so it
  is compared at 1e-6 (as the tuple layout is), with absent (-1) context
  words and OOV candidates.
* The torch ``_combine_word_hash`` (u32 halves in int64) equals kenlm's
  64-bit ``ngram_hash`` bit for bit: against the keys the C++ reader
  enumerates (``dump_order``) and against Python integers.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.decode import beam as jbeam
from chinese_asr_tpu.lm import device_ngram as jdn
from chinese_asr_tpu.lm import ngram as jngram
from chinese_asr_tpu.ops import metrics as jmetrics
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.decode import beam as tbeam
from chinese_asr_tpu_torch.lm import device_ngram as tdn
from chinese_asr_tpu_torch.lm import ngram as tngram
from chinese_asr_tpu_torch.ops import metrics as tmetrics
from chinese_asr_tpu_torch.runtime import native as tnative
from chinese_asr_tpu_torch.vocab import Vocab

from test_lm import _random_arpa
from torch_port_util import CHARS, GOLD, N, T, golden_cfg

ATOL = 1e-6
KLMS = [os.path.join(os.path.dirname(GOLD), "data", f"golden_tri_{x}.klm")
        for x in ("probing", "trie", "quant_trie", "quant_array_trie")]
U64 = (1 << 64) - 1


def _arpas(tmp_path, seed):
    """Random pruned ARPAs of orders 2-5 (tests/test_lm.py's generator)."""
    rng = np.random.RandomState(seed)
    return [_random_arpa(tmp_path, rng, seed * 10 + order, order=order,
                         nvocab=12, n_per_order=40)[0]
            for order in (2, 3, 4, 5)]


def _models(tmp_path, seed):
    return [os.path.join(GOLD, "lm.arpa")] + KLMS + _arpas(tmp_path, seed)


def _words(lm_path):
    """Words to query: the model's own (from an ARPA next to it, or the
    fixtures' a/b), OOV ones and the sentence markers."""
    base = ["a", "b", "x", "的", "一", "是", "oov", "<s>", "</s>", "<unk>"]
    if lm_path.endswith(".arpa"):
        base += sorted({w for key in tngram.PyNgramLM(lm_path).grams
                        for w in key})
    return base


def test_native_build_is_cached_and_optional(monkeypatch):
    """The library is built once into ``_build/`` under a hash of source,
    flags and compiler; without a compiler there is no library."""
    so = tnative.compile_source("ngram_lm")
    assert so is not None and os.path.dirname(so) == tnative.BUILD_DIR
    assert tnative.compile_source("ngram_lm") == so
    assert os.path.basename(so).startswith("ngram_lm-")
    monkeypatch.setattr(tnative, "_compiler_id", lambda: None)
    assert tnative.compile_source("edit_distance") is None


@pytest.mark.parametrize("which", range(9))
def test_ngram_lm_equals_jax(tmp_path, which):
    """Sentence scores (one and batched, bos/eos on and off), the state
    API (one step and batched), word ids, order enumeration, counts."""
    path = _models(tmp_path, 1)[which]
    t, j = tngram.load_lm(path), jngram.load_lm(path)
    assert isinstance(t, tngram.NgramLM) and t._py is None
    assert (t.order, t.model_type, t.num_ngrams(), t.context_property(),
            t.state_capacity()) == \
        (j.order, j.model_type, j.num_ngrams(), j.context_property(),
         j.state_capacity())
    words = _words(path)
    np.testing.assert_array_equal(t.word_ids(words), j.word_ids(words))
    rng = np.random.RandomState(which)
    sents = [" ".join(rng.choice(words[:-3] + ["</s>"],
                                 rng.randint(0, 7)))
             for _ in range(30)]
    for bos in (True, False):
        for eos in (True, False):
            got = t.score_batch(sents, bos=bos, eos=eos)
            np.testing.assert_array_equal(got,
                                          j.score_batch(sents, bos, eos))
            assert [t.score(s, bos, eos) for s in sents] == list(got)
    ids = [t.word_ids(s.split()) for s in sents]
    offsets = np.zeros(len(ids) + 1, np.int64)
    np.cumsum([len(x) for x in ids], out=offsets[1:])
    flat = np.concatenate(ids)
    np.testing.assert_array_equal(t.score_batch_ids(flat, offsets),
                                  j.score_batch_ids(flat, offsets))
    # incremental state API: one state, then n states at once
    ts, js = t.begin_state(), j.begin_state()
    for w in words[:6]:
        (a, ts), (b, js) = t.base_score(ts, w), j.base_score(js, w)
        assert a == b and ts.ids == js.ids
    cap, n = t.state_capacity(), 64
    states = rng.randint(0, len(words), (n, cap)).astype(np.uint32)
    states = t.word_ids(np.asarray(words)[states].ravel()).reshape(n, cap)
    states = np.ascontiguousarray(states.astype(np.uint32))
    lens = rng.randint(0, cap + 1, n).astype(np.int32)
    nxt = t.word_ids(rng.choice(words, n)).astype(np.uint32)
    np.testing.assert_array_equal(t.base_score_batch_np(states, lens, nxt),
                                  j.base_score_batch_np(states, lens, nxt))
    s2, l2 = states.copy(), lens.copy()
    t.advance_batch_np(states, lens, nxt)
    j.advance_batch_np(s2, l2, nxt)
    np.testing.assert_array_equal(lens, l2)
    np.testing.assert_array_equal(np.where(
        np.arange(cap)[None, :] < lens[:, None], states, 0),
        np.where(np.arange(cap)[None, :] < l2[:, None], s2, 0))
    for k in range(1, t.order + 1):
        for a, b in zip(t.dump_order(k), j.dump_order(k)):
            np.testing.assert_array_equal(a, b)
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    np.testing.assert_array_equal(t.token_id_table(vocab),
                                  j.token_id_table(vocab))
    assert t.token_id_table(vocab) is t.token_id_table(vocab)


def test_write_binary_roundtrip(tmp_path):
    """write_binary in each layout; the binary scores like the text."""
    path = _arpas(tmp_path, 2)[2]
    lm = tngram.NgramLM(path)
    sents = ["w1 w2 w3", "w0", "", "w5 oov w2 w2"]
    for layout in sorted(tngram.NgramLM.LAYOUTS):
        out = str(tmp_path / f"m_{layout}.klm")
        lm.write_binary(out, layout=layout)
        klm = tngram.NgramLM(out)
        assert klm.model_type == tngram.NgramLM.LAYOUTS[layout]
        np.testing.assert_allclose(klm.score_batch(sents),
                                   lm.score_batch(sents), rtol=0,
                                   atol=0.02 if "quant" in layout else 1e-6)
    with pytest.raises(ValueError, match="unknown layout"):
        lm.write_binary(str(tmp_path / "x.klm"), layout="nope")


def test_pure_python_fallback(tmp_path, monkeypatch):
    """No compiler: ARPA text falls back to ``PyNgramLM`` with the same
    scores (to the C++ reader's f32 storage of each log10) and no batch
    states; a ``.klm`` raises."""
    path = _arpas(tmp_path, 3)[1]
    cpp = tngram.NgramLM(path)
    monkeypatch.setattr(tngram, "_lib_cache", {"lib": None, "tried": True})
    py = tngram.NgramLM(path)
    assert py._py is not None and not py.has_batch_states
    assert py.model_type == -1 and py.context_property() == \
        tngram.PyNgramLM(path).context_property()
    sents = ["w1 w2 w3", "w0 w0", "", "oov w2"]
    np.testing.assert_allclose(py.score_batch(sents), cpp.score_batch(sents),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="KenLM binary"):
        tngram.NgramLM(KLMS[0])
    with pytest.raises(RuntimeError, match="C\\+\\+"):
        py.write_binary(str(tmp_path / "x.klm"))


def _hash_py(ids):
    """kenlm ngram_hash in Python integers: the last word seeds, earlier
    words fold in right to left."""
    h = int(ids[-1])
    for w in reversed(ids[:-1]):
        h = ((h * tdn._M1) ^ ((1 + int(w)) * tdn._M2)) & U64
    return h


def _u64(t):
    """int64 tensor of u64 bit patterns -> Python ints."""
    return [int(x) & U64 for x in N(t).tolist()]


def combine_cases(device="cpu"):
    """(h, next, the kenlm products as Python ints) over random and edge
    words: u64 hashes and u32 words."""
    rng = np.random.RandomState(0)
    n = 4096
    h = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    h[:4] = [0, -1, 2**32 - 1, -2**63]
    nxt = rng.randint(0, 2**32, n, dtype=np.int64)
    nxt[:6] = [0, 2**32 - 1, 2**31, 2**31 - 1, 1, 0]
    want = [((int(a) & U64) * tdn._M1 ^ (1 + int(b)) * tdn._M2) & U64
            for a, b in zip(h, nxt)]
    return (torch.from_numpy(h).to(device), torch.from_numpy(nxt).to(device),
            want)


def test_combine_word_hash_bit_equal():
    """The int64 products wrap mod 2^64: against Python integers, and
    against JAX's u32-pair twin."""
    h, nxt, want = combine_cases()
    got = tdn._combine_word_hash(h, nxt)
    assert got.dtype == torch.int64 and _u64(got) == want
    # JAX's twin adds 1 to the word in u32, which wraps for 2^32 - 1 (the
    # -1 id of an absent context word, a level both sides mask): equal
    # on every other word
    hu = N(h).view(np.uint64)
    j_hi, j_lo = jdn._combine_word_hash(
        jnp.asarray((hu >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hu & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(N(nxt).astype(np.uint32)))
    hi, lo = tdn._hash_key(got)
    ok = N(nxt) != 2**32 - 1
    np.testing.assert_array_equal(N(hi)[ok],
                                  N(j_hi).view(np.int32)[ok])
    np.testing.assert_array_equal(N(lo)[ok],
                                  N(j_lo).view(np.int32)[ok])
    assert lo.dtype == torch.int32


def hash_chain(ids):
    """The torch chain over word ids [n, k] (the device's order) ->
    int64 hashes."""
    g = ids[:, -1]
    for j in range(ids.shape[1] - 2, -1, -1):
        g = tdn._combine_word_hash(g, ids[:, j])
    return g


@pytest.mark.parametrize("order", [2, 3, 4, 5])
def test_hash_chain_equals_cpp_keys(tmp_path, order):
    """Every n-gram of a random ARPA, hashed by the torch chain over the
    C++ reader's word ids, is a key the reader enumerates, and vice
    versa."""
    path = _arpas(tmp_path, 4)[order - 2]
    lm = tngram.NgramLM(path)
    grams = tngram.PyNgramLM(path).grams
    for k in range(2, order + 1):
        keys = [key for key in grams if len(key) == k]
        ids = np.stack([lm.word_ids(list(key)) for key in keys]).astype(
            np.int64)                                     # [n, k]
        got = _u64(hash_chain(T(ids)))
        assert got == [_hash_py(r) for r in ids.tolist()]
        hi, lo, _, _ = lm.dump_order(k)
        assert set(got) == {(int(a) << 32) | int(b)
                            for a, b in zip(hi, lo)}


@pytest.mark.parametrize("which", range(9))
def test_hashed_score_candidates_match_jax(tmp_path, which):
    """The port's hashed tables equal JAX's ``from_lm`` tables, and their
    scores agree at 1e-6 and with the C++ base scores, with absent (-1)
    context words and OOV candidates."""
    path = _models(tmp_path, 5)[which]
    lm = tngram.NgramLM(path)
    t = tdn.DeviceNgramLM.from_lm(lm, "cpu")
    j = jdn.DeviceNgramLM.from_lm(jngram.NgramLM(path))
    assert t.hashed and (t.order, t.probes, t.unk_id) == \
        (j.order, j.probes, j.unk_id)
    for a, b in zip(t.tbls, j.tbls):
        np.testing.assert_array_equal(N(a), N(b))
    rng = np.random.RandomState(which)
    words = _words(path)
    M1, Q, C = max(t.order - 1, 1), 64, 6
    ctx = t.word_ids(rng.choice(words, Q * M1)).reshape(Q, M1).astype(
        np.int64)
    short = rng.randint(0, M1 + 1, Q)            # absent words on the left
    ctx[np.arange(M1)[None, :] < short[:, None]] = -1
    cand = t.word_ids(rng.choice(words, Q * C)).reshape(Q, C).astype(
        np.int64)
    cand[0, 0] = t.uni.shape[0] + 5              # an id outside the vocab
    got = tdn.score_candidates(t, T(ctx), T(cand))
    want = N(jdn.score_candidates(j, jnp.asarray(ctx.astype(np.int32)),
                                  jnp.asarray(cand.astype(np.int32))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(N(got), want, rtol=0, atol=ATOL)
    # the host reader's base scores over the same states (the -1 prefix
    # is simply a shorter state)
    states = np.where(ctx >= 0, ctx, 0)
    lens = (ctx >= 0).sum(axis=1)
    states = np.stack([np.roll(s, -(M1 - n)) for s, n in zip(states, lens)])
    host = lm.base_score_batch_np(
        np.ascontiguousarray(np.repeat(states, C, axis=0).astype(np.uint32)),
        np.repeat(lens, C).astype(np.int32),
        cand.ravel().astype(np.uint32)).reshape(Q, C)
    np.testing.assert_allclose(N(got)[:, 1:], host[:, 1:], rtol=0, atol=1e-5)


def test_device_lm_to_another_device_keeps_the_layout():
    t = tdn.DeviceNgramLM.from_path(KLMS[0], "cpu")
    c = t.to("cpu")
    assert c.hashed and c.host_lm is t.host_lm and c.probes == t.probes
    ctx, cand = T(t.begin_context(2)).long(), T([[0, 1], [2, 3]]).long()
    assert torch.equal(tdn.score_candidates(c, ctx, cand),
                       tdn.score_candidates(t, ctx, cand))


@pytest.mark.parametrize("native", [True, False])
def test_metrics_equal_jax(monkeypatch, native):
    """CER and its parts, through the C++ edit distance and through the
    pure-Python DP."""
    if not native:
        monkeypatch.setattr(tmetrics.native, "get", lambda: None)
    rng = np.random.RandomState(int(native))
    alphabet = list(CHARS + "ab")
    pairs = [("".join(rng.choice(alphabet, rng.randint(0, 9))),
              "".join(rng.choice(alphabet, rng.randint(1, 9))))
             for _ in range(40)] + [("", "的"), ("的一", "的一")]
    for p, r in pairs:
        assert tmetrics.edit_distance(p, r) == jmetrics.edit_distance(p, r)
        assert tmetrics.cer(p, r) == jmetrics.cer(p, r)
        assert tmetrics.cer(p, r, False) == jmetrics.cer(p, r, False)
        assert tmetrics.cer_detail(p, r) == jmetrics.cer_detail(p, r)
    preds, refs = zip(*pairs)
    assert tmetrics.batch_cer(list(preds), list(refs)) == pytest.approx(
        jmetrics.batch_cer(list(preds), list(refs)), abs=1e-12)


def _nbest(B=3, cap=6, L=8):
    rng = np.random.RandomState(4)
    fin_tokens = rng.randint(4, 12, (B, cap, L)).astype(np.int32)
    fin_lens = rng.randint(0, L + 1, (B, cap)).astype(np.int32)
    fin_scores = -rng.rand(B, cap).astype(np.float32) * 3
    fin_scores[rng.rand(B, cap) < 0.3] = -np.inf
    fin_scores[2] = -np.inf                       # a never-finished row
    count = np.isfinite(fin_scores).sum(axis=1).astype(np.int32)
    live_tokens = rng.randint(4, 12, (B, 2, L)).astype(np.int32)
    live_scores = -rng.rand(B, 2).astype(np.float32)
    return fin_tokens, fin_lens, fin_scores, count, live_tokens, live_scores


def test_finalize_beam_id_path_equals_string_path_and_jax():
    """The second pass through ``score_batch_ids`` (a C++ ``NgramLM``)
    picks what the string path (``PyNgramLM``) and JAX's C++ path pick,
    and the reference-text branch reports JAX's CER."""
    arrays = _nbest()
    L = arrays[0].shape[2]
    tr = tbeam.BeamResult(*(T(a) for a in arrays),
                          torch.tensor(L - 1, dtype=torch.int32))
    jr = jbeam.BeamResult(*(jnp.asarray(a) for a in arrays), jnp.int32(L - 1))
    ct, cj = golden_cfg(tcfg), golden_cfg(jcfg)
    vocab = Vocab.build([CHARS * 3], max_num_words=8)
    path = os.path.join(GOLD, "lm.arpa")
    kw = dict(second_pass=True, lm_weight=1.5, length_weight=1.5)
    refs = ["的一是", "不了", "人我在的"]
    ids = tbeam.finalize_beam(tr, ct, vocab, text=refs,
                              lm_model=tngram.NgramLM(path), **kw)
    strs = tbeam.finalize_beam(tr, ct, vocab, lm_model=tngram.PyNgramLM(path),
                               **kw)
    want = jbeam.finalize_beam(jr, cj, vocab, text=refs,
                               lm_model=jngram.NgramLM(path), **kw)
    assert ids.pred_text == strs.pred_text == want.pred_text
    np.testing.assert_allclose(ids.score, want.score, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ids.score, strs.score, rtol=0, atol=1e-6)
    assert ids.text == want.text == refs and strs.text is None
    assert ids.wer == pytest.approx(want.wer, abs=1e-12)
    # finalize_best's reference-text branch, token-id references too
    best = tbeam.select_best(tr, 0.0)
    out = tbeam.finalize_best(best, vocab,
                              text=[vocab.encode(r) for r in refs])
    assert out.text == refs
    assert out.wer == pytest.approx(
        np.mean([jmetrics.cer(p, r) for p, r in zip(out.pred_text, refs)]),
        abs=1e-12)
