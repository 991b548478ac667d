"""PyTorch port: the evaluation harness (evaluate.py) against the JAX
package's, on the CPU.

The cases of tests/test_evaluate.py run both packages on the same corpus
with the golden checkpoint's weights (carried across through
``las.params_from_numpy``): predictions must be equal and the CERs equal
to 1e-9.  The golden shard's manifest reproduces ``expected.json`` in all
five decode modes, with the CER the JAX package's metric gives those
transcripts.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu import evaluate as jeval
from chinese_asr_tpu.lm import ngram as jngram
from chinese_asr_tpu.ops.metrics import batch_cer as jax_batch_cer
from chinese_asr_tpu.utils.checkpoint import load_checkpoint
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch import evaluate as teval
from chinese_asr_tpu_torch.data import audio_io, dataset
from chinese_asr_tpu_torch.lm import ngram as tngram
from chinese_asr_tpu_torch.models import las
from chinese_asr_tpu_torch.vocab import Vocab as TVocab

from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths

TEXTS = ["abcd", "efgh", "abef"]


@pytest.fixture(scope="module")
def weights():
    """The golden checkpoint's params: numpy, JAX arrays and CPU tensors."""
    tree = load_checkpoint(os.path.join(GOLD, "model.ckpt"))["params"]
    import jax
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            las.params_from_numpy(tree, "cpu"))


def _cfgs():
    return tuple(golden_cfg(m).with_("train", eval_batch_size=2)
                 for m in (jcfg, tcfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(0)
    utts = []
    for i, t in enumerate(TEXTS):
        p = str(d / f"u{i}.wav")
        audio_io.write_wav(p, (0.1 * rng.randn(4000)).astype(np.float32))
        utts.append(dataset.Utterance(p, t))
    mpath = str(d / "m.tsv")
    dataset.write_manifest(mpath, utts)
    return (mpath, JVocab.build(TEXTS, max_num_words=8),
            TVocab.build(TEXTS, max_num_words=8), d)


def _both(weights, corpus, **kw):
    mpath, jv, tv, _ = corpus
    jc, tc = _cfgs()
    jlm, tlm = kw.pop("lms", (None, None))
    j = jeval.evaluate_manifest(weights[0], jc, jv, mpath, lm=jlm,
                                verbose=False, **kw)
    t = teval.evaluate_manifest(weights[1], tc, tv, mpath, lm=tlm,
                                verbose=False, **kw)
    assert t["pred"] == j["pred"] and t["ref"] == j["ref"] == TEXTS
    assert t["cer"] == pytest.approx(j["cer"], abs=1e-9)
    assert t["n"] == j["n"] == 3 and np.isfinite(t["cer"])
    return t


def test_evaluate_manifest(weights, corpus):
    res = _both(weights, corpus)
    assert res["ref"][0] == "abcd" and len(res["pred"]) == 3
    assert set(res) == {"cer", "n", "pred", "ref", "seconds", "utts_per_sec"}


def test_compare_modes(weights, corpus):
    mpath, jv, tv, _ = corpus
    jc, tc = _cfgs()
    t = teval.compare_modes(weights[1], tc, tv, mpath, beam_widths=(2,))
    j = jeval.compare_modes(weights[0], jc, jv, mpath, beam_widths=(2,))
    assert set(t) == set(j) == {"greedy", "beam2"}
    for mode in t:
        assert t[mode]["pred"] == j[mode]["pred"]
        assert t[mode]["cer"] == pytest.approx(j[mode]["cer"], abs=1e-9)
        assert t[mode]["n"] == 3


def test_evaluate_manifest_second_pass_device_matches_host(weights, corpus):
    """lm_mode="second" (device rescore) == "second_host" (C++ oracle),
    each equal to the JAX package's; the device LM given as a path and as
    an NgramLM."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_lm_fused import random_trigram_arpa
    arpa = random_trigram_arpa(corpus[3], np.random.RandomState(4), 4)
    dev = _both(weights, corpus, bw=2, lms=(arpa, arpa), lm_mode="second")
    host = _both(weights, corpus, bw=2, lm_mode="second_host",
                 lms=(jngram.load_lm(arpa), tngram.load_lm(arpa)))
    assert dev["pred"] == host["pred"]
    _, _, tv, _ = corpus
    via_lm = teval.evaluate_manifest(weights[1], _cfgs()[1], tv, corpus[0],
                                     bw=2, lm=tngram.load_lm(arpa),
                                     lm_mode="second", verbose=False)
    assert via_lm["pred"] == dev["pred"]


def test_evaluate_manifest_lm_first_pass(weights, corpus):
    """lm_mode="first" (manifest -> loader -> lm_fused -> CER) accepting
    an ARPA path, equal to the JAX package's."""
    lines = ["\\data\\", "ngram 1=11", "", "\\1-grams:",
             "-9.0\t<unk>", "-9.0\t<s>", "-0.4\t</s>", "-0.2\ta"]
    lines += [f"-3.0\t{ch}" for ch in "bcdefgh"] + ["", "\\end\\", ""]
    arpa = str(corpus[3] / "uni.arpa")
    with open(arpa, "w") as f:
        f.write("\n".join(lines))
    res = _both(weights, corpus, bw=2, lms=(arpa, arpa), lm_mode="first",
                topn=12)
    assert all(set(p) <= set("abcdefgh") for p in res["pred"])


@pytest.fixture(scope="module")
def golden_manifest(tmp_path_factory):
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)
    path = str(tmp_path_factory.mktemp("golden") / "golden.tsv")
    dataset.write_manifest(path, [dataset.Utterance(p, t) for p, t in
                                  zip(golden_wav_paths(), expected["texts"])])
    return path, expected


@pytest.mark.parametrize("mode,kw", [
    ("greedy", {}), ("beam_bw4", dict(bw=4)),
    ("lm_second", dict(bw=4, lm_mode="second")),
    ("lm_second_host", dict(bw=4, lm_mode="second_host")),
    ("lm_first", dict(bw=4, lm_mode="first", topn=8))])
def test_golden_shard_evaluation(weights, golden_manifest, mode, kw):
    path, expected = golden_manifest
    vocab = TVocab.build([CHARS * 3], max_num_words=8)
    kw = dict(kw)
    if "lm_mode" in kw:
        arpa = os.path.join(GOLD, "lm.arpa")
        kw["lm"] = (tngram.load_lm(arpa) if kw["lm_mode"] == "second_host"
                    else arpa)
    res = teval.evaluate_manifest(weights[1], golden_cfg(tcfg), vocab, path,
                                  verbose=False, **kw)
    assert res["pred"] == expected["modes"][mode]
    assert res["ref"] == expected["texts"]
    assert res["cer"] == pytest.approx(
        jax_batch_cer(expected["modes"][mode], expected["texts"]), abs=1e-12)


def test_evaluate_cli_device(golden_manifest, monkeypatch, capsys):
    """The CLI decodes on cuda by default (raising without a GPU) and on
    the CPU under --device cpu."""
    path, _ = golden_manifest
    teval.main(["--manifest", path, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("cer=") and " n=6 " in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--manifest", path])


def test_finalize_greedy_cer_branch_matches_jax():
    """finalize_greedy(text=, feat_lens=, want_alignment=) on the same
    seeded decode rows as the JAX function: texts, scores, CER, lengths
    and the alignment copy equal."""
    from chinese_asr_tpu.decode import greedy as jgreedy
    from chinese_asr_tpu_torch.decode import greedy as tgreedy
    rng = np.random.default_rng(5)
    B, T, L = 4, 6, 5
    tokens = rng.integers(4, 12, (B, T)).astype(np.int32)
    final_lens = np.array([0, 3, 6, 2], np.int32)
    finished = np.array([True, True, False, True])
    scores = rng.normal(size=B).astype(np.float32)
    align = rng.random((B, T, L)).astype(np.float32)
    feat_lens = np.array([5, 4, 3, 5], np.int32)
    vocab_j = JVocab.build([CHARS * 3], max_num_words=8)
    vocab_t = TVocab.build([CHARS * 3], max_num_words=8)
    text = [[4, 5, 6], [7, 8], "的一", [9]]
    j = jgreedy.finalize_greedy(
        jgreedy.GreedyResult(*(jnp.asarray(a) for a in
                               (tokens, final_lens, scores, finished, align))),
        vocab_j, text=text, feat_lens=jnp.asarray(feat_lens),
        want_alignment=True)
    t = tgreedy.finalize_greedy(
        tgreedy.GreedyResult(*(torch.from_numpy(a) for a in
                               (tokens, final_lens, scores, finished, align))),
        vocab_t, text=text, feat_lens=torch.from_numpy(feat_lens),
        want_alignment=True)
    assert t.pred_text == j.pred_text and t.text == j.text
    assert t.score == pytest.approx(j.score, abs=1e-6)
    assert t.wer == pytest.approx(j.wer, abs=1e-12) and t.n == j.n == B
    for a, b in ((t.alignment, j.alignment), (t.audio_feat_len,
                 j.audio_feat_len), (t.text_len, j.text_len)):
        np.testing.assert_array_equal(a, np.asarray(b))
    plain = tgreedy.finalize_greedy(
        tgreedy.GreedyResult(*(torch.from_numpy(a) for a in
                               (tokens, final_lens, scores, finished, align))),
        vocab_t)
    assert plain.text is None and plain.wer is None and plain.alignment is None
