"""PyTorch port: the data layer and the ASR surface beyond transcribe_wavs,
held against the JAX package on the same seeded numpy inputs (CPU).

* Host code copied from the JAX package (wav I/O, peak normalisation,
  augmentation, manifests, dataset, sampler, loader, prefetch) must give
  equal arrays.
* ``batches_to_device`` featurizes on the device: features within the
  port's features tolerance of JAX's (atol 2e-4, see
  tests/test_torch_port_features.py), lengths and tokens exact.
* The ASR surface (chunking, bytes, long form, transcode without ffmpeg,
  ``flat_pow2``, the overlapped chunk upload) runs the golden checkpoint
  on both sides, whose transcripts are exact across frameworks.
"""

import io
import json
import os
import shutil
import threading
import time
import wave as wave_mod

import numpy as np
import pytest
import torch

from chinese_asr_tpu import api as japi
from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.data import audio_io as jio
from chinese_asr_tpu.data import augment as jaug
from chinese_asr_tpu.data import dataset as jds
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.data import audio_io as tio
from chinese_asr_tpu_torch.data import augment as taug
from chinese_asr_tpu_torch.data import dataset as tds
from chinese_asr_tpu_torch.vocab import Vocab as TVocab

from torch_port_util import CHARS, GOLD, N, golden_cfg, golden_wav_paths

ATOL_FEATS = 2e-4


def small(cfg_mod):
    return (cfg_mod.Config()
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("decode", max_len=8)
            .with_("train", batch_size=2, eval_batch_size=2))


TEXTS = ["abc", "de", "fghij", "ab", "cde"]


@pytest.fixture()
def corpus(tmp_path):
    rng = np.random.RandomState(0)
    utts = []
    for i, t in enumerate(TEXTS):
        n = 3200 + 1600 * i
        p = str(tmp_path / f"u{i}.wav")
        tio.write_wav(p, (0.1 * rng.randn(n)).astype(np.float32), 16000)
        utts.append(tds.Utterance(p, t))
    mpath = str(tmp_path / "manifest.tsv")
    tds.write_manifest(mpath, utts)
    return mpath


def _vocabs():
    return (JVocab.build(TEXTS, max_num_words=20),
            TVocab.build(TEXTS, max_num_words=20))


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
            assert np.asarray(x).dtype == np.asarray(y).dtype


# --------------------------------------------------------------------------
# audio io and augmentation
# --------------------------------------------------------------------------
def test_wav_roundtrip_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    x = (0.3 * rng.randn(16000)).astype(np.float32).clip(-1, 1)
    pt, pj = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    tio.write_wav(pt, x, 16000)
    jio.write_wav(pj, x, 16000)
    with open(pt, "rb") as f, open(pj, "rb") as g:
        assert f.read() == g.read()
    for dtype in ("float32", "int16"):
        y, rate = tio.read_wav(pt, 16000, dtype=dtype)
        yj, _ = jio.read_wav(pt, 16000, dtype=dtype)
        assert rate == 16000 and y.dtype == yj.dtype
        np.testing.assert_array_equal(y, yj)
    np.testing.assert_allclose(tio.read_wav(pt, 16000)[0], x, atol=2.0 / 32768)


@pytest.mark.parametrize("x", [np.array([0.1, -0.25, 0.2], np.float32),
                               np.zeros(5, np.float32),
                               np.random.RandomState(1).randn(999)
                               .astype(np.float32)])
def test_peak_normalize_matches_jax(x):
    y = tio.peak_normalize(x, -1.0)
    np.testing.assert_array_equal(y, jio.peak_normalize(x, -1.0))
    if x.any():
        assert abs(np.abs(y).max() - 10 ** (-1 / 20)) < 1e-6


def test_rate_mismatch_warns(tmp_path):
    p = str(tmp_path / "b.wav")
    tio.write_wav(p, np.zeros(800, np.float32), 8000)
    for mod in (tio, jio):
        with pytest.warns(UserWarning):
            mod.read_wav(p, 16000)


def test_augment_functions_match_jax():
    rng = np.random.RandomState(0)
    x = np.sin(np.linspace(0, 20, 16000)).astype(np.float32) \
        + 0.01 * rng.randn(16000).astype(np.float32)
    for db in (20.0, -20.0, 3.3):
        np.testing.assert_array_equal(taug.gain_db(x, db), jaug.gain_db(x, db))
    for rate in (1.25, 0.8, 0.97):
        np.testing.assert_array_equal(taug.change_speed(x, rate),
                                      jaug.change_speed(x, rate))
    assert taug.change_speed(x, 1.0) is x
    for ms in (2 / 16.0, -2 / 16.0, 0.0, 4.7):
        np.testing.assert_array_equal(taug.shift(x, ms, 16000),
                                      jaug.shift(x, ms, 16000))
    assert taug.augment(x, small(tcfg).augment, np.random.RandomState(1)) is x
    tc = small(tcfg).with_("augment", aug_prob=1.0).augment
    jc = small(jcfg).with_("augment", aug_prob=1.0).augment
    for seed in range(3):
        np.testing.assert_array_equal(
            taug.augment(x, tc, np.random.RandomState(seed)),
            jaug.augment(x, jc, np.random.RandomState(seed)))


# --------------------------------------------------------------------------
# manifest / dataset / sampler / loader
# --------------------------------------------------------------------------
def test_manifest_roundtrip_matches_jax(corpus, tmp_path):
    utts = tds.read_manifest(corpus)
    assert [u.text for u in utts] == TEXTS
    assert [(u.path, u.text) for u in jds.read_manifest(corpus)] \
        == [(u.path, u.text) for u in utts]
    utts.append(tds.Utterance("x.wav"))        # no text: infer manifests
    pt, pj = str(tmp_path / "t.tsv"), str(tmp_path / "j.tsv")
    tds.write_manifest(pt, utts)
    jds.write_manifest(pj, [jds.Utterance(u.path, u.text) for u in utts])
    with open(pt, encoding="utf-8") as f, open(pj, encoding="utf-8") as g:
        assert f.read() == g.read()
    assert tds.read_manifest(pt)[-1].text is None


@pytest.mark.parametrize("mode", ["train", "eval", "infer"])
def test_dataset_modes_match_jax(corpus, mode):
    jv, tv = _vocabs()
    jd = jds.AudioDataset(jds.read_manifest(corpus), small(jcfg), jv, mode,
                          seed=3)
    td = tds.AudioDataset(tds.read_manifest(corpus), small(tcfg), tv, mode,
                          seed=3)
    for i in range(len(TEXTS)):
        _assert_items_equal(td[i], jd[i])
    wav, ids = td[0]
    if mode == "train":
        assert wav.dtype == np.float32
    else:          # eval/infer ship raw PCM16 (the /32768 on the device)
        assert wav.dtype == np.int16 and len(wav) == 3200
    assert ids == (None if mode == "infer" else tv.encode("abc"))
    np.testing.assert_array_equal(td.sample_lengths(), jd.sample_lengths())


def test_train_sampler_matches_jax():
    lengths = np.random.RandomState(4).randint(1, 100, 37)
    for bs, su in ((2, 2), (4, 3), (8, 10)):
        t = tds.train_sampler_order(lengths, bs, su, np.random.RandomState(0))
        j = jds.train_sampler_order(lengths, bs, su, np.random.RandomState(0))
        np.testing.assert_array_equal(t, j)
        w = max(1, su * bs)
        for s in range(0, len(t), w):          # length-sorted windows
            assert np.all(np.diff(lengths[t[s:s + w]]) >= 0)
        assert sorted(t.tolist()) == list(range(len(lengths)))


@pytest.mark.parametrize("kind", ["eval", "train", "train_drop_last"])
def test_loader_batches_match_jax(corpus, kind):
    jv, tv = _vocabs()
    if kind == "eval":
        tl = tds.make_eval_loader(corpus, small(tcfg), tv)
        jl = jds.make_eval_loader(corpus, small(jcfg), jv)
    else:
        drop = kind == "train_drop_last"
        tl = tds.make_train_loader(corpus, small(tcfg), tv, seed=5,
                                   drop_last=drop)
        jl = jds.make_train_loader(corpus, small(jcfg), jv, seed=5,
                                   drop_last=drop)
    tb, jb = list(tl), list(jl)
    assert len(tb) == len(jb) == len(tl) == len(jl) \
        == (2 if kind == "train_drop_last" else 3)
    for a, b in zip(tb, jb):
        _assert_items_equal(a, b)
    if kind == "eval":
        wav_mat, wav_lens, ti, to, tlens = tb[0]
        assert wav_mat.shape[1] % 4800 == 0
        assert ti.shape == to.shape and ti.shape[1] % 8 == 0
        ids = tv.encode(TEXTS[0])      # sos/eos packing (data.py:485-487)
        assert ti[0, 0] == small(tcfg).vocab.sos
        assert list(ti[0, 1:1 + len(ids)]) == ids
        assert list(to[0, : len(ids)]) == ids
        assert to[0, len(ids)] == small(tcfg).vocab.eos
        assert tlens[0] == len(ids) + 1
        assert np.all(wav_mat[0, wav_lens[0]:] == 0)


@pytest.mark.parametrize("mode", ["eval", "infer"])
def test_batches_to_device_matches_jax(corpus, mode):
    jv, tv = _vocabs()
    tl = tds.Loader(tds.AudioDataset(tds.read_manifest(corpus), small(tcfg),
                                     tv, mode), 2)
    jl = jds.Loader(jds.AudioDataset(jds.read_manifest(corpus), small(jcfg),
                                     jv, mode), 2)
    tb = list(tds.batches_to_device(tl, small(tcfg), "cpu"))
    jb = list(jds.batches_to_device(jl, small(jcfg)))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        if mode == "eval":
            assert isinstance(a, tds.Batch)
            for name in ("feat_lens", "tokens_in", "tokens_out", "text_lens"):
                np.testing.assert_array_equal(N(getattr(a, name)),
                                              N(getattr(b, name)))
            feats_t, feats_j = a.feats, b.feats
        else:
            (feats_t, lens_t), (feats_j, lens_j) = a, b
            np.testing.assert_array_equal(N(lens_t), N(lens_j))
        assert feats_t.shape == feats_j.shape
        assert feats_t.shape[2] == small(tcfg).audio.feat_dim
        assert feats_t.device.type == "cpu"
        np.testing.assert_allclose(N(feats_t), N(feats_j), rtol=0,
                                   atol=ATOL_FEATS)


def test_prefetch_order_and_errors():
    assert list(tds.prefetch(iter(range(7)), size=2)) \
        == list(jds.prefetch(iter(range(7)), size=2)) == list(range(7))

    def bad():
        yield 1
        raise RuntimeError("boom")

    it = tds.prefetch(bad(), size=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        list(it)


def test_prefetch_worker_exits_when_consumer_abandons():
    before = {t.ident for t in threading.enumerate()}
    it = tds.prefetch(iter(range(1000)), size=2)
    assert next(it) == 0                       # worker running, queue full
    it.close()                                 # consumer abandons
    deadline = time.time() + 5.0
    while time.time() < deadline:
        extra = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"leaked prefetch worker threads: {extra}"


# --------------------------------------------------------------------------
# the ASR surface, on the golden checkpoint in both packages
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)


def _golden(api, cfg_mod, vocab_cls, **kw):
    return api.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                   cfg=golden_cfg(cfg_mod),
                   vocab=vocab_cls.build([CHARS * 3], max_num_words=8), **kw)


@pytest.fixture(scope="module")
def port():
    return _golden(tapi, tcfg, TVocab, device="cpu")


@pytest.fixture(scope="module")
def jax_asr():
    return _golden(japi, jcfg, JVocab)


def _golden_pcm():
    wavs = [tio.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    return wavs, [tio.peak_scale(w) for w in wavs]


def test_transcribe_chunking_sorts_by_length(port, expected):
    """Chunked transcription (lists over max_batch: length-sorted chunks,
    each uploaded while the one before it decodes) returns input order,
    equal to the unchunked call and to the JAX package's transcripts."""
    wavs, scales = _golden_pcm()
    order = [3, 0, 5, 1, 4, 2]
    wavs, scales = [wavs[i] for i in order], [scales[i] for i in order]
    want = [expected["modes"]["greedy"][i] for i in order]
    assert port.transcribe_wavs(wavs, max_batch=2, scales=scales) == want
    assert port.transcribe_wavs(wavs, max_batch=16, scales=scales) == want


def test_overlapped_chunks_restore_order_on_cpu(port):
    """Three chunks through the overlapped path: each row's transcript is
    its sorted chunk's, decoded alone; on the CPU no stream or event is
    made."""
    rng = np.random.default_rng(2)
    wavs, scales = _golden_pcm()
    wavs = [w[: int(rng.integers(len(w) // 2, len(w)))] for w in wavs] \
        + wavs[:1]
    scales = scales + scales[:1]
    got = port.transcribe_wavs(wavs, max_batch=3, scales=scales)
    order = sorted(range(len(wavs)), key=lambda i: len(wavs[i]))
    for s in range(0, len(order), 3):
        idx = order[s:s + 3]
        alone = port.transcribe_wavs([wavs[i] for i in idx],
                                     scales=[scales[i] for i in idx])
        assert [got[i] for i in idx] == alone
    up = port._upload(port._prep(wavs[:2], None))
    assert up.done is None and up.pinned is None and port._copy_stream is None


def test_transcribe_empty_list(port):
    assert port.transcribe_wavs([]) == []


def _wav_bytes(pcm):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


def test_transcribe_bytes_wav(port, jax_asr, tmp_path, expected):
    """WAV bytes transcribe as the file does, and as JAX transcribes them."""
    with open(golden_wav_paths()[1], "rb") as f:
        data = f.read()
    got = port.transcribe_bytes(data)
    assert got == expected["modes"]["greedy"][1] == port(golden_wav_paths()[1])
    assert got == jax_asr.transcribe_bytes(data)
    rng = np.random.RandomState(0)
    noise = _wav_bytes((rng.randn(8000) * 6000).clip(-32768, 32767)
                       .astype(np.int16))
    p = tmp_path / "x.wav"
    p.write_bytes(noise)
    assert port.transcribe_bytes(noise) == port(str(p))


def _spy(asr, calls):
    orig = asr.transcribe_wavs

    def spy(wavs, *a, **k):
        calls.append(([np.asarray(w) for w in wavs], k.get("scales")))
        return orig(wavs, *a, **k)
    return spy


@pytest.mark.parametrize("chunk_s,search_s", [(1.2, 0.3), (0.7, 0.25)])
def test_transcribe_long_matches_jax(port, jax_asr, tmp_path, monkeypatch,
                                     chunk_s, search_s):
    """The silence-seeking cuts equal JAX's, cover every sample once (no
    duplication), and the joined transcripts equal JAX's."""
    wavs, _ = _golden_pcm()
    gap = np.zeros(4000, np.int16)
    long = np.concatenate([x for w in wavs[:4] for x in (w, gap)])
    p = str(tmp_path / "long.wav")
    with open(p, "wb") as f:
        f.write(_wav_bytes(long))
    tcalls, jcalls = [], []
    monkeypatch.setattr(port, "transcribe_wavs", _spy(port, tcalls))
    monkeypatch.setattr(jax_asr, "transcribe_wavs", _spy(jax_asr, jcalls))
    got = port.transcribe_long(p, chunk_s=chunk_s, search_s=search_s)
    assert got == jax_asr.transcribe_long(p, chunk_s=chunk_s,
                                          search_s=search_s)
    (tch, tsc), (jch, jsc) = tcalls[0], jcalls[0]
    assert len(tch) == len(jch) > 1 and tsc == jsc
    for a, b in zip(tch, jch):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(tch), long)
    assert isinstance(got, str) and len(got) > 0


def test_transcribe_files_transcode_without_ffmpeg(port, jax_asr,
                                                   monkeypatch, tmp_path):
    """transcode=True on a .wav without ffmpeg: copied, peak-normalized on
    the host and re-read as float, as JAX does; a non-wav input raises."""
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    paths = golden_wav_paths()
    got = port.transcribe_files(paths, transcode=True)
    assert got == jax_asr.transcribe_files(paths, transcode=True)
    assert got == port.transcribe_files(paths)      # the transcripts hold
    out = str(tmp_path / "t.wav")
    tio.transcode(paths[0], out)
    jout = str(tmp_path / "j.wav")
    jio.transcode(paths[0], jout)
    np.testing.assert_array_equal(tio.read_wav(out)[0], jio.read_wav(jout)[0])
    bad = tmp_path / "x.amr"
    bad.write_bytes(b"#!AMR\n")
    with pytest.raises(RuntimeError, match="ffmpeg unavailable"):
        port.transcribe_files([str(bad)])


@pytest.mark.parametrize("wire", ["flat", "padded"])
def test_flat_pow2_transcripts_match_default_wire(wire):
    """ASR(flat_pow2=True): the flat wire's length is the next power-of-two
    multiple of wav_bucket (JAX's length for the same batch); only the
    wire's tail padding changes, so the transcripts do not."""
    rng = np.random.RandomState(12)
    ws = [(rng.randn(n) * 3000).astype(np.int16)
          for n in (5000, 1700, 3333, 9000, 800, 6400)]
    cfg = small(tcfg)
    a = tapi.ASR(cfg=cfg, bw=4, wire=wire, wav_bucket=1600, device="cpu",
                 vocab=tapi._identity_vocab(cfg.vocab.vocab_size))
    b = tapi.ASR(cfg=cfg, bw=4, wire=wire, wav_bucket=1600, device="cpu",
                 flat_pow2=True,
                 vocab=tapi._identity_vocab(cfg.vocab.vocab_size))
    if wire == "flat":
        j = japi.ASR(cfg=small(jcfg), bw=4, flat_pow2=True, wav_bucket=1600)
        for k in (1, 3, 6):
            buf = b._prep(ws[:k], None)[0]
            assert len(buf) == len(j._prep_flat(ws[:k])[0])
            assert len(buf) // 1600 & (len(buf) // 1600 - 1) == 0
            assert len(a._prep(ws[:k], None)[0]) % (8 * 1600) == 0
    assert b.transcribe_wavs(ws) == a.transcribe_wavs(ws)
    assert b.transcribe_wavs(ws, max_batch=4) == a.transcribe_wavs(ws)


def test_batches_to_device_defaults_to_cuda(corpus, monkeypatch):
    """No silent CPU fallback: without a GPU and without a device the
    device loader raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tv = _vocabs()
    loader = tds.make_eval_loader(corpus, small(tcfg), tv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tds.batches_to_device(loader, small(tcfg)))
    assert isinstance(next(tds.batches_to_device(loader, small(tcfg), "cpu")),
                      tds.Batch)
