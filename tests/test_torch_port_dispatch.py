"""PyTorch port: dispatch-ahead decoding and the compiled front end, on
the CPU, against the JAX package.

* ``ASR._decode_dispatch`` / ``_decode_finalize`` reproduce the golden
  shard's ``expected.json`` exactly in all five modes, as JAX's pair
  does on the same wavs.
* ``transcribe_wavs`` over three chunks calls prep / upload / dispatch /
  finalize in JAX's order, chunk indices included (recorded on both
  packages), and gives the serial order's transcripts.
* The front end (``features.front_end_jit``, the loader's
  ``featurize_batch_jit``): on the CPU its eager function bit for bit,
  and within the feature tests' atol 2e-4 of JAX's jitted featurizers
  over the flat, padded, mu-law and ADPCM wires (tests/
  test_torch_port_features.py: f32 sums in other orders).  In bf16 both
  packages cast those features, so a value within 2e-4 of a bf16
  rounding boundary lands one bf16 ulp (at most 2^-7 of its magnitude)
  apart.
"""

import json
import os

import numpy as np
import pytest
import torch

from chinese_asr_tpu import api as japi
from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.data import audio_io
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import (CHARS, GOLD, N, golden_cfg, golden_wav_paths,
                             random_wavs, small_cfg)

ATOL_FEATS = 2e-4
BF16_REL = 2.0 ** -7

ARPA = os.path.join(GOLD, "lm.arpa")
MODES = {"greedy": dict(bw=None),
         "beam_bw4": dict(bw=4),
         "lm_second": dict(bw=4, lm_path=ARPA, lm_mode="second"),
         "lm_second_host": dict(bw=4, lm_path=ARPA, lm_mode="second_host"),
         "lm_first": dict(bw=4, lm_path=ARPA, lm_mode="first", lm_topn=8)}


def _golden(pkg, **kw):
    """The golden model as ``pkg``'s ASR ("jax" or "port")."""
    if pkg == "jax":
        return japi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                        cfg=golden_cfg(jcfg),
                        vocab=JVocab.build([CHARS * 3], max_num_words=8),
                        **kw)
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg),
                    vocab=Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", **kw)


def _golden_wavs():
    wavs = [audio_io.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    return wavs, [audio_io.peak_scale(w) for w in wavs]


@pytest.mark.parametrize("mode", list(MODES))
def test_dispatch_then_finalize_reproduces_the_golden_shard(mode):
    """``_decode_finalize(_decode_dispatch(...))`` on the golden shard's
    features gives ``expected.json``, as JAX's pair does."""
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"][mode]
    wavs, scales = _golden_wavs()
    port = _golden("port", **MODES[mode])
    feats = port._featurize(port._upload(port._prep(wavs, scales)))
    got = port._decode_finalize(port._decode_dispatch(feats))
    ja = _golden("jax", **MODES[mode])
    jfeats = ja._featurize_flat_device(
        *ja._upload_flat(ja._prep_flat(wavs, scales)))
    want = ja._decode_finalize(ja._decode_dispatch(jfeats))
    assert got == want == expected
    assert port._decode_batch(feats) == expected


def _record(monkeypatch, asr, names: dict, chunk_of, seq: list) -> None:
    """Wrap ``asr``'s methods ``names`` ({method: label or None}) so each
    call appends (label, chunk index) to ``seq``: a prep finds its chunk
    by ``chunk_of(wavs)``, every later stage by the object it was handed
    (what an earlier stage returned, or its first element); a None label
    only passes the chunk on."""
    tags = {}

    def tag(obj, c):
        tags[id(obj)] = c
        if isinstance(obj, tuple) and obj:
            tags[id(obj[0])] = c

    def wrap(name, label):
        orig = getattr(asr, name)

        def call(*args, **kw):
            c = chunk_of(args[0]) if label == "prep" else tags[id(args[0])]
            out = orig(*args, **kw)
            tag(out, c)
            if label is not None:
                seq.append((label, c))
            return out
        monkeypatch.setattr(asr, name, call)

    for name, label in names.items():
        wrap(name, label)


def test_transcribe_wavs_runs_jax_chunk_order(monkeypatch):
    """Five wavs of distinct lengths at ``max_batch=2`` (chunks of 2, 2,
    1): both packages prepare and upload chunk 0, then for each chunk c
    dispatch c, prepare and upload c+1, finalize c-1, and finalize the
    last at the end; the port's transcripts are its serial order's."""
    rng = np.random.default_rng(4)
    lens = [9000, 4000, 12000, 6500, 16000]
    wavs = random_wavs(rng, lens)
    ranks = {n: r for r, n in enumerate(sorted(lens))}

    def chunk_of(chunk):
        return ranks[min(len(w) for w in chunk)] // 2

    jseq, tseq = [], []
    ja = _golden("jax", bw=4)
    _record(monkeypatch, ja, {"_prep_flat": "prep", "_upload_flat": "upload",
                              "_featurize_flat_device": None,
                              "_decode_dispatch": "dispatch",
                              "_decode_finalize": "finalize"},
            chunk_of, jseq)
    port = _golden("port", bw=4)
    _record(monkeypatch, port, {"_prep": "prep", "_upload": "upload",
                                "_featurize": None,
                                "_decode_dispatch": "dispatch",
                                "_decode_finalize": "finalize"},
            chunk_of, tseq)
    ja.transcribe_wavs(wavs, max_batch=2)
    got = port.transcribe_wavs(wavs, max_batch=2)
    want = [("prep", 0), ("upload", 0),
            ("dispatch", 0), ("prep", 1), ("upload", 1),
            ("dispatch", 1), ("prep", 2), ("upload", 2), ("finalize", 0),
            ("dispatch", 2), ("finalize", 1),
            ("finalize", 2)]
    assert jseq == want
    assert tseq == want
    monkeypatch.undo()
    order = sorted(range(len(wavs)), key=lambda i: lens[i])
    serial = [""] * len(wavs)
    for s in range(0, len(order), 2):
        idx = order[s:s + 2]
        up = port._upload(port._prep([wavs[i] for i in idx], None))
        for i, text in zip(idx, port._decode_batch(port._featurize(up))):
            serial[i] = text
    assert got == serial


def _wavs(kind: str):
    rng = np.random.default_rng(7)
    wavs = random_wavs(rng, [16000, 7000, 300, 11000])
    if kind == "float":
        wavs[1] = wavs[1].astype(np.float32) / 32768.0
    return wavs


WIRES = [("flat", "int16"), ("flat", "float"), ("padded", "int16"),
         ("mulaw", "int16"), ("adpcm", "int16"), ("adpcm", "float")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire,kind", WIRES)
def test_front_end_equals_eager_and_jax(wire, kind, dtype):
    """The port's front end (``ASR._featurize`` through
    ``front_end_jit``) over each wire and dtype: its eager function's
    features bit for bit on the CPU, and JAX's jitted featurizer's
    within the feature tests' atol (bf16: plus one bf16 ulp)."""
    wavs = _wavs(kind)
    scales = [1.0, 0.5, 2.0, 1.3]
    kw = dict(cfg=small_cfg(tcfg), wire=wire, compute_dtype=dtype)
    port = tapi.ASR(device="cpu", **kw)
    up = port._upload(port._prep(wavs, scales))
    feats, lens = port._featurize(up)
    buf, flens, sc = up.tensors
    name = ("padded" if wire == "padded" else "adpcm"
            if wire == "adpcm" and buf.dtype == torch.uint8 else "flat")
    if name == "padded":
        ef, el = tfeat.featurize_batch(buf, flens, port.cfg.audio,
                                       norm_eps=1e-6, scale=sc)
    elif name == "adpcm":
        ef, el = tfeat.featurize_adpcm(buf, flens, up.N, port.cfg.audio,
                                       norm_eps=1e-6, scale=sc)
    else:
        ef, el = tfeat.featurize_flat(buf, flens, up.N, port.cfg.audio,
                                      norm_eps=1e-6, scale=sc)
    assert feats.dtype == port.compute_dtype
    assert torch.equal(feats, ef.to(port.compute_dtype))
    assert torch.equal(lens, torch.clamp(el, min=1))

    ja = japi.ASR(cfg=small_cfg(jcfg), wire=wire, compute_dtype=dtype)
    if wire == "padded":
        jf, jl = ja._featurize_device(*ja._upload(ja._prep_host(wavs,
                                                                scales)))
    else:
        jf, jl = ja._featurize_flat_device(
            *ja._upload_flat(ja._prep_flat(wavs, scales)))
    np.testing.assert_array_equal(N(lens), np.asarray(jl))
    got = N(feats.float())
    want = np.asarray(jf, np.float32)
    slack = ATOL_FEATS + (BF16_REL * np.abs(want) if dtype == "bfloat16"
                          else 0.0)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= slack).all()


def test_front_end_jit_equals_its_eager_function_on_the_cpu():
    """``front_end_jit`` and ``featurize_batch_jit`` on CPU tensors run
    their eager functions: equal bit for bit, and no program is
    cached."""
    from chinese_asr_tpu_torch.utils import graphs
    cfg = tcfg.AudioConfig()
    rng = np.random.default_rng(9)
    wavs = random_wavs(rng, [12000, 5000])
    mat = np.zeros((2, 16000), np.int16)
    for i, w in enumerate(wavs):
        mat[i, :len(w)] = w
    lens = torch.tensor([12000, 5000], dtype=torch.int32)
    sc = torch.tensor([1.0, 0.7])
    w = torch.from_numpy(mat)
    got = tfeat.front_end_jit("padded", w, lens, sc, 16000, cfg,
                              dtype=torch.bfloat16)
    f, fl = tfeat.featurize_batch(w, lens, cfg, norm_eps=1e-6, scale=sc)
    assert torch.equal(got[0], f.to(torch.bfloat16))
    assert torch.equal(got[1], torch.clamp(fl, min=1))
    got = tfeat.featurize_batch_jit(w, lens, cfg)
    f, fl = tfeat.featurize_batch(w, lens, cfg)
    assert torch.equal(got[0], f) and torch.equal(got[1], fl)
    assert graphs.programs() == []


def test_batches_to_device_equals_the_eager_featurizer(tmp_path):
    """The loader's device batches (``featurize_batch_jit``) equal
    ``featurize_batch`` of the same host batches."""
    from chinese_asr_tpu_torch.data import dataset as tds
    rng = np.random.default_rng(3)
    utts = []
    for i, n in enumerate([8000, 13000, 4000]):
        p = str(tmp_path / f"w{i}.wav")
        audio_io.write_wav(p, random_wavs(rng, [n])[0], 16000)
        utts.append(tds.Utterance(p, CHARS[i:i + 3]))
    man = str(tmp_path / "m.tsv")
    tds.write_manifest(man, utts)
    cfg = small_cfg(tcfg).with_("train", eval_batch_size=2)
    vocab = Vocab.build([CHARS * 3], max_num_words=20)
    loader = tds.make_eval_loader(man, cfg, vocab)
    got = list(tds.batches_to_device(loader, cfg, "cpu"))
    host = list(loader)
    assert len(got) == len(host) == 2
    for b, (wav_mat, wav_lens, *_) in zip(got, host):
        f, fl = tfeat.featurize_batch(torch.from_numpy(wav_mat),
                                      torch.from_numpy(wav_lens), cfg.audio)
        assert torch.equal(b.feats, f) and torch.equal(b.feat_lens, fl)
