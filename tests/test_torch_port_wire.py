"""PyTorch port: the lossy wires (8-bit mu-law, 4-bit ADPCM) against the
JAX package, on the CPU (K5's plain twin decodes the ADPCM wire).

Exact: the mu-law encoder and table, both ADPCM encoders (numpy and the
C++ copy) and the ADPCM decode are integer or table code, compared bit
for bit with JAX's; so are the wire buffers ``ASR._prep`` builds.
Tolerances: the mu-law decode computes ``exp2`` on each side, which
differs by f32 ulps across the frameworks (measured over all 256 codes:
2.4e-7 against JAX's decode, 6.6e-7 against the table made in f64);
stated atol 1e-6.  Features over the wires are compared at the
featurizer's atol 2e-4 (tests/test_torch_port_features.py: the same f32
front end summed in other orders).  Transcripts are compared exactly on
the golden shard's overfit model.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from chinese_asr_tpu import config as jcfg
from chinese_asr_tpu.api import ASR as JASR
from chinese_asr_tpu.audio import features as jfeat
from chinese_asr_tpu.runtime import native as jnative
from chinese_asr_tpu.vocab import Vocab as JVocab
from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.audio import features as tfeat
from chinese_asr_tpu_torch.data import audio_io
from chinese_asr_tpu_torch.ops.cuda import adpcm as tadpcm
from chinese_asr_tpu_torch.runtime import native as tnative
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import (CHARS, GOLD, N, golden_cfg, golden_wav_paths,
                             random_wavs)

ATOL_MULAW = 1e-6
ATOL_FEATS = 2e-4
K = tfeat.ADPCM_K


def _adpcm_inputs():
    """Speech-like, random, silent, clipped, full-scale square and sine
    blocks: every branch of the state machine (step index 0 and 95)."""
    rng = np.random.default_rng(11)
    n = 8 * K
    ar = np.convolve(rng.standard_normal(n), 0.95 ** np.arange(200),
                     "full")[:n]
    square = np.where((np.arange(2 * K) // 16) % 2, 32767, -32768)
    return {
        "speech_like": (ar / np.abs(ar).max() * 20000).astype(np.int16),
        "noise": (rng.standard_normal(3 * K) * 11000).clip(
            -32768, 32767).astype(np.int16),
        "silence": np.zeros(2 * K, np.int16),
        "clipped": np.full(K, 32767, np.int16),
        "square": square.astype(np.int16),
        "sine": (np.sin(np.arange(3 * K) / 5.0) * 30000).astype(np.int16),
        "one_block": (rng.standard_normal(K) * 3000).astype(np.int16),
    }


def test_mulaw_table_and_encoder_bit_exact():
    np.testing.assert_array_equal(tfeat.mulaw_decode_table(),
                                  jfeat.mulaw_decode_table())
    x = np.arange(-32768, 32768, dtype=np.int64).astype(np.int16)
    got = tfeat.mulaw_encode_i16(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jfeat.mulaw_encode_i16(x))


def test_mulaw_decode_matches_jax():
    q = np.arange(256, dtype=np.uint8)
    got = N(tfeat.mulaw_decode(torch.from_numpy(q)))
    assert got.dtype == np.float32
    ref = np.asarray(jfeat.mulaw_decode_jnp(jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL_MULAW)
    np.testing.assert_allclose(got, tfeat.mulaw_decode_table(), rtol=0,
                               atol=ATOL_MULAW)


@pytest.mark.parametrize("name", list(_adpcm_inputs()))
def test_adpcm_encoders_bit_exact(name, monkeypatch):
    """Port numpy, port C++, JAX numpy and JAX C++: one wire."""
    x = _adpcm_inputs()[name]
    assert tnative.get_adpcm() is not None, "the C++ encoder did not build"
    port_cpp = tfeat.adpcm_encode_flat(x)
    jax_cpp = jfeat.adpcm_encode_flat(x)
    monkeypatch.setattr(tnative, "get_adpcm", lambda: None)
    monkeypatch.setattr(jnative, "get_adpcm", lambda: None)
    port_np = tfeat.adpcm_encode_flat(x)
    jax_np = jfeat.adpcm_encode_flat(x)
    assert port_cpp.dtype == np.uint8
    assert port_cpp.size == tfeat.adpcm_bytes(len(x))
    for other in (port_np, jax_cpp, jax_np):
        np.testing.assert_array_equal(port_cpp, other)


def test_adpcm_encode_edge_inputs():
    """An empty input gives an empty wire; the input and a caller's
    ``out`` buffer are checked (ValueError, where JAX asserts) before raw
    pointers reach the C++ encoder."""
    empty = tfeat.adpcm_encode_flat(np.zeros(0, np.int16))
    assert empty.dtype == np.uint8 and empty.size == 0
    x = np.zeros(K, np.int16)
    good = np.empty(tfeat.adpcm_bytes(len(x)), np.uint8)
    assert tfeat.adpcm_encode_flat(x, out=good) is good
    with pytest.raises(ValueError):
        tfeat.adpcm_encode_flat(x, out=np.empty(3, np.uint8))
    with pytest.raises(ValueError):
        tfeat.adpcm_encode_flat(x, out=good.astype(np.int16))
    with pytest.raises(ValueError):
        tfeat.adpcm_encode_flat(
            x, out=np.empty((tfeat.adpcm_bytes(len(x)), 2), np.uint8)[:, 0])
    with pytest.raises(ValueError):
        tfeat.adpcm_encode_flat(np.zeros(K + 1, np.int16))
    with pytest.raises(ValueError):
        tfeat.adpcm_encode_flat(np.zeros(K, np.float32))


@pytest.mark.parametrize("name", list(_adpcm_inputs()))
def test_adpcm_decode_twin_bit_exact(name):
    x = _adpcm_inputs()[name]
    buf = jfeat.adpcm_encode_flat(x)
    nb = len(x) // K
    launches = tadpcm.launches
    got = N(tfeat.adpcm_decode_flat(torch.from_numpy(buf), nb))
    assert tadpcm.launches == launches            # the twin never counts
    ref = np.asarray(jfeat.adpcm_decode_flat(jnp.asarray(buf), nb))
    assert got.dtype == np.float32 and got.shape == (nb * K,)
    np.testing.assert_array_equal(got, ref)


def _snr(x, y):
    x = x.astype(np.float64)
    return 10 * np.log10((x ** 2).mean() / ((x - y) ** 2).mean())


def test_roundtrip_snr():
    """JAX's bounds (tests/test_wire.py): mu-law > 33 dB on noise, ADPCM >
    24 dB speech-like and > 12 dB on white noise, silence near zero."""
    rng = np.random.RandomState(2)
    x = (rng.randn(16000) * 8000).clip(-32768, 32767).astype(np.int16)
    dec = N(tfeat.mulaw_decode(torch.from_numpy(tfeat.mulaw_encode_i16(x))))
    assert _snr(x, dec * 32768.0) > 33.0
    z = N(tfeat.mulaw_decode(torch.from_numpy(
        tfeat.mulaw_encode_i16(np.zeros(10, np.int16)))))
    assert np.abs(z).max() < 1e-2

    def adpcm(x):
        L = -(-len(x) // K) * K
        xi = np.zeros(L, np.int16)
        xi[:len(x)] = x
        buf = tfeat.adpcm_encode_flat(xi)
        dec = N(tfeat.adpcm_decode_flat(torch.from_numpy(buf), L // K))
        return xi, dec * 32768.0, buf

    rng = np.random.RandomState(8)
    n = 16000
    s = np.convolve(rng.randn(n), 0.95 ** np.arange(200), "full")[:n]
    s += 0.3 * np.sin(2 * np.pi * 300 * np.arange(n) / 16000) \
        * np.abs(s).mean()
    s = (s / np.abs(s).max() * 20000).astype(np.int16)
    xi, dec, buf = adpcm(s)
    assert _snr(xi, dec) > 24.0
    assert buf.nbytes <= 0.26 * xi.nbytes
    w = (rng.randn(n) * 6000).clip(-32768, 32767).astype(np.int16)
    wi, wd, _ = adpcm(w)
    assert _snr(wi, wd) > 12.0
    _, zd, _ = adpcm(np.zeros(2 * K, np.int16))
    assert np.abs(zd).max() <= 2.0


def _flat_batch(rng, lens):
    wavs = random_wavs(rng, lens)
    flat = np.zeros(-(-sum(lens) // K) * K + K, np.int16)
    flat[:sum(lens)] = np.concatenate(wavs)
    return flat, np.array(lens, np.int32)


@pytest.mark.parametrize("wire", ["mulaw", "adpcm"])
def test_featurize_over_the_wire_matches_jax(wire):
    """Flagship front end (80 mels, deltas, x3 stack) over each wire; the
    padding past each row's length is exact zeros (mu-law code 0 decodes
    to -1.0: it is masked after the decode)."""
    rng = np.random.default_rng(4)
    pcm, lens = _flat_batch(rng, [7000, 3100, 5200])
    N_pad = 8000
    ja, ta = jcfg.AudioConfig(), tcfg.AudioConfig()
    sc = np.array([1.0, 0.5, 2.0], np.float32)
    if wire == "mulaw":
        buf = tfeat.mulaw_encode_i16(pcm)
        jf, jl = jfeat.featurize_flat(jnp.asarray(buf), jnp.asarray(lens),
                                      N_pad, ja, norm_eps=1e-6,
                                      scale=jnp.asarray(sc))
        tf_, tl = tfeat.featurize_flat(torch.from_numpy(buf),
                                       torch.from_numpy(lens), N_pad, ta,
                                       norm_eps=1e-6,
                                       scale=torch.from_numpy(sc))
        x = N(tfeat.unpack_flat(torch.from_numpy(buf),
                                torch.from_numpy(lens), N_pad))
    else:
        buf = tfeat.adpcm_encode_flat(pcm)
        jf, jl = jfeat.featurize_adpcm(jnp.asarray(buf), jnp.asarray(lens),
                                       N_pad, ja, norm_eps=1e-6,
                                       scale=jnp.asarray(sc))
        tf_, tl = tfeat.featurize_adpcm(torch.from_numpy(buf),
                                        torch.from_numpy(lens), N_pad, ta,
                                        norm_eps=1e-6,
                                        scale=torch.from_numpy(sc))
        flat = tfeat.adpcm_decode_flat(torch.from_numpy(buf), len(pcm) // K)
        x = N(tfeat.unpack_flat(flat, torch.from_numpy(lens), N_pad))
    np.testing.assert_array_equal(N(tl), np.asarray(jl))
    np.testing.assert_allclose(N(tf_), np.asarray(jf), rtol=0,
                               atol=ATOL_FEATS)
    for b, n in enumerate(lens):
        assert (x[b, n:] == 0).all() and np.abs(x[b, :n]).max() > 0


def _asr(pkg, wire, **kw):
    if pkg == "jax":
        from test_golden_shard import golden_cfg as jgolden_cfg
        return JASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=jgolden_cfg(), wire=wire,
                    vocab=JVocab.build([CHARS * 3], max_num_words=8), **kw)
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg), wire=wire,
                    vocab=Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", **kw)


@pytest.mark.parametrize("flat_pow2", [False, True])
@pytest.mark.parametrize("wire", ["mulaw", "adpcm"])
def test_wire_buffer_equals_jax(wire, flat_pow2):
    """``_prep``'s wire buffer is JAX's ``_prep_flat`` buffer byte for
    byte: for ADPCM the length rounds up to whole blocks after the linear
    or power-of-two bucketing (1600 * 2^j is no multiple of 256), so the
    block count and boundaries are JAX's."""
    rng = np.random.default_rng(6)
    wavs = random_wavs(rng, [2300, 4100, 1700])
    kw = dict(wav_bucket=1600, flat_pow2=flat_pow2)
    buf, lens, _, n_pad = _asr("port", wire, **kw)._prep(wavs, None)
    jbuf, jmeta, jn = _asr("jax", wire, **kw)._prep_flat(wavs, None)
    assert buf.dtype == np.uint8 and n_pad == jn
    np.testing.assert_array_equal(buf, jbuf)
    np.testing.assert_array_equal(lens, jmeta[0].astype(np.int32))
    if wire == "adpcm":
        assert len(buf) % (3 + K // 2) == 0


@pytest.mark.parametrize("wire", ["mulaw", "adpcm"])
def test_mixed_dtype_falls_back_to_the_f32_wire(wire):
    """A float wav in the batch: the float32 flat wire, whose transcripts
    are the flat wire's."""
    rng = np.random.default_rng(7)
    wavs = [random_wavs(rng, [9000])[0], random_wavs(rng, [5000],
                                                     int16=False)[0]]
    asr = _asr("port", wire, bw=4)
    buf, *_ = asr._prep(wavs, None)
    assert buf.dtype == np.float32
    got = asr.transcribe_wavs(wavs)
    assert got == _asr("port", "flat", bw=4).transcribe_wavs(wavs)
    assert got == _asr("jax", wire, bw=4).transcribe_wavs(wavs)


@pytest.mark.parametrize("mode,bw", [("greedy", None), ("beam_bw4", 4)])
@pytest.mark.parametrize("wire", ["mulaw", "adpcm"])
def test_golden_shard_over_the_wire_matches_jax(wire, mode, bw,
                                                monkeypatch):
    """The golden wavs read as int16 (as ``transcribe_files`` reads a
    wav), so the batch really ships over the uint8 wire."""
    port = _asr("port", wire, bw=bw)
    shipped = []
    real = port._upload

    def spy(prep):
        shipped.append(prep[0].dtype)
        return real(prep)
    monkeypatch.setattr(port, "_upload", spy)
    wavs = [audio_io.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    scales = [audio_io.peak_scale(w) for w in wavs]
    got = port.transcribe_wavs(wavs, scales=scales)
    assert shipped == [np.uint8]
    assert got == port.transcribe_files(golden_wav_paths())
    assert got == _asr("jax", wire, bw=bw).transcribe_files(
        golden_wav_paths())


def test_unknown_wire_is_refused():
    with pytest.raises(ValueError, match="wire"):
        tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", wire="opus")
