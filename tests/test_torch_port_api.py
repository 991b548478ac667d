"""PyTorch port: the ASR entry point on the CPU.

* The golden shard (tests/golden/) reproduces ``expected.json``'s greedy
  and beam_bw4 transcripts exactly, over both wires, with chunking.
* The package imports neither ``jax`` nor the JAX package.
* No silent fallback: without CUDA and without an explicit device the
  entry points raise, and the modes of later slices raise
  NotImplementedError (the LM modes, ``lm_mode="first"`` included, are in
  tests/test_torch_port_rescore.py and tests/test_torch_port_lm_first.py).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "chinese_asr_tpu_torch")


def _golden_asr(**kw):
    return tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                    cfg=golden_cfg(tcfg),
                    vocab=Vocab.build([CHARS * 3], max_num_words=8),
                    device="cpu", **kw)


@pytest.fixture(scope="module")
def expected():
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("wire", ["flat", "padded"])
@pytest.mark.parametrize("mode,bw", [("greedy", None), ("beam_bw4", 4)])
def test_golden_transcripts_reproduced(expected, mode, bw, wire):
    asr = _golden_asr(bw=bw, wire=wire)
    assert asr.transcribe_files(golden_wav_paths()) == expected["modes"][mode]
    assert asr(golden_wav_paths()[2]) == expected["modes"][mode][2]


def test_chunked_transcription_restores_order(expected):
    """More wavs than max_batch: length-sorted chunks, order restored."""
    from chinese_asr_tpu_torch.data import audio_io
    asr = _golden_asr(bw=4)
    wavs = [audio_io.read_wav(p, 16000, dtype="int16")[0]
            for p in golden_wav_paths()]
    scales = [audio_io.peak_scale(w) for w in wavs]
    got = asr.transcribe_wavs(wavs, max_batch=4, scales=scales)
    assert got == expected["modes"]["beam_bw4"]
    assert asr.transcribe_wavs([]) == []


def test_package_imports_no_jax():
    code = ("import sys, chinese_asr_tpu_torch.api, "
            "chinese_asr_tpu_torch.ops.cuda.build, "
            "chinese_asr_tpu_torch.lm.ngram, "
            "chinese_asr_tpu_torch.lm.device_ngram, "
            "chinese_asr_tpu_torch.decode.rescore, "
            "chinese_asr_tpu_torch.serve, chinese_asr_tpu_torch.evaluate, "
            "chinese_asr_tpu_torch.data.dataset; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'chinese_asr_tpu' or "
            "m.startswith('chinese_asr_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|jaxlib\b|chinese_asr_tpu\b"
                     r"(?!_torch))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert not pat.search(src), path


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.ASR(cfg=golden_cfg(tcfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.main(["--wav", golden_wav_paths()[0]])


@pytest.mark.parametrize("kw", [dict(mesh="auto"),
                                dict(compute_dtype="bfloat16"),
                                dict(wire="mulaw"), dict(wire="adpcm")])
def test_later_slice_modes_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", **kw)


def test_vocab_size_check_and_cli(capsys):
    with pytest.raises(ValueError, match="vocab size"):
        tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"), device="cpu")
    tapi.main(["--wav", golden_wav_paths()[0], "--bw", "2",
               "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    path, text = line.split("\t")
    assert path == golden_wav_paths()[0] and re.fullmatch(r"(<\d+>)*", text)


def test_random_weights_are_seeded_and_deterministic():
    rng = np.random.default_rng(0)
    wavs = [(rng.standard_normal(n) * 3000).astype(np.int16)
            for n in (9000, 4000)]
    a = tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", bw=2, seed=3)
    b = tapi.ASR(cfg=golden_cfg(tcfg), device="cpu", bw=2, seed=3)
    assert a.transcribe_wavs(wavs) == b.transcribe_wavs(wavs)
