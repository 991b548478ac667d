"""PyTorch port: HTTP serving with request micro-batching (serve.py) on the
CPU, the cases of tests/test_serve.py against the port's server, and the
golden shard served over HTTP against ``expected.json`` (the JAX
package's transcripts).

The server runs on its ``ASR``'s device; these tests build it with
``device="cpu"``.  Without a GPU and without ``--device cpu`` the CLI's
serving modes refuse to start.
"""

import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
import wave as wave_mod

import numpy as np
import pytest
import torch

from chinese_asr_tpu_torch import api as tapi
from chinese_asr_tpu_torch import config as tcfg
from chinese_asr_tpu_torch import serve as tserve
from chinese_asr_tpu_torch.vocab import Vocab

from torch_port_util import CHARS, GOLD, golden_cfg, golden_wav_paths


def _small_cfg():
    return (tcfg.Config()
            .with_("encoder", hidden_size=16, num_layers=2)
            .with_("decoder", hidden_size=32, embed_dim=12)
            .with_("attention", attn_size=8)
            .with_("vocab", max_num_words=20)
            .with_("decode", max_len=8))


def _small_asr():
    cfg = _small_cfg()
    return tapi.ASR(cfg=cfg, bw=2, wav_bucket=1600, device="cpu",
                    vocab=tapi._identity_vocab(cfg.vocab.vocab_size))


def _wav_bytes(seed: int, n: int = 8000) -> bytes:
    rng = np.random.RandomState(seed)
    pcm = (rng.randn(n) * 6000).clip(-32768, 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    return buf.getvalue()


def _start(asr, **kw):
    srv = tserve.serve_http(asr, port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _close(srv):
    srv.shutdown()
    srv.server_close()                       # also stops the batcher thread
    assert not srv.batcher._thread.is_alive()


@pytest.fixture(scope="module")
def server():
    asr = _small_asr()
    srv = _start(asr, window_ms=120.0)
    yield srv, asr
    _close(srv)


def _post(port: int, data: bytes, path: str = "/transcribe"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _healthz(port: int):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as r:
        return json.loads(r.read())


def _concurrent(fn, n):
    out = [None] * n
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    return out


def test_transcribe_endpoint_matches_direct(server):
    srv, asr = server
    data = _wav_bytes(0)
    status, obj = _post(srv.server_port, data)
    assert status == 200
    assert obj["text"] == asr.transcribe_bytes(data)


def test_healthz(server):
    srv, _ = server
    obj = _healthz(srv.server_port)
    assert obj["ok"] is True and obj["backend"] == "cpu"
    assert {"batches", "requests", "rejected"} <= set(obj)


def test_bad_audio_is_400_and_server_survives(server):
    srv, asr = server
    for body in (b"this is not audio at all", _wav_bytes(1, 0)):
        status, obj = _post(srv.server_port, body)
        assert status == 400 and "error" in obj
    status, obj = _post(srv.server_port, _wav_bytes(5))
    assert status == 200 and obj["text"] == asr.transcribe_bytes(_wav_bytes(5))


def test_unknown_path_404(server):
    srv, _ = server
    status, _ = _post(srv.server_port, b"x", path="/nope")
    assert status == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.server_port}/nope",
                               timeout=10)
    assert e.value.code == 404


def test_concurrent_requests_are_microbatched(server):
    """Concurrent posts coalesce into fewer decode batches than requests,
    each transcript equal to its direct single-utterance result."""
    srv, asr = server
    payloads = [_wav_bytes(100 + i, 6000 + 400 * i) for i in range(6)]
    expect = [asr.transcribe_bytes(p) for p in payloads]
    before = srv.batcher.batches
    results = _concurrent(lambda i: _post(srv.server_port, payloads[i]),
                          len(payloads))
    assert all(s == 200 for s, _ in results)
    assert [o["text"] for _, o in results] == expect
    assert srv.batcher.batches - before < len(payloads)


def test_microbatcher_sheds_load_when_queue_full():
    """Saturation degrades to a fast rejection (Overloaded), not unbounded
    queueing; the queued requests still complete."""
    entered = threading.Event()   # worker is inside decode #1
    release = threading.Event()   # let decode #1 finish

    class SlowASR:
        cfg = _small_cfg()

        def transcribe_wavs(self, wavs, max_batch=128, scales=None):
            entered.set()
            release.wait(timeout=30)
            return ["x"] * len(wavs)

    mb = tserve.MicroBatcher(SlowASR(), max_batch=1, window_ms=0.0,
                             pad_batches=False, max_queue=2)
    wav = np.zeros(10, np.int16)
    done = []
    ths = [threading.Thread(target=lambda: done.append(mb.submit(wav, 1.0)))
           for _ in range(3)]
    ths[0].start()
    assert entered.wait(timeout=30)     # worker holds #1 in decode...
    for t in ths[1:]:
        t.start()
    for _ in range(3000):               # ...while #2/#3 fill the queue
        if mb._q.qsize() >= 2:
            break
        time.sleep(0.01)
    assert mb._q.qsize() >= 2
    with pytest.raises(tserve.Overloaded):
        mb.submit(wav, 1.0)
    release.set()
    for t in ths:
        t.join(timeout=30)
    assert done == ["x"] * 3
    assert mb.rejected == 1
    mb.stop()
    assert not mb._thread.is_alive()


def test_http_429_on_overload(server):
    """A saturated batcher maps to HTTP 429 with Retry-After and a JSON
    error body; the server still serves afterwards."""
    srv, _ = server

    def boom(wav, scale, timeout=None):
        raise tserve.Overloaded("pending queue at capacity (test)")

    srv.batcher.submit = boom     # instance attr shadows the method
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_port}/transcribe",
        data=_wav_bytes(9), method="POST")
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
    finally:
        del srv.batcher.submit    # restore the class method
    assert e.value.code == 429 and e.value.headers["Retry-After"] == "1"
    assert "capacity" in json.loads(e.value.read())["error"]
    status, _ = _post(srv.server_port, _wav_bytes(9))
    assert status == 200


def test_decode_failure_is_500(server):
    """A decode that raises fails its batch's requests with a 500; there
    is no retry on another device."""
    srv, asr = server

    def broken(*a, **k):
        raise RuntimeError("device fault (test)")

    asr.transcribe_wavs = broken
    try:
        status, obj = _post(srv.server_port, _wav_bytes(3))
    finally:
        del asr.transcribe_wavs
    assert status == 500 and "device fault" in obj["error"]
    assert _post(srv.server_port, _wav_bytes(3))[0] == 200


def test_microbatcher_direct():
    """Batcher-level check without HTTP: coalescing + order fidelity."""
    asr = _small_asr()
    mb = tserve.MicroBatcher(asr, max_batch=8, window_ms=150.0)
    rng = np.random.RandomState(7)
    wavs = [(rng.randn(4800 + 320 * i) * 6000).astype(np.int16)
            for i in range(5)]
    expect = asr.transcribe_wavs(list(wavs), scales=[1.0] * len(wavs))
    out = _concurrent(lambda i: mb.submit(wavs[i], 1.0), len(wavs))
    assert out == expect
    assert mb.batches < len(wavs)
    mb.stop()
    assert not mb._thread.is_alive()         # no leaked worker threads


def test_microbatcher_batch_ladder():
    """Collected batches pad to the next power of two with dummies of the
    batch's dtype, without changing any transcript; warm() runs every
    ladder size."""
    asr = _small_asr()
    sizes = []
    orig = asr.transcribe_wavs

    def spy(wavs, *a, **k):
        sizes.append((len(wavs), {np.asarray(w).dtype for w in wavs}))
        return orig(wavs, *a, **k)

    asr.transcribe_wavs = spy
    mb = tserve.MicroBatcher(asr, max_batch=8, window_ms=50.0)
    assert [mb._ladder(n) for n in (1, 2, 3, 4, 5, 7, 8)] == \
        [1, 2, 4, 4, 8, 8, 8]
    rng = np.random.RandomState(3)
    wav = (rng.randn(4000) * 6000).astype(np.int16)
    assert mb.warm(wav) == 4                    # sizes 1, 2, 4, 8
    assert [n for n, _ in sizes] == [1, 2, 4, 8]
    # a 3-request burst rides one padded batch and matches direct decode
    for dtype in (np.int16, np.float32):
        wavs = [(rng.randn(4000 + 200 * i) * 6000).astype(np.int16)
                for i in range(3)]
        if dtype == np.float32:
            wavs = [w.astype(np.float32) / 32768.0 for w in wavs]
        expect = orig(list(wavs), scales=[1.0] * 3)
        sizes.clear()
        out = _concurrent(lambda i: mb.submit(wavs[i], 1.0), 3)
        assert out == expect
        assert sizes == [(4, {np.dtype(dtype)})]
    mb.stop()
    # unpadded mode keeps exact batch sizes
    mb2 = tserve.MicroBatcher(asr, max_batch=8, window_ms=50.0,
                              pad_batches=False)
    assert mb2._ladder(5) == 5
    mb2.stop()


def test_golden_shard_served_over_http():
    """The golden checkpoint served over HTTP reproduces expected.json's
    greedy and beam_bw4 transcripts, sent concurrently into one batch."""
    with open(os.path.join(GOLD, "expected.json"), encoding="utf-8") as f:
        expected = json.load(f)["modes"]
    bodies = []
    for p in golden_wav_paths():
        with open(p, "rb") as f:
            bodies.append(f.read())
    for mode, bw in (("greedy", None), ("beam_bw4", 4)):
        asr = tapi.ASR(ckpt_path=os.path.join(GOLD, "model.ckpt"),
                       cfg=golden_cfg(tcfg), bw=bw, device="cpu",
                       vocab=Vocab.build([CHARS * 3], max_num_words=8))
        srv = _start(asr, window_ms=2000.0, max_batch=8)
        try:
            got = _concurrent(lambda i: _post(srv.server_port, bodies[i]),
                              len(bodies))
            assert [s for s, _ in got] == [200] * len(bodies)
            assert [o["text"] for _, o in got] == expected[mode]
            assert srv.batcher.batches == 1
        finally:
            _close(srv)


def test_cli_serve_reads_paths_from_stdin(monkeypatch, capsys, tmp_path):
    """--serve: audio paths on stdin, one transcript per line; a failing
    path prints its error and the loop goes on."""
    paths = golden_wav_paths()[:2]
    lines = [paths[0], "", str(tmp_path / "missing.wav"), paths[1]]
    monkeypatch.setattr(sys, "stdin", io.StringIO("\n".join(lines) + "\n"))
    tapi.main(["--serve", "--bw", "2", "--device", "cpu",
               "--wav", paths[1]])
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split("\t")[0] for line in out] == \
        [paths[1], paths[0], str(tmp_path / "missing.wav"), paths[1]]
    assert out[2].split("\t")[1].startswith("ERROR: ")
    assert out[3] == out[0] and "ERROR" not in out[1]


def test_cli_serve_http_needs_a_gpu_or_device_cpu(monkeypatch, capsys):
    """--serve-http refuses to start without a GPU unless --device cpu;
    with it, the server answers /healthz with backend "cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--serve-http", "0"], ["--serve", "--bw", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.main(argv)
    with pytest.raises(SystemExit):
        tapi.main(["--device", "cpu"])          # nothing to do
    made = []
    real = tserve.serve_http

    def serve_http(asr, port, host):
        srv = real(asr, port=0, host="127.0.0.1")
        made.append(srv)

        def probe():
            made.append(_healthz(srv.server_port))
            srv.shutdown()
        threading.Thread(target=probe, daemon=True).start()
        return srv

    monkeypatch.setattr(tserve, "serve_http", serve_http)
    tapi.main(["--serve-http", "0", "--device", "cpu"])
    srv, health = made
    assert health["backend"] == "cpu" and health["ok"] is True
    assert not srv.batcher._thread.is_alive()   # server_close stopped it
    assert "serving on :" in capsys.readouterr().out
