"""HTTP serving with request micro-batching (port of
``chinese_asr_tpu/serve.py``).

The reference sketches (and comments out) a bytes-in web service handler
(main.py:9-16: AMR bytes -> ffmpeg -> parse).  This module is that
service: a batched decode costs far less per utterance than one decode per
request, so concurrent requests are coalesced by a micro-batcher.  The
first request opens a short window (default 15 ms) and everything that
arrives in it rides one batched ``transcribe_wavs`` call.

Endpoints:
  POST /transcribe[?suffix=.amr]  audio bytes in the body (WAV decodes
                                  directly; anything else goes through
                                  the ffmpeg transcoder) -> {"text": ...}
  GET  /healthz                   {"ok": true, "backend": "cuda", ...}
                                  and the batcher's counters

The counters in ``/healthz`` (``MicroBatcher``'s attributes, since its
start): ``batches``, the decode calls issued; ``requests``, the requests
they served; ``rejected``, the submits refused with a 429;
``queue_wait_s_sum``, ``queue_wait_s_max`` and ``queue_wait_n``, the
seconds from a request's ``submit`` to the worker taking it into a batch
(their sum, the longest, and how many); ``padded_rows``, the dummy rows
the batch ladder added.  Each batch's ``transcribe_wavs`` is the span
``asr.serve.batch`` (rows, padded rows; ``utils/observe.py``).

Run via ``python -m chinese_asr_tpu_torch.api --serve-http 8000 ...`` or
``serve_http(asr, port=8000).serve_forever()``.  The server decodes on the
device of its ``ASR``: ``cuda`` unless the ``ASR`` was built with
``device="cpu"``.  A request that fails on the device is a 500; nothing
is retried elsewhere.
"""

from __future__ import annotations

import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from .data import audio_io
from .utils.observe import span


def decode_request_audio(asr, data: bytes, suffix: str = ""
                         ) -> Tuple[np.ndarray, float]:
    """Audio BYTES -> (int16 waveform, device peak-gain scale).

    WAV bytes are read directly; anything else takes the reference's
    ffmpeg ingest (main.py:9-16/19-24).  Raises ValueError on undecodable
    or empty input -- callers turn that into a 400, BEFORE the request
    enters the shared batch."""
    is_wav = data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    with tempfile.NamedTemporaryFile(
            suffix=suffix or (".wav" if is_wav else ".bin"),
            delete=False) as tf:
        tf.write(data)
        src = tf.name
    tmp = None
    try:
        if not is_wav:
            with tempfile.NamedTemporaryFile(suffix=".wav",
                                             delete=False) as tf:
                tmp = tf.name
            try:
                audio_io.transcode(src, tmp, asr.cfg.audio.sample_rate)
            except Exception as e:      # ffmpeg missing or bytes it
                raise ValueError(       # cannot demux -> client 400
                    f"cannot transcode request audio: {e}") from e
            path = tmp
        else:
            path = src
        try:
            wav, _ = audio_io.read_wav(path, asr.cfg.audio.sample_rate,
                                       dtype="int16")
        except Exception as e:
            raise ValueError(f"undecodable audio: {e}") from e
        if wav.size == 0:
            raise ValueError("empty audio")
        return wav, audio_io.peak_scale(wav)
    finally:
        os.unlink(src)
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)


_STOP = object()         # MicroBatcher.stop sentinel


class Overloaded(RuntimeError):
    """Raised by ``MicroBatcher.submit`` when the pending queue is at
    ``max_queue``: saturation becomes a fast rejection (HTTP 429) with a
    bounded wait for the requests already queued, instead of a queue that
    grows without bound."""


class MicroBatcher:
    """Coalesce concurrent transcription requests into batched decodes.

    One worker thread owns every decode call, so every kernel runs on that
    thread's current stream.  The first queued request opens a
    ``window_ms`` collection window; up to ``max_batch`` requests that
    arrive inside it are decoded as ONE ``transcribe_wavs`` batch.  Under
    no concurrency this adds at most ``window_ms`` latency; under load a
    decode serves many requests.

    ``max_queue`` bounds the pending-request queue: a submit beyond it
    fails at once with :class:`Overloaded` (429 at the HTTP layer)
    rather than joining a queue whose wait already exceeds any useful
    deadline.  The default (None -> 4x ``max_batch``) bounds the queueing
    delay to ~4 full decode batches; pass 0 for an unbounded queue.

    An ``ASR`` over a mesh is refused: every rank would have to decode the
    batch this process forms from its own queue (ROADMAP)."""

    def __init__(self, asr, max_batch: int = 128, window_ms: float = 15.0,
                 pad_batches: bool = True, max_queue: Optional[int] = None):
        if getattr(asr, "mesh", None) is not None:
            raise ValueError("serving over a mesh is not supported: serve "
                             "an ASR without mesh=")
        self.asr = asr
        self.max_batch = max_batch
        self.max_queue = 4 * max_batch if max_queue is None else max_queue
        self.rejected = 0           # fast-failed submits
        self._rej_lock = threading.Lock()   # += races across HTTP threads
        self.window = window_ms / 1e3
        # Every batch size is another set of GEMM shapes for cuBLAS to
        # choose algorithms for (and, once the decode step is captured as
        # a CUDA graph, another graph).  Padding each batch up to the next
        # power of two bounds the sizes at log2(max_batch)+1 -- the usual
        # serving batch ladder -- for at most 2x padded device work.
        self.pad_batches = pad_batches
        self.batches = 0            # decode calls issued
        self.requests = 0
        self.padded_rows = 0        # dummy rows the ladder added
        self.queue_wait_s_sum = 0.0     # submit -> taken into a batch
        self.queue_wait_s_max = 0.0
        self.queue_wait_n = 0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _ladder(self, n: int) -> int:
        if not self.pad_batches:
            return n
        size = 1
        while size < n:
            size *= 2
        return min(size, self.max_batch)

    def warm(self, wav: np.ndarray, scale: float = 1.0) -> int:
        """Run every ladder batch size once on ``wav`` (cold-start control:
        the first requests otherwise pay cuBLAS's and the kernels' first
        calls).  Returns the number of decode calls issued."""
        sizes, n = [], 1
        while True:
            sizes.append(self._ladder(n))
            if sizes[-1] >= self.max_batch or not self.pad_batches:
                break
            n = sizes[-1] + 1
        for size in sizes:
            self.asr.transcribe_wavs([wav] * size, max_batch=self.max_batch,
                                     scales=[scale] * size)
        return len(sizes)

    def submit(self, wav: np.ndarray, scale: float,
               timeout: Optional[float] = None) -> str:
        """Block until the transcript for ``wav`` is ready; raises
        :class:`Overloaded` at once when the pending queue is at
        ``max_queue`` (qsize is approximate under concurrency: the cap is
        a load-shedding threshold, not an exact invariant)."""
        if self.max_queue and self._q.qsize() >= self.max_queue:
            with self._rej_lock:
                self.rejected += 1
            raise Overloaded(
                f"pending queue at capacity ({self.max_queue}); retry later")
        ev = threading.Event()
        box: dict = {}
        self._q.put((wav, scale, ev, box, time.monotonic()))
        if not ev.wait(timeout):
            raise TimeoutError("transcription timed out")
        if "err" in box:
            raise box["err"]
        return box["text"]

    def stop(self) -> None:
        """Stop the worker thread (a daemon, but a stopped batcher does not
        linger in long-lived processes that create many of them)."""
        self._q.put(_STOP)
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is _STOP:
                return
            batch = [first]
            deadline = time.monotonic() + self.window
            stopping = False
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if item is _STOP:
                    stopping = True      # finish this batch, then exit
                    break
                batch.append(item)
            now = time.monotonic()
            waits = [now - b[4] for b in batch]
            self.queue_wait_s_sum += sum(waits)
            self.queue_wait_s_max = max(self.queue_wait_s_max, *waits)
            self.queue_wait_n += len(batch)
            self.batches += 1
            self.requests += len(batch)
            pad = self._ladder(len(batch)) - len(batch)
            self.padded_rows += pad
            try:
                wavs = [b[0] for b in batch]
                scales = [b[1] for b in batch]
                if pad:
                    # dummies keep the batch dtype: an int16 dummy in a
                    # float batch (or vice versa) would flip the wire's
                    # dtype (api._prep keys on all-int16)
                    dt = np.asarray(wavs[0]).dtype
                    dt = np.int16 if np.issubdtype(dt, np.integer) else dt
                    wavs += [np.zeros(1, dt)] * pad
                    scales += [1.0] * pad
                with span("asr.serve.batch",
                          lambda: f"rows {len(batch)} padded {pad}"):
                    texts = self.asr.transcribe_wavs(
                        wavs, max_batch=self.max_batch, scales=scales)
                for (_, _, ev, box, _), text in zip(batch, texts):
                    box["text"] = text
                    ev.set()
            except Exception as e:  # noqa: BLE001 -- fail the whole batch
                for _, _, ev, box, _ in batch:
                    box["err"] = e
                    ev.set()
            if stopping:
                return


def _make_handler(asr, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, obj: dict, headers=()) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type",
                             "application/json; charset=utf-8")
            for k, v in headers:
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 -- http.server API
            if urlparse(self.path).path == "/healthz":
                self._reply(200, {
                    "ok": True,
                    "backend": asr.device.type,
                    "batches": batcher.batches,
                    "requests": batcher.requests,
                    "rejected": batcher.rejected,
                    "queue_wait_s_sum": batcher.queue_wait_s_sum,
                    "queue_wait_s_max": batcher.queue_wait_s_max,
                    "queue_wait_n": batcher.queue_wait_n,
                    "padded_rows": batcher.padded_rows,
                })
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/transcribe":
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(n)
                suffix = parse_qs(url.query).get("suffix", [""])[0]
                wav, scale = decode_request_audio(asr, data, suffix)
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            try:
                text = batcher.submit(wav, scale)
            except Overloaded as e:   # shed load, don't queue unbounded
                self._reply(429, {"error": str(e)},
                            headers=(("Retry-After", "1"),))
                return
            except Exception as e:  # noqa: BLE001 -- decode failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, {"text": text})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve_http(asr, port: int = 8000, host: str = "127.0.0.1",
               max_batch: int = 128, window_ms: float = 15.0,
               max_queue: Optional[int] = None) -> ThreadingHTTPServer:
    """Build the serving stack; call ``.serve_forever()`` on the result.
    ``server_port`` on the returned server reports the bound port (pass
    port=0 for an ephemeral one).  ``max_queue``: see
    :class:`MicroBatcher` (None -> 4x max_batch; a saturated queue replies
    429 + Retry-After instead of queueing without bound).  On the card the
    kernels are built here, before the first request could wait for
    nvcc."""
    if asr.device.type == "cuda":
        from .ops.cuda import build
        build.build()
    batcher = MicroBatcher(asr, max_batch=max_batch, window_ms=window_ms,
                           max_queue=max_queue)

    class _Server(ThreadingHTTPServer):
        # a burst of concurrent clients must fit the listen backlog: at the
        # default of 5, connections beyond it are dropped or reset and
        # their clients retry after a second
        request_queue_size = 128

        def server_close(self):  # stop the batcher thread with the server
            super().server_close()
            batcher.stop()

    server = _Server((host, port), _make_handler(asr, batcher))
    server.batcher = batcher  # type: ignore[attr-defined] -- introspection
    return server
