"""Observability: timers, EMA smoothing, metric logging, alignment images
(port of ``chinese_asr_tpu/utils/observe.py``; reference util.py:1576-1588
``Duration``, util.py:2379-2397 ``EMA``, util.py:307-423 alignment image
export, util.py:298-304 transcript sampling), a JSONL metrics logger in
place of the reference's missing TensorBoard ``Logger`` (model.py:6), and
the program's spans.

Spans (``span``) mark the program's layer boundaries on the
``torch.profiler`` timeline and clock, beside the card's kernels, copies
and memsets, so that each gap in the card's work can be put down to what
the host was doing.  They record only while a profiler session records;
otherwise a span costs one check.  To get them, open any
``torch.profiler.profile(...)`` around the calls, then
``export_chrome_trace``; with ``record_shapes=True`` each span's args
carry its ``detail``.  A span is a host range (a ``cpu_op`` row, not a
``user_annotation``), so it adds no row to the card's timeline.

  asr.call              ``ASR.transcribe_wavs``, the whole call
                        (call number, rows, chunks); around each chunk's
                        calls of
  asr.prep              ``_prep`` / ``_prep_rows``: the chunk's wire
                        buffer on the host (chunk, B, N)
  asr.upload            ``_upload``: the copy issued (chunk, wire bytes)
  asr.featurize         ``_featurize``: the copy-event wait queued, the
                        front end's graph launched (chunk)
  asr.dispatch          ``_decode_dispatch`` with ``_to_host`` (chunk)
  asr.finalize          ``_decode_finalize`` (chunk), which holds
    asr.finalize.wait   the host blocked on the chunk's result copy
    asr.finalize.detok  what follows: the winner's detokenize (and the
                        host LM's rescoring), ``graphs.settle`` included
  asr.encode            ``models/las.py`` ``encode``: the encoder (B, T),
                        where it runs eagerly: on the CPU, and a train
                        step outside a graph.  Inside a captured graph
                        (the card's decode, its train step) a host span
                        times nothing: it ran once, at capture
  asr.train.load        ``Trainer.fit``: the next batch from the loader
                        (upload and featurize) (step)
  asr.train.step        the step call: coins, input copies, graph replay
                        (step, (T, S))
  asr.train.read        the loss and grad-norm read, which waits for the
                        step (step)
  asr.train.log         the EMA, the console line and the logger (step)
  asr.serve.batch       ``MicroBatcher``: one batch's ``transcribe_wavs``
                        (rows, padded rows)

The spans of one chunk share its index, those of one step its number.
No span but ``asr.encode`` sits inside a function a CUDA graph
captures: there it runs only at capture.

Counters (``register_counters``) are module-level ints that count what
the card ran: each kernel module's launches and fallbacks, the
Conformer's and the E-Branchformer's blocks (``conformer.blocks``,
``e_branchformer.blocks``).  A module registers its own where it
defines them, each under ``<module's last name>.<attribute>``
(``topk.launches``); ``utils/graphs.py`` takes a capture's changes back
out and adds them at each replay, so the counters keep meaning work on
the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

_OFF = contextlib.nullcontext()


class Duration:
    """Accumulating tic/toc timer (reference util.py:1576-1588)."""

    def __init__(self, seconds: float = 0.0):
        self.seconds = seconds
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        assert self._t0 is not None, "toc() before tic()"
        dt = time.perf_counter() - self._t0
        self.seconds += dt
        self._t0 = None
        return dt

    def __enter__(self):
        self.tic()
        return self

    def __exit__(self, *exc):
        self.toc()

    def __str__(self) -> str:
        s = int(self.seconds)
        return f"{s // 3600}:{s % 3600 // 60:02d}:{s % 60:02d}"


class EMA:
    """Exponential moving average of a scalar (reference util.py:2379-2397)."""

    def __init__(self, decay: float = 0.99):
        self.decay = decay
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        x = float(x)
        self.value = x if self.value is None else \
            self.decay * self.value + (1.0 - self.decay) * x
        return self.value


class MetricsLogger:
    """JSONL scalar/text logger — the working replacement for the reference's
    missing TensorBoard Logger (model.py:227-231 call sites).  One line per
    event: {"step": int, "tag": str, "value": ...}."""

    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._f = open(self.path, "a", buffering=1)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value)}) + "\n")

    def text(self, tag: str, value: str, step: int) -> None:
        self._f.write(json.dumps(
            {"step": step, "tag": tag, "text": value}) + "\n")

    def image(self, tag: str, img: np.ndarray, step: int) -> None:
        """Store image summaries as .npy next to the log (no TB dependency)."""
        d = os.path.join(os.path.dirname(self.path), "images")
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, f"{tag.replace('/', '_')}-{step}.npy")
        np.save(p, img)
        self._f.write(json.dumps({"step": step, "tag": tag, "image": p}) + "\n")

    def close(self) -> None:
        self._f.close()


def alignment_to_image(align: np.ndarray, feat_len: int, text_len: int
                       ) -> np.ndarray:
    """One attention alignment [S, L] -> uint8 heatmap [text_len, feat_len]
    (reference parse_batch_alignment util.py:307-355: crop to true lengths,
    scale to 0-255)."""
    a = np.asarray(align)[:text_len, :feat_len]
    lo, hi = float(a.min()), float(a.max())
    if hi <= lo:
        return np.zeros_like(a, dtype=np.uint8)
    return ((a - lo) / (hi - lo) * 255.0).astype(np.uint8)


def batch_alignment_images(aligns: np.ndarray, feat_lens: Sequence[int],
                           text_lens: Sequence[int]) -> List[np.ndarray]:
    """[B, S, L] -> list of per-sample heatmaps (util.py:358-423)."""
    return [alignment_to_image(aligns[i], int(feat_lens[i]), int(text_lens[i]))
            for i in range(len(aligns))]


def rand_disp_list(preds: Sequence[str], refs: Sequence[str], n: int = 3,
                   rng: Optional[random.Random] = None) -> List[str]:
    """Sample n (pred, ref) pairs for console/TB display (util.py:298-304)."""
    rng = rng or random
    idx = rng.sample(range(len(preds)), min(n, len(preds)))
    return [f"pred: {preds[i]} | ref: {refs[i]}" for i in idx]


def span(name: str, detail: Union[str, Callable[[], str], None] = None):
    """A context manager that marks ``name`` (``asr.``...) on the profiler's
    timeline while a ``torch.profiler`` session records, with ``detail``
    (a string, or a callable that builds one, called only then) as its
    args; otherwise one shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if detail is None:
        return torch._C._profiler._RecordFunctionFast(name)
    if callable(detail):
        detail = detail()
    return torch._C._profiler._RecordFunctionFast(name, (),
                                                  {"detail": str(detail)})


# name -> (module, attribute) of every registered counter, in the order
# of registration
_counters: Dict[str, tuple] = {}


def register_counters(module: str, *attrs: str) -> None:
    """Register the module-level int counters ``attrs`` of the module
    named ``module`` (its ``__name__``, while it imports), each under
    ``<module's last name>.<attribute>``.  Raises where another module's
    counter has that name."""
    mod = sys.modules[module]
    for attr in attrs:
        name = f"{module.rsplit('.', 1)[-1]}.{attr}"
        old = _counters.get(name)
        if old is not None and (old[0].__name__, old[1]) != (module, attr):
            raise ValueError(f"counter {name} of {module} is already "
                             f"{old[0].__name__}.{old[1]}")
        _counters[name] = (mod, attr)


def counters() -> Dict[str, tuple]:
    """Every registered counter: name -> (module, attribute)."""
    return dict(_counters)


def counts() -> Dict[str, int]:
    """Every registered counter's value, by name."""
    return {n: getattr(mod, attr) for n, (mod, attr) in _counters.items()}


def count_changes(before: Dict[str, int]) -> Dict[str, int]:
    """The counters that moved since ``counts()`` gave ``before`` (a
    counter registered since counts from 0), by name."""
    return {n: v - before.get(n, 0) for n, v in counts().items()
            if v != before.get(n, 0)}


def add_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (name -> change) to the registered counters."""
    for n, d in delta.items():
        mod, attr = _counters[n]
        setattr(mod, attr, getattr(mod, attr) + d)
