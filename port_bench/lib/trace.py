"""The benchmark's tracing: host spans around the program's bound methods,
and the profiler's device trace of a window.

Spans are kept in memory: each is (name, seconds) on the host clock, and
in a traced window also a ``record_function`` range, so the trace places
it beside the device's work.  ``fullest`` traces a window a few times and
keeps the trace with the most device records: the card's trace of the
same work can lose records, and a lost record must not read as a faster
kernel.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

TRIES = 3
WINDOW = "bench.window"


class Spans:
    """Host-clock spans by name; ``wrap`` puts one around a bound method."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.annotate = False

    def wrap(self, obj, method: str, name: str, after: Callable = None):
        fn = getattr(obj, method)

        @functools.wraps(fn)
        def spanned(*a, **kw):
            t = time.perf_counter()
            if self.annotate:
                with torch.profiler.record_function(name):
                    out = fn(*a, **kw)
            else:
                out = fn(*a, **kw)
            self.times[name].append(time.perf_counter() - t)
            if after is not None:
                after(a, kw, out)
            return out

        setattr(obj, method, spanned)

    def clear(self):
        self.times.clear()


def _device_events(prof):
    """(kernel rows [(name, start_us, end_us)], other device rows, host
    annotation rows) of a finished profile."""
    from torch.autograd import DeviceType
    kernels, other, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.name.startswith("bench."):
            # the benchmark's own annotations; on the device's timeline
            # they are ranges, not work
            if e.device_type == DeviceType.CPU:
                host.append((e.name, float(tr.start), float(tr.end)))
        elif e.device_type == DeviceType.CUDA:
            row = (e.name, float(tr.start), float(tr.end))
            name = e.name.lower()
            if name.startswith(("memcpy", "memset")) or "memcpy" in name \
                    or "memset" in name:
                other.append(row)
            else:
                kernels.append(row)
    return kernels, other, host


def _union(rows, lo: float, hi: float):
    """Merged [start, end] intervals of ``rows`` clipped to [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in rows
                if e > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, counted: dict) -> dict:
    """A traced window's device records and host annotations, reduced:
    ``busy_s`` (the union of the device's records within the window),
    ``window_s``, the kernels' device seconds and counts by name, the
    longest idle gaps with the host span they fall in, and the launch
    counters' increase over the window (``counted``)."""
    kernels, other, host = _device_events(prof)
    win = [h for h in host if h[0] == WINDOW]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    lo, hi = win[0][1], win[0][2]
    busy = _union(kernels + other, lo, hi)
    by_name: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    for name, s, e in kernels:
        if e > lo and s < hi:
            by_name[name][0] += (e - s) / 1e6
            by_name[name][1] += 1
    gaps = []
    prev = lo
    for s, e in busy + [[hi, hi]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    spans = [h for h in host if h[0] != WINDOW]

    def doing(a, b):
        mid = (a + b) / 2
        names = [n for n, s, e in spans if s <= mid <= e]
        return names[-1][len("bench."):] if names else "between spans"

    gaps.sort(key=lambda g: g[0] - g[1])
    return dict(
        busy_s=sum(e - s for s, e in busy) / 1e6,
        window_s=(hi - lo) / 1e6,
        kernels={n: (v[0], v[1]) for n, v in by_name.items()},
        records=len(kernels) + len(other),
        idle_gaps=[[doing(a, b), (b - a) / 1e6] for a, b in gaps[:10]],
        counted=counted)


def fullest(fn: Callable, spans: Spans, counters: Dict[str, tuple]) -> dict:
    """``fn`` (one window of work) traced ``TRIES`` times; the summary of
    the trace with the most device records, with the host spans of that
    window (``spans``'s times, cleared before each try)."""
    from torch.profiler import ProfilerActivity, profile
    best = None
    spans.annotate = True
    try:
        for _ in range(TRIES):
            spans.clear()
            before = {n: getattr(m, a) for n, (m, a) in counters.items()}
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(WINDOW):
                    work = fn()
                    torch.cuda.synchronize()
            counted = {n: getattr(m, a) - before[n]
                       for n, (m, a) in counters.items()}
            s = summarize(prof, counted)
            s["spans"] = {k: list(v) for k, v in spans.times.items()}
            s["work"] = work
            del prof
            if best is None or s["records"] > best["records"]:
                best = s
    finally:
        spans.annotate = False
    return best


def kernel_seconds(summary: dict, names) -> tuple:
    """(device seconds, records) of the trace's kernels whose name holds
    any of ``names``."""
    secs, n = 0.0, 0
    for k, (s, c) in summary["kernels"].items():
        if any(m in k for m in names):
            secs += s
            n += c
    return secs, n


def count_notes(summary: dict, maps: dict) -> list:
    """A line for each kernel whose records in the trace differ from its
    launch counters' increase over the window."""
    out = []
    for k, m in maps.items():
        _, n = kernel_seconds(summary, m["names"])
        counted = sum(summary["counted"][f"{mod.rsplit('.', 1)[1]}.{a}"]
                      for mod, a in m["counters"])
        if n != counted:
            out.append(f"note: {k}: {n} records in the trace, {counted} "
                       f"launches counted")
    return out


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took the most time, and the ten longest idle gaps by what the host
    was doing."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[_short(n), v[0]] for n, v in ops],
            "idle_gaps": summary["idle_gaps"]}


def _short(name: str, n: int = 96) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."
