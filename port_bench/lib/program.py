"""The program's own spans (``asr.``..., ``chinese_asr_tpu_torch/utils/
observe.py``) in a traced window: how often each ran and its host
seconds, and the window's device-idle time put down to the innermost
span open at each instant.

The program's spans are host ranges.  Where a profile also shows an
``asr.`` range on the device's timeline (a ``record_function`` range
does), it is a range, not work: it counts neither as a device row nor
toward the busy time here.

``summarize`` reads a finished profile; the rest reads its result as a
trace summary holds it (``summary["program"]``), for the metric readers.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from port_bench.lib import trace

PREFIX = "asr."
NONE = "none"

Row = Tuple[str, float, float]


def summarize(prof) -> dict:
    """``{"spans": {name: [count, host seconds]}, "idle_by_span": {name:
    seconds}}`` of the program's spans in the traced window of ``prof``
    (its ``trace.WINDOW`` annotation).  A span is counted in the window
    where it starts there; its seconds and the idle time are clipped to
    the window."""
    from torch.autograd import DeviceType
    kernels, other, host = trace._device_events(prof)
    win = [h for h in host if h[0] == trace.WINDOW]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    lo, hi = win[0][1], win[0][2]
    device = [r for r in kernels + other if not r[0].startswith(PREFIX)]
    spans = [(e.name, float(e.time_range.start), float(e.time_range.end))
             for e in prof.events()
             if e.device_type == DeviceType.CPU
             and e.name.startswith(PREFIX)]
    spans = [s for s in spans if lo <= s[1] < hi]
    by_name: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for name, s, e in spans:
        by_name[name][0] += 1
        by_name[name][1] += (min(e, hi) - s) / 1e6
    idle = idle_by_span(spans, gaps(trace._union(device, lo, hi), lo, hi))
    return {"spans": dict(by_name),
            "idle_by_span": {n: us / 1e6 for n, us in idle.items()}}


def gaps(busy: Sequence[Sequence[float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that the merged, sorted ``busy``
    intervals leave uncovered."""
    out, prev = [], lo
    for s, e in list(busy) + [(hi, hi)]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def idle_by_span(spans: Sequence[Row], idle: Sequence[Tuple[float, float]]
                 ) -> Dict[str, float]:
    """The length of ``idle`` put down, instant by instant, to the
    innermost of ``spans`` covering it (the one that started last; of two
    that started together, the shorter), or to ``NONE``: each idle
    interval is split at the span edges inside it."""
    out: Dict[str, float] = defaultdict(float)
    for a, b in idle:
        inside = [r for r in spans if r[1] < b and r[2] > a]
        cuts = sorted({a, b} | {t for r in inside for t in r[1:]
                                if a < t < b})
        for p, q in zip(cuts, cuts[1:]):
            cover = [r for r in inside if r[1] <= p and r[2] >= q]
            name = max(cover, key=lambda r: (r[1], -r[2]))[0] if cover \
                else NONE
            out[name] += q - p
    return dict(out)


# ---- the summary as the metric readers read it ---------------------------
def of(rec: dict, kind: str) -> Optional[dict]:
    """The traced run's program summary where the run is of ``kind`` and
    its trace holds the program's spans; else None."""
    t = rec.get("trace")
    if rec["kind"] != kind or not t or not t.get("program", {}).get("spans"):
        return None
    return t["program"]


def count(p: dict, name: str) -> int:
    return p["spans"].get(name, (0, 0.0))[0]


def host_s(p: dict, *names: str) -> float:
    return sum(p["spans"].get(n, (0, 0.0))[1] for n in names)


def idle_s(p: dict, *names: str) -> float:
    return sum(p["idle_by_span"].get(n, 0.0) for n in names)


CHUNK = ("asr.prep", "asr.upload", "asr.featurize", "asr.dispatch",
         "asr.finalize")
STEP = ("asr.train.load", "asr.train.step", "asr.train.read",
        "asr.train.log")


def notes(rec: dict) -> List[str]:
    """Lines for standard error: the host ms of each span a chunk (or a
    step), the waits among them, how much of the call (or the window)
    the spans cover, and the window's idle ms by span."""
    kind = rec["kind"]
    p = of(rec, kind)
    if p is None:
        return []
    per, unit = (("asr.prep", "chunk") if kind == "offline"
                 else ("asr.train.step", "step"))
    n = max(count(p, per), 1)
    out = [f"program spans (host ms a {unit}): " + ", ".join(
        f"{k} {1e3 * v[1] / n:.3f} ({v[0]})" for k, v in sorted(
            p["spans"].items()))]
    if kind == "offline" and count(p, "asr.call"):
        out.append(f"spans under asr.call cover "
                   f"{100 * host_s(p, *CHUNK) / host_s(p, 'asr.call'):.2f} "
                   f"% of it")
    elif kind == "train":
        out.append(f"step spans cover "
                   f"{100 * host_s(p, *STEP) / rec['trace']['window_s']:.2f}"
                   f" % of the traced window")
    out.append("device idle by span (ms): " + ", ".join(
        f"{k} {1e3 * v:.3f}" for k, v in sorted(
            p["idle_by_span"].items(), key=lambda kv: -kv[1])))
    return out
