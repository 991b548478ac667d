"""The reading of the program's own spans (``lib/program.py``) on fake
profiles, the readers of ``spans.json`` on hand-made summaries, and on
the card that a program span leaves the device's records as they were."""

import json
import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench.lib import common, program, trace

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, dev, start, end):
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


class _Prof:
    def __init__(self, rows):
        self.rows = rows

    def events(self):
        return self.rows


# a window of 100 us: kernels at 10-30 and 60-90; the call's spans on
# the host, prep 0-20 and finalize 40-70 holding its wait 45-65
BASE = [_ev(trace.WINDOW, CPU, 0.0, 100.0),
        _ev("k_a", CUDA, 10.0, 30.0), _ev("memcpy HtoD", CUDA, 60.0, 90.0)]
SPANS = [_ev("asr.call", CPU, 0.0, 100.0), _ev("asr.prep", CPU, 0.0, 20.0),
         _ev("asr.finalize", CPU, 40.0, 70.0),
         _ev("asr.finalize.wait", CPU, 45.0, 65.0)]


def test_program_spans_are_no_device_rows():
    """The spans leave the harness's device summary as it was, and an
    ``asr.`` range on the device's timeline is no device row here."""
    plain = trace.summarize(_Prof(BASE), {})
    spanned = trace.summarize(_Prof(BASE + SPANS), {})
    assert spanned == plain and plain["busy_s"] == pytest.approx(50e-6)
    on_card = _ev("asr.call", CUDA, 0.0, 100.0)
    assert program.summarize(_Prof(BASE + SPANS + [on_card])) \
        == program.summarize(_Prof(BASE + SPANS))


def test_summarize_counts_spans_and_puts_idle_down_to_the_innermost():
    p = program.summarize(_Prof(BASE + SPANS))
    assert p["spans"]["asr.prep"] == [1, pytest.approx(20e-6)]
    assert p["spans"]["asr.finalize.wait"] == [1, pytest.approx(20e-6)]
    idle = {k: v * 1e6 for k, v in p["idle_by_span"].items()}
    # idle 0-10: prep; 30-60: call 30-40, finalize 40-45, wait 45-60;
    # 90-100: call
    assert idle == pytest.approx({"asr.prep": 10.0, "asr.call": 20.0,
                                  "asr.finalize": 5.0,
                                  "asr.finalize.wait": 15.0})
    assert sum(idle.values()) == pytest.approx(50.0)


def test_idle_by_span_splits_at_span_edges():
    spans = [("asr.a", 0.0, 10.0), ("asr.b", 2.0, 4.0), ("asr.c", 6.0, 7.0)]
    # a: 1-2, 4-6, 7-8, 9-10; b: 2-4; c: 6-7; none: 10-12
    assert program.idle_by_span(spans, [(1.0, 8.0), (9.0, 12.0)]) \
        == pytest.approx({"asr.a": 5.0,
                          "asr.b": 2.0, "asr.c": 1.0, program.NONE: 2.0})
    # two spans that start together: the shorter is the inner one
    assert program.idle_by_span([("asr.x", 0.0, 5.0), ("asr.y", 0.0, 3.0)],
                                [(0.0, 5.0)]) == {"asr.y": 3.0, "asr.x": 2.0}
    assert program.gaps([[1.0, 2.0], [3.0, 4.0]], 0.0, 5.0) \
        == [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]


OFFLINE = {"spans": {"asr.call": [1, 0.40], "asr.prep": [8, 0.16],
                     "asr.upload": [8, 0.02],
                     "asr.finalize.wait": [8, 0.08],
                     "asr.finalize.detok": [8, 0.024]},
           "idle_by_span": {"asr.prep": 0.02, "asr.upload": 0.004,
                            "asr.call": 0.01}}
TRAIN = {"spans": {"asr.train.load": [9, 0.045], "asr.train.step": [8, 0.02],
                   "asr.train.read": [8, 0.8], "asr.train.log": [8, 0.001]},
         "idle_by_span": {"asr.train.load": 0.016, "none": 0.001}}
WANT = {"host_busy_ms.offline": ("offline", 1e3 * 0.32 / 8),
        "detok_ms.offline": ("offline", 3.0),
        "prep_idle_ms.offline": ("offline", 24.0),
        "host_busy_ms.train": ("train", 1e3 * 0.066 / 8),
        "load_ms.train": ("train", 1e3 * 0.045 / 8),
        "load_idle_ms.train": ("train", 2.0)}


def _spans_json():
    with open(os.path.join(common.BENCH, "spans.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(WANT))
def test_readers(name):
    kind, want = WANT[name]
    read = common.reader(name)
    other = "train" if kind == "offline" else "offline"
    summary = {"offline": OFFLINE, "train": TRAIN}
    assert read({"kind": kind, "trace": {"program": summary[kind]}}) \
        == pytest.approx(want)
    assert read({"kind": other, "trace": {"program": summary[other]}}) \
        is None
    # no trace, or a trace of a program without the spans
    assert read({"kind": kind}) is None
    assert read({"kind": kind, "trace": {"busy_s": 1.0}}) is None
    assert read({"kind": kind, "trace": {"program": {
        "spans": {}, "idle_by_span": {}}}}) is None
    entry = [m for m in _spans_json() if m["name"] == name][0]
    assert entry["source"] == "program_span" and entry["better"] == "lower"


def test_spans_json_is_per_layer_entries_of_the_manifest():
    """``spans.json``'s entries in BENCHMARK.json's form, each name new,
    each layer one the manifest names, each cell one that reports the
    end-to-end metric the entry moves."""
    b = common.manifest()
    names = {m["name"] for m in b["per_layer"] + b["end_to_end"]}
    layers = {m["layer"] for m in b["per_layer"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    extra = _spans_json()
    assert sorted(m["name"] for m in extra) == sorted(WANT)
    for m in extra:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["name"] not in names and m["layer"] in layers
        assert all(c in e2e[m["moves"]]["workloads"] for c in m["workloads"])


def test_a_span_on_the_card_adds_no_device_row(card):
    """On the card, a program span around a kernel adds no ``asr.`` row to
    the device's timeline, and the harness's summary of the window reads
    the same busy time as ``program.summarize``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from chinese_asr_tpu_torch.utils.observe import span
    x = torch.randn(1024, 1024, device=card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            with span("asr.call", "call 1"):
                for _ in range(4):
                    x = x @ x / 1024.0
            torch.cuda.synchronize()
    assert not [e.name for e in prof.events()
                if e.device_type == CUDA and e.name.startswith("asr.")]
    p = program.summarize(prof)
    assert p["spans"]["asr.call"][0] == 1
    s = trace.summarize(prof, {})
    assert not [k for k in s["kernels"] if k.startswith("asr.")]
    assert sum(p["idle_by_span"].values()) == pytest.approx(
        s["window_s"] - s["busy_s"], rel=1e-6, abs=1e-9)


_RSS_AFTER_FREE = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from port_bench.lib import common
def rss():
    with open("/proc/self/status") as f:
        return [int(l.split()[1]) * 1024 for l in f if l.startswith("VmRSS")][0]
if {keep}:
    common.keep_freed_memory()
base = rss()
a = np.ones(64 << 20, np.uint8)
del a
print(rss() - base)
"""


@pytest.mark.parametrize("keep", [False, True])
def test_keep_freed_memory_keeps_a_freed_block_mapped(keep):
    """With the policy a freed 64 MB block stays mapped in the heap, for
    the next allocation to reuse; without it glibc unmaps it at once."""
    import subprocess
    import sys
    root = os.path.dirname(common.BENCH)
    out = subprocess.run(
        [sys.executable, "-c", _RSS_AFTER_FREE.format(root=root, keep=keep)],
        capture_output=True, text=True, check=True)
    kept = int(out.stdout.split()[-1])
    assert (kept > 48 << 20) == keep
