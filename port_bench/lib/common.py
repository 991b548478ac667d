"""What every run of the benchmark shares: its arguments, the files it
finds by name, the look for the card, the look for JAX in the process,
the metric readers, and the result line."""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "chinese_asr_tpu")


def process_start() -> float:
    """The wall time (``time.time``) at which this process started, from
    /proc; the time of the call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        ticks = os.sysconf(os.sysconf_names["SC_CLK_TCK"])
        return time.time() - (uptime - int(fields[19]) / ticks)
    except (OSError, ValueError, IndexError, KeyError):
        return time.time()


def keep_freed_memory() -> None:
    """Have glibc serve every host allocation from its heap and keep
    what is freed there.  The program allocates its host buffers anew
    for each chunk (tens of MB); glibc maps blocks that large fresh and
    unmaps them when freed, so each chunk faults in new pages, and on a
    virtual machine what a fresh page costs drifts over tens of seconds.
    Kept in the heap, the next chunk reuses pages already mapped: the
    same work, without the page faults' drift (PERF.md §2).  Stops the
    run where the C library refuses either setting."""
    import ctypes
    import ctypes.util
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    m_trim_threshold, m_mmap_threshold = -1, -3
    if not (libc.mallopt(m_mmap_threshold, 1 << 30)
            and libc.mallopt(m_trim_threshold, 1 << 31)):
        raise RuntimeError("mallopt refused to keep freed memory in the "
                           "heap")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load(kind: str, name: str) -> dict:
    """``port_bench/<kind>/<name>.json``."""
    with open(os.path.join(BENCH, kind, name + ".json")) as f:
        return json.load(f)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones, or with
    ``trace`` the per-layer ones, each listed for the cell (or for every
    cell, without a ``workloads`` key: then for each cell that reports
    the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """The ``read(rec)`` of ``port_bench/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_maps() -> Dict[str, dict]:
    """Every kernel the trace names, from ``port_bench/kernels/*.json``:
    {kernel: {"layer", "names", "counters"}}."""
    out = {}
    d = os.path.join(BENCH, "kernels")
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                m = json.load(f)
            for k, v in m["kernels"].items():
                out[k] = dict(v, layer=m["layer"])
    return out


def counters(maps: Dict[str, dict]) -> Dict[str, tuple]:
    """The program's launch counters the kernel maps name, {label:
    (module, attribute)}."""
    out = {}
    for v in maps.values():
        for mod, attr in v["counters"]:
            out[f"{mod.rsplit('.', 1)[1]}.{attr}"] = (
                importlib.import_module(mod), attr)
    return out


def require_cards(n: int) -> None:
    """Exit without a result where the card or the cards are missing."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"this cell needs {n} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(3)


def require_no_jax() -> None:
    """Exit without a result where the process holds JAX or the JAX
    package, by whole top-level module name."""
    found = sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        print(f"the process holds {', '.join(found)}: the benchmark runs "
              f"the PyTorch port alone", file=sys.stderr)
        sys.exit(4)


def device_info(torch) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result line, with those numbers last, as the
    last line on standard output."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    result = dict(result, checks=checks)
    print(json.dumps(result), flush=True)


def judge(values: Dict[str, float], limits: Dict[str, Optional[float]]):
    """(correct, checks): each number the cell gives a limit, at or under
    it; a number that is not finite, or missing, is shown as None and
    fails."""
    checks = {}
    for n, limit in limits.items():
        v = values.get(n)
        checks[n] = {"value": v if v is not None and math.isfinite(v)
                     else None, "limit": limit}
    ok = bool(checks) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
