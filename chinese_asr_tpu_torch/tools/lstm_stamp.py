"""Where a step of K2-bf16 and K2-bwd-bf16 goes: the phase split of their
cluster kernels, read from a stamped build, on one card.

    python3 chinese_asr_tpu_torch/tools/lstm_stamp.py [--batches 32,128]

Builds ``csrc/runtime.cu``, ``lstm.cu`` and ``lstm_bwd.cu`` with
``-DASR_STAMP`` into a library of its own under ``_build/`` (the product
build never sets that define; ``csrc/stamp.cuh`` says what a stamp
records), puts it in place of the product library for the wrappers' calls
(``build.use``), and runs the bf16 forward and backward at the flagship
encoder layer's shape (xg 2 x [332, B, 1024], W_hh [2, 256, 1024],
random non-prefix masks) for each B.  One thread of one CTA (cluster 0,
rank 0, the forward direction) sums the clock64 cycles of each phase; a
phase's microseconds a step are its cycles over T, at the ns per cycle of
that thread's whole run (%globaltimer over clock64).  It also times the
product library's call by CUDA events on the same inputs, and for the
backward each stage of the wrapper (``lstm.bwd_bf16_stages``).

Prints the card's name and power limit, then one line a kernel and B,
then one JSON object; ``--json PATH`` also writes the object there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
T, H = 332, 256
N_STAMP = 24                   # csrc/stamp.cuh ASR_STAMP_N
SOURCES = ("runtime.cu", "lstm.cu", "lstm_bwd.cu")

# stamp index -> phase, as the kernels number them (csrc/lstm.cu,
# csrc/lstm_bwd.cu); a phase's time runs from the stamp before it
FWD_PHASES = {
    7: "prologue", 0: "products", 1: "partial sums, block barrier",
    2: "gates' arrival", 3: "cell update", 4: "h stores",
    5: "barrier and copies or arrive, y stores, next fetch",
    6: "exchange wait", 8: "epilogue"}
BWD_PHASES = {
    9: "prologue", 0: "pass 1 products", 1: "pass 1 partials, barrier",
    2: "pass 1 cell, scratch stores", 3: "pass 1 rebuild",
    4: "pass 1 next fetch, barrier", 10: "between the passes",
    5: "pass 2 exchange wait, sum", 11: "pass 2 operands' arrival",
    6: "pass 2 cell", 7: "pass 2 block barrier", 8: "pass 2 product",
    12: "pass 2 partial sends", 13: "pass 2 arrive, next fetch",
    14: "epilogue"}
PASS1 = (0, 1, 2, 3, 4)
PASS2 = (5, 11, 6, 7, 8, 12, 13)


def stamped_library():
    """Build (or find cached) and load the stamped library."""
    sys.path.insert(0, ROOT)
    from chinese_asr_tpu_torch.ops.cuda import build
    return build.load(build.build(sources=SOURCES, defines=("ASR_STAMP",),
                                  stem="libasr_stamp"))


def case(torch, B: int, seed: int = 3):
    """bf16 operands of the backward at [T, B, H] (the forward takes the
    first five): random gates and W_hh, random non-prefix masks (a
    quarter of the steps masked), ys from K2-bf16, random cotangents."""
    from chinese_asr_tpu_torch.ops.cuda import lstm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16

    def f(*s):
        return torch.randn(*s, device=dev, generator=g).to(bf)

    xg_f, xg_b = f(T, B, 4 * H), f(T, B, 4 * H)
    w = (torch.randn(2, H, 4 * H, device=dev, generator=g) / H ** 0.5).to(bf)
    m_f, m_b = ((torch.rand(T, B, device=dev, generator=g) > 0.25).to(bf)
                for _ in range(2))
    ys_f, ys_b, _, _ = lstm.bidir_lstm_time_loop(xg_f, xg_b, m_f, m_b, w)
    return (xg_f, xg_b, m_f, m_b, w, ys_f, ys_b, f(T, B, H), f(T, B, H),
            f(2, B, H), f(2, B, H))


def _events_ms(torch, fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _read(torch, lib, reader: str, phases: dict) -> dict:
    buf = (ctypes.c_ulonglong * N_STAMP)()
    fn = getattr(lib, reader)
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    torch.cuda.synchronize()
    rc = fn(ctypes.addressof(buf))
    if rc:
        raise RuntimeError(f"{reader}: CUDA error {rc}")
    cycles, ns = buf[N_STAMP - 2], buf[N_STAMP - 1]
    if not cycles:
        raise RuntimeError(f"{reader}: no stamps (no cluster kernel ran)")
    ns_per_cycle = ns / cycles
    us = {name: buf[i] * ns_per_cycle / T / 1e3 for i, name in phases.items()}
    return dict(us_a_step=us, stamped_ms=ns / 1e6,
                ns_per_cycle=ns_per_cycle,
                idx_us={i: buf[i] * ns_per_cycle / T / 1e3 for i in phases})


def _ctas(lib, ctas: int) -> None:
    """The bf16 kernels' CTAs a cluster for the next launches (0: the
    plan's rule)."""
    for name in ("asr_stamp_ctas_lstm", "asr_stamp_ctas_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int]
        fn.restype = None
        fn(ctas)


def _diff(got, ref) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, ref))


def split(torch, lib, B: int, variants=(0,)) -> dict:
    """The stamped split of K2-bf16 and K2-bwd-bf16 at [T, B, H], and the
    product library's times of the same calls.  Each of ``variants``
    (CTAs a cluster of the bf16 kernels; 0 is the plan's rule) is stamped
    and, where it is not the rule's, timed by CUDA events in the stamped
    build; each reports how far its outputs are from the product
    library's."""
    from chinese_asr_tpu_torch.ops.cuda import build, lstm
    args = case(torch, B)
    fwd_args = args[:5]
    out = dict(B=B, plan=lstm.plan(B, H, torch.bfloat16),
               bwd_plan=lstm.bwd_plan(B, H, torch.bfloat16))
    out["fwd_ms"] = _events_ms(
        torch, lambda: lstm.bidir_lstm_time_loop(*fwd_args))
    out["bwd_ms"] = _events_ms(
        torch, lambda: lstm.bidir_lstm_time_loop_bwd(*args))
    stages = getattr(lstm, "bwd_bf16_stages", None)
    if stages is not None:
        out["bwd_stage_ms"] = stages(*args, timer=lambda fn: _events_ms(
            torch, fn))
    ref = (lstm.bidir_lstm_time_loop(*fwd_args),
           lstm.bidir_lstm_time_loop_bwd(*args))
    prev = build.use(lib)
    try:
        for ctas in variants:
            _ctas(lib, ctas)
            got = lstm.bidir_lstm_time_loop(*fwd_args)
            fwd = _read(torch, lib, "asr_stamp_read_lstm", FWD_PHASES)
            gotb = lstm.bidir_lstm_time_loop_bwd(*args)
            bwd = _read(torch, lib, "asr_stamp_read_bwd", BWD_PHASES)
            fwd["max_abs_diff"] = _diff(got, ref[0])
            bwd["max_abs_diff"] = _diff(gotb, ref[1])
            if ctas:
                fwd["variant_ms"] = _events_ms(
                    torch, lambda: lstm.bidir_lstm_time_loop(*fwd_args))
                bwd["variant_ms"] = _events_ms(
                    torch, lambda: lstm.bidir_lstm_time_loop_bwd(*args))
            idx = bwd.pop("idx_us")
            bwd["pass1_us_a_step"] = sum(idx[i] for i in PASS1)
            bwd["pass2_us_a_step"] = sum(idx[i] for i in PASS2)
            fwd.pop("idx_us")
            key = f" ctas={ctas}" if ctas else ""
            out["fwd" + key], out["bwd" + key] = fwd, bwd
    finally:
        _ctas(lib, 0)
        build.use(prev)
    return out


def lines(r: dict) -> dict:
    """Human lines of one ``split`` result: {"fwd": [...], "bwd": [...]}."""
    def fmt(us):
        return "; ".join(f"{k} {v:.3f}" for k, v in us.items() if v > 0)

    B = r["B"]
    out = dict(fwd=[f"K2-bf16 B={B}: {r['fwd_ms']:.4f} ms "
                    f"({r['fwd_ms'] * 1e3 / T:.2f} us a step); plan "
                    f"{r['plan']}"],
               bwd=[f"K2-bwd-bf16 B={B}: {r['bwd_ms']:.4f} ms; pass 2's "
                    f"plan {r['bwd_plan']}"])
    for key in sorted(k for k in r if k.startswith("fwd") and k != "fwd_ms"):
        f, b = r[key], r["bwd" + key[3:]]
        tag = key[3:] or " product plan"
        out["fwd"].append(
            f"  stamped{tag}"
            + (f" ({f['variant_ms']:.4f} ms by events)"
               if "variant_ms" in f else "")
            + f": {f['stamped_ms']:.4f} ms, off the product by "
              f"{f['max_abs_diff']:.3g}; us a step: {fmt(f['us_a_step'])}")
        out["bwd"].append(
            f"  stamped{tag}"
            + (f" ({b['variant_ms']:.4f} ms by events)"
               if "variant_ms" in b else "")
            + f": cluster kernel {b['stamped_ms']:.4f} ms, off the product "
              f"by {b['max_abs_diff']:.3g}; pass 1 "
              f"{b['pass1_us_a_step']:.3f} us a step, pass 2 "
              f"{b['pass2_us_a_step']:.3f}; us a step: "
              f"{fmt(b['us_a_step'])}")
    if "bwd_stage_ms" in r:
        st = r["bwd_stage_ms"]
        p1 = st["rebuild"] + st["pre_bmm"] + st["activate"]
        out["bwd"].append(
            f"  stages, ms: " + "; ".join(f"{k} {v:.4f}"
                                          for k, v in st.items())
            + f"; pass 1 (stages a-c) {p1:.4f}, pass 2 {st['pass2']:.4f}")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="32,128")
    ap.add_argument("--json", default=None)
    ap.add_argument("--ctas", default="0",
                    help="CTAs a cluster of the bf16 kernels to stamp, "
                         "comma-separated (0: the plan's rule; 8 or 4)")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("lstm_stamp: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, text=True,
                         stdout=subprocess.PIPE).stdout.strip(), flush=True)
    lib = stamped_library()
    variants = [int(v) for v in a.ctas.split(",")]
    res = [split(torch, lib, int(b), variants)
           for b in a.batches.split(",")]
    for r in res:
        for part in lines(r).values():
            for line in part:
                print(line, flush=True)
    obj = dict(device=torch.cuda.get_device_name(0), splits=res)
    print(json.dumps(obj), flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(obj, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
