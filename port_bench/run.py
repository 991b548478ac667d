"""One run of one benchmark cell:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``port_bench/workloads/<cell>.json``)
names its configuration (``configs/``) and its traffic mix (``traffic/``),
whose ``kind`` picks the driver in ``port_bench/lib/``.  Set-up builds the
program and warms every shape the cell's traffic uses; the window then
runs for ``--seconds``; the plain reference judges what the window
produced once the program's memory is read and freed.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer ones
(``port_bench/metrics/<name>.py`` reads each).  The last line of standard
output is the result, as JSON.  The process keeps the host memory it
frees in glibc's heap (``common.keep_freed_memory``).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.lib import common  # noqa: E402

T_START = common.process_start()


def run_cell(args, device: str = "cuda"):
    """One run of the cell ``args.workload`` on ``device`` -> (result,
    checks).  The benchmark runs it on the card; the tests on the CPU."""
    import importlib
    import time

    import torch

    bench = common.manifest()
    cell = common.load("workloads", args.workload)
    cfg = common.load("configs", cell["config"])
    mix = common.load("traffic", cell["traffic"])
    driver = importlib.import_module(f"port_bench.lib.{mix['kind']}")
    run = driver.Driver(cell, cfg, mix, args.seed, device=device)
    run.setup()
    maps = common.kernel_maps()
    rec = {"kind": mix["kind"], "cfg": cfg, "mix": mix, "cell": cell,
           "kernels": maps}
    if args.trace:
        rec["trace"] = run.traced(common.counters(maps))
        window = rec["trace"]["window"]
    else:
        rec["setup_seconds"] = time.time() - T_START
        window = run.window(args.seconds)
    rec["window"] = window
    common.require_no_jax()
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    run.release()
    t = time.perf_counter()
    correct, checks = common.judge(run.check(), cell["check"]["limits"])
    for line in run.notes(rec) + [
            f"the reference's check took {time.perf_counter() - t:.1f} s"]:
        print(line, file=sys.stderr)
    metrics = {}
    for m in common.cell_metrics(bench, args.workload, bool(args.trace)):
        v = common.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_line = dict(common.device_info(torch) if cuda else
                       {"platform": "cpu", "kind": "cpu", "count": 1},
                       memory_peak_bytes=int(peak))
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": device_line}
    if args.trace:
        from port_bench.lib import trace
        device_line.update(busy_s=rec["trace"]["busy_s"],
                           window_s=rec["trace"]["window_s"])
        result["breakdown"] = trace.breakdown(rec["trace"])
    common.require_no_jax()
    return result, checks


def main(argv=None) -> int:
    args = common.parse_args(argv)
    common.keep_freed_memory()
    cell = common.load("workloads", args.workload)
    common.require_cards(cell["chips"])
    result, checks = run_cell(args)
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
