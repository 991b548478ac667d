"""The control of a cell: the plain reference put in the program's place
in the precision below the configuration's (TF32 for float32, fp8 for
bfloat16), judged as a run judges the program, against the cell's
limits: it must come out not correct, and the numbers it reads set the
upper end of each limit.  With ``--fault`` it reads instead the
program's set-up, one call or pass and the check with that fault planted
under the timed path (``lib/faults.py``), at the cell's own size; that
too must come out not correct.  With ``--program`` it reads the program
as it stands in the same way: the sound readings that set the lower end
of each limit, which must come out correct.  One JSON line a seed; the
exit code is 1 where any seed comes out otherwise than it must;
``check_s`` is the seconds the reference took (with the control's own
computation, for a control).

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--precision tf32]
    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --fault half_batch
    python3 port_bench/control.py --workload <cell> --seeds 1,2,...,12 --program
"""

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench.lib import common  # noqa: E402

BELOW = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    import importlib
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    common.keep_freed_memory()
    cell = common.load("workloads", args.workload)
    cfg = common.load("configs", cell["config"])
    mix = common.load("traffic", cell["traffic"])
    if args.device == "cuda":
        common.require_cards(cell["chips"])
    driver = importlib.import_module(f"port_bench.lib.{mix['kind']}")
    prec = args.precision or BELOW[cfg["precision"]]
    wrong = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.fault or args.program:
            from port_bench.lib import faults
            planted = (faults.FAULTS[args.fault]() if args.fault
                       else contextlib.nullcontext())
            with planted:
                run = driver.Driver(cell, cfg, mix, seed, device=args.device)
                run.setup()
                if hasattr(run, "calls") and not run.calls:
                    run.window(0.0)
                run.release()
                t = time.perf_counter()
                vals = run.check()
            what = {"fault": args.fault} if args.fault else {"program": True}
        else:
            vals = driver.control(cell, cfg, mix, seed, prec, args.device)
            what = {"precision": prec}
        correct, checks = common.judge(vals, cell["check"]["limits"])
        wrong += correct != bool(args.program)
        print(json.dumps({"workload": args.workload, "seed": seed, **what,
                          "correct": correct, "checks": checks,
                          "check_s": time.perf_counter() - t}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
