"""One run of one benchmark cell with the program's own spans read too:

    python3 port_bench/spans.py --workload <cell> --seed <n> --seconds <s> --trace 1

from the root of a checkout.  It is ``run.py`` with what the harness's
trace does not do yet: each traced window's summary also holds
``lib/program.py``'s summary of the program's ``asr.`` spans (under
``"program"``), the run reports the per-layer metrics of ``spans.json``
(in BENCHMARK.json's form, each in the cells it lists) that read it, and
standard error gets ``program.notes``.  On a program without the spans
those metrics read nothing and the result line leaves them out.  With
``--trace 0`` it is ``run.py``.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import run  # noqa: E402
from port_bench.lib import common, program, trace  # noqa: E402


def main(argv=None) -> int:
    args = common.parse_args(argv)
    common.keep_freed_memory()
    cell = common.load("workloads", args.workload)
    common.require_cards(cell["chips"])
    with open(os.path.join(common.BENCH, "spans.json")) as f:
        extra = json.load(f)
    manifest, summarize = common.manifest, trace.summarize
    traced = []

    def with_extra():
        m = manifest()
        m["per_layer"] += extra
        return m

    def with_program(prof, counted):
        s = summarize(prof, counted)
        s["program"] = program.summarize(prof)
        traced.append(s)
        return s

    common.manifest, trace.summarize = with_extra, with_program
    result, checks = run.run_cell(args)
    if traced:
        # the trace ``trace.fullest`` kept: the first with the most records
        kept = max(traced, key=lambda s: s["records"])
        kind = common.load("traffic", cell["traffic"])["kind"]
        for line in program.notes({"kind": kind, "trace": kept}):
            print(line, file=sys.stderr)
    common.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
