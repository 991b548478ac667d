"""host_busy_ms.train: the host's milliseconds a step outside the wait in
the traced pass: the program's ``asr.train.load``, ``asr.train.step``
and ``asr.train.log`` spans, over its steps (``asr.train.step`` spans)."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "train")
    if p is None or not program.count(p, "asr.train.step"):
        return None
    return 1e3 * program.host_s(p, "asr.train.load", "asr.train.step",
                                "asr.train.log") / program.count(
        p, "asr.train.step")
