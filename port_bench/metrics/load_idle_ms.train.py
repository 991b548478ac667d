"""load_idle_ms.train: device-idle milliseconds a step while the
innermost program span open was ``asr.train.load``, over the traced
pass's steps (``asr.train.step`` spans)."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "train")
    if p is None or not program.count(p, "asr.train.step"):
        return None
    return 1e3 * program.idle_s(p, "asr.train.load") / program.count(
        p, "asr.train.step")
