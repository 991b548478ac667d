"""prep_idle_ms.offline: device-idle milliseconds a call while the
innermost program span open was ``asr.prep`` or ``asr.upload`` (the
host building and copying a chunk's wire), in the traced call."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "offline")
    if p is None or not program.count(p, "asr.call"):
        return None
    return 1e3 * program.idle_s(p, "asr.prep", "asr.upload") / program.count(
        p, "asr.call")
