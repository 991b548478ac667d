"""host_busy_ms.offline: the host's own milliseconds a chunk in the traced
call: the program's ``asr.call`` span less its ``asr.finalize.wait``
spans (the host blocked on each chunk's result), over the call's chunks
(its ``asr.prep`` spans); the host's pace, to set beside the device's
busy milliseconds a chunk."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "offline")
    if p is None or not program.count(p, "asr.prep"):
        return None
    own = program.host_s(p, "asr.call") - program.host_s(p,
                                                         "asr.finalize.wait")
    return 1e3 * own / program.count(p, "asr.prep")
