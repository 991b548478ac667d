"""detok_ms.offline: host milliseconds a chunk in the program's
``asr.finalize.detok`` span (the winner's detokenize after the result
copy was waited for), over the traced call's chunks (its ``asr.prep``
spans): ``finalize_ms.offline`` with the wait taken out."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "offline")
    if p is None or not program.count(p, "asr.prep"):
        return None
    return 1e3 * program.host_s(p, "asr.finalize.detok") / program.count(
        p, "asr.prep")
