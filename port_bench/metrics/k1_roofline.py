"""k1_roofline: K1's roofline bound over its device time, summed over the
traced call's launches (one a chunk, on the chunk's padded [B, N] wav;
``roofline/k1.py``), priced at the configuration's float32 peak: K1 runs
in float32 in every configuration."""

from port_bench.lib import trace
from port_bench.roofline import common, k1, shapes


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t:
        return None
    secs, n = trace.kernel_seconds(t, rec["kernels"]["K1"]["names"])
    if not n:
        return None
    a = rec["cfg"]["audio"]
    bound = 0.0
    for c in t["work"]:
        T = shapes.frames(c["N"], a)
        bound += common.bound_s(*k1.work(len(c["lens"]), c["N"], T,
                                         a["n_fft"], a["n_mels"]), "float32")
    return 100.0 * bound / secs
