"""k3_roofline: K3's roofline bound over its device time in the traced
call: each launch reads the [B x beam, V] scores of one step of a chunk
(``roofline/k3.py``); the steps a chunk are K3's launches over the
chunks."""

from port_bench.lib import trace
from port_bench.roofline import common, k3


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t:
        return None
    secs, n = trace.kernel_seconds(t, rec["kernels"]["K3"]["names"])
    if not n:
        return None
    cfg = rec["cfg"]
    k, V = cfg["beam_width"], cfg["vocab"]["max_num_words"] + 4
    steps = n / len(t["work"])
    bound = sum(steps * common.bound_s(*k3.work(len(c["lens"]) * k, V, k + 1),
                                       "float32")
                for c in t["work"])
    return 100.0 * bound / secs
