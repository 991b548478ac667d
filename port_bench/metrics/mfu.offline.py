"""mfu.offline: the model FLOPs of the traced call (``roofline/model.py``:
each utterance's encoder over its own frames, and beam width x steps
decoder steps, the steps counted by K3's launches), over the call's
wall time at the configuration's peak (``roofline/peaks.json``)."""

from port_bench.lib import trace
from port_bench.roofline import common, model, shapes


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t:
        return None
    cfg = rec["cfg"]
    chunks = t["work"]
    k3 = rec["kernels"].get("K3")
    _, launches = trace.kernel_seconds(t, k3["names"])
    steps = launches / len(chunks)
    flops = sum(model.decode_flops(cfg, shapes.encoder_frames(n, cfg["audio"]),
                                   cfg["beam_width"], steps)
                for c in chunks for n in c["lens"])
    peak = common.peaks()["flops_per_s"][cfg["precision"]]
    return 100.0 * flops / (t["window_s"] * peak)
