"""k2_bwd_roofline: K2-bwd's (float32) roofline bound over its device
time in the traced pass: one launch a layer a step, over the batch's
padded encoder frames, its operations over each row's own frames
(``roofline/k2_bwd.py``), priced at the float32 peak."""

from port_bench.lib import trace
from port_bench.roofline import common, k2_bwd, shapes


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    secs, n = trace.kernel_seconds(t, rec["kernels"]["K2-bwd"]["names"])
    if not n:
        return None
    cfg = rec["cfg"]
    a, H = cfg["audio"], cfg["encoder"]["hidden_size"]
    wb = rec["mix"]["wav_bucket"]
    bound = 0.0
    for b in t["work"]:
        N = -(-max(b["lens"]) // wb) * wb
        T = shapes.frames(N, a) // 3
        valid = sum(shapes.encoder_frames(m, a) for m in b["lens"])
        bound += cfg["encoder"]["num_layers"] * common.bound_s(
            *k2_bwd.work(T, len(b["lens"]), H, valid, 4), "float32")
    return 100.0 * bound / secs
