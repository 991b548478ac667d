"""mfu.train: the model FLOPs of the traced pass over the batches
(``roofline/model.py``: each utterance's encoder over its own frames and
the decoder over its target tokens, forward times three), over the
pass's wall time at the configuration's peak (``roofline/peaks.json``)."""

from port_bench.roofline import common, model, shapes


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    cfg = rec["cfg"]
    flops = 0.0
    for b in t["work"]:
        per = b["tokens"] / len(b["lens"])
        flops += sum(model.train_flops(cfg,
                                       shapes.encoder_frames(n, cfg["audio"]),
                                       per) for n in b["lens"])
    peak = common.peaks()["flops_per_s"][cfg["train"]["compute_dtype"]]
    return 100.0 * flops / (t["window_s"] * peak)
