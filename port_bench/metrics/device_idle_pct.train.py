"""device_idle_pct.train: the share of the traced pass over the batches
with no kernel, copy or memset on the card (torch.profiler)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
