"""library_device_ms.offline: device milliseconds a chunk in kernels that
are not the program's own (cuBLAS products, PyTorch's elementwise and
reduction kernels), from the traced call's trace."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t:
        return None
    ours = [n for m in rec["kernels"].values() for n in m["names"]]
    secs = sum(s for k, (s, _) in t["kernels"].items()
               if not any(n in k for n in ours))
    return 1e3 * secs / len(t["work"])
