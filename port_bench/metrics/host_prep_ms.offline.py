"""host_prep_ms.offline: host milliseconds a chunk in the program's
``_prep`` and ``_upload`` (the benchmark's spans around them), over the
traced call."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t or not t["spans"].get("bench.prep"):
        return None
    prep, up = t["spans"]["bench.prep"], t["spans"].get("bench.upload", [])
    return 1e3 * (sum(prep) + sum(up)) / len(prep)
