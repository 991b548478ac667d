"""finalize_ms.offline: host milliseconds a chunk in the program's
``_decode_finalize``: the wait for the chunk's result copy and the
detokenize (the benchmark's span around it), over the traced call."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "offline" or not t \
            or not t["spans"].get("bench.finalize"):
        return None
    fin = t["spans"]["bench.finalize"]
    return 1e3 * sum(fin) / len(fin)
