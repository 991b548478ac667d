"""load_ms.train: host milliseconds a step in the program's
``asr.train.load`` span (the next batch from the loader: its upload and
featurize), over the traced pass's steps (``asr.train.step`` spans)."""

from port_bench.lib import program


def read(rec):
    p = program.of(rec, "train")
    if p is None or not program.count(p, "asr.train.step"):
        return None
    return 1e3 * program.host_s(p, "asr.train.load") / program.count(
        p, "asr.train.step")
