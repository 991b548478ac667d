"""k2_roofline: K2's (float32) roofline bound over its device time in the
traced call: one launch a layer a chunk, over the chunk's padded encoder
frames, its operations over each row's own frames (``roofline/k2.py``),
priced at the float32 peak."""

from port_bench.lib.shares import encoder_share


def read(rec):
    return encoder_share(rec, "K2", 4, "float32")
