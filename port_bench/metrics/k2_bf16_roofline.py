"""k2_bf16_roofline: K2-bf16's roofline bound over its device time in the
traced call, as ``k2_roofline`` with bf16 operands (2 bytes) priced at
the bf16 peak."""

from port_bench.lib.shares import encoder_share


def read(rec):
    return encoder_share(rec, "K2-bf16", 2, "bfloat16")
