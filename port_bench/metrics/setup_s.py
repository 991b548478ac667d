"""setup_s: process start to the start of the window (host clock):
loading, building, the weights and inputs, and the warm-up that captures
every program the cell's traffic uses."""


def read(rec):
    return rec.get("setup_seconds")
