"""The roofline bound of a piece of work, and the peaks."""

from __future__ import annotations

import json
import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    at the precision's peak and the bytes at the HBM's bandwidth."""
    p = peaks()
    return max(ops / p["flops_per_s"][precision],
               nbytes / p["hbm_bytes_per_s"])
