"""K1, the log-mel core (``ops/cuda/logmel.py``): framing, window and DFT,
power, mel product, eps floor and log, over a batch of padded rows.

Input: the pre-emphasised wav [B, N - 1] float32.  Output: [B, T, n_mels]
float32.  Operations a frame: a real FFT of ``n_fft`` points (2.5 n log2
n), the power of the ``n_fft / 2 + 1`` bins (3 each), the mel product (2
bins x n_mels) and the log (one a mel).  Every frame of the padded rows
is work the kernel is handed."""

from __future__ import annotations

import math


def work(B: int, N: int, T: int, n_fft: int = 512, n_mels: int = 80):
    """(operations, bytes) of one launch."""
    bins = n_fft // 2 + 1
    per_frame = (2.5 * n_fft * math.log2(n_fft) + 3 * bins
                 + 2 * bins * n_mels + n_mels)
    ops = B * T * per_frame
    nbytes = 4 * B * (N - 1) + 4 * B * T * n_mels
    return ops, nbytes
