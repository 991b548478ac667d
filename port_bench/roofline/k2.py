"""K2 and K2-bf16, the bidirectional LSTM recurrence of one encoder layer
(``ops/cuda/lstm.py`` ``bidir_lstm_time_loop``).

Inputs: the hoisted gates xg_f, xg_b [T, B, 4H], the masks m_f, m_b
[T, B], W_hh [2, H, 4H]; outputs: ys_f, ys_b [T, B, H] and the final
h, c [2, B, H], all of the operands' type (4 bytes float32, 2 bfloat16).
Operations: the recurrent product h @ W_hh (2 H 4H) and the cell's
elementwise update (10 H) for every step inside a row's length, in each
direction; steps past it are masked, not needed."""

from __future__ import annotations


def work(T: int, B: int, H: int, valid_steps: int, elem_bytes: int):
    """(operations, bytes) of one launch; ``valid_steps``: the sum over
    rows of their lengths in encoder frames."""
    ops = 2 * valid_steps * (2 * H * 4 * H + 10 * H)
    nbytes = elem_bytes * (2 * T * B * 4 * H + 2 * T * B + 2 * H * 4 * H
                           + 2 * T * B * H + 2 * 2 * B * H)
    return ops, nbytes
