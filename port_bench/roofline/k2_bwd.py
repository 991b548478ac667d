"""K2-bwd, the backward of K2's recurrence (``ops/cuda/lstm.py``
``bidir_lstm_time_loop_bwd``, float32).

Inputs: xg_f, xg_b [T, B, 4H], m_f, m_b [T, B], W_hh [2, H, 4H], ys_f,
ys_b, gy_f, gy_b [T, B, H], ghT, gcT [2, B, H]; outputs: dxg [2, T, B,
4H], hs and cs [2, T, B, H].  Operations, for every step inside a row's
length in each direction: the forward's recurrent product again (2 H 4H;
the inputs hold no gates, so the activations must be rebuilt), the
backward's product of the gate cotangents with W_hh^T (2 4H H) and the
elementwise work of both (20 H).  dW_hh is a separate cuBLAS product."""

from __future__ import annotations


def work(T: int, B: int, H: int, valid_steps: int, elem_bytes: int = 4):
    """(operations, bytes) of one launch; ``valid_steps`` as for K2."""
    ops = 2 * valid_steps * (2 * 2 * H * 4 * H + 20 * H)
    nbytes = elem_bytes * (2 * T * B * 4 * H + 2 * T * B + 2 * H * 4 * H
                           + 4 * T * B * H + 2 * 2 * B * H
                           + 2 * T * B * 4 * H + 2 * 2 * T * B * H)
    return ops, nbytes
