"""Device timing of short kernels on the card, shared by ``chip_smoke.py``
and ``topk_ab.py``.

A top-k launch takes less device time than its wrapper's Python takes to
issue it, so an eager loop times the host: ``graph_ms`` captures the calls
in one CUDA graph and times its replay.  ``cold_cycle`` feeds each call a
fresh input from a set that overflows the H100's 50 MB L2, so that a timed
call reads its rows from HBM, as the beam's read of a freshly computed
logp mostly does.
"""

from __future__ import annotations

import itertools

import torch


def graph_ms(fn, iters: int = 50) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph (after a warm-up call on a side stream), one replay timed with
    CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_cycle(make, nbytes: int):
    """A function that returns, call by call and in turn, one of the
    inputs from ``make()`` (``nbytes`` each), enough of them to fill 150
    MB, three times the L2."""
    items = [make() for _ in range(max(2, -(-150 * 2 ** 20 // nbytes)))]
    it = itertools.cycle(items)
    return lambda: next(it)
