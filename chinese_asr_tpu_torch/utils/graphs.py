"""The compiled decode entry points' runner (the ``*_jit`` forms of
``decode/``): a device-resident decode loop, eager on the CPU and replayed
as CUDA graphs on the card.  This is the port's counterpart of the JAX
package's ``jax.jit`` over a ``lax.while_loop``: "jit" in a ``*_jit``
name means a graph replay here.

A decode is a loop object with ``max_len``, ``init(*inputs)`` (encode the
batch; returns the loop state, a tree of tensors holding a 0-d bool
``done``), ``step(state, l, guard)`` (one step; with ``guard`` it is an
identity once ``done`` holds, as JAX's ``keep`` makes its stopping step)
and ``result(state)``.

``run_loop`` runs it eagerly in chunks of ``unroll`` steps and reads
``done`` on the host once per chunk (JAX's ``unroll``, ``beam.py``
``body_unrolled``).  Only a step after the first of its chunk can follow
the stop, so only those are guarded: the first found the loop running
(the host read before it), and at ``unroll=1`` no step is guarded, which
saves the guards' kernels where the flag is read every step.  ``run`` is
what the ``*_jit`` forms call: on a CPU tensor ``run_loop``; on a CUDA
tensor a cached ``Graphed`` program.

``Graphed`` captures, after one eager warm-up on a side stream (it builds
the kernels and initialises cuBLAS), one graph for the encode and the
loop's initial state, one graph per chunk of ``unroll`` steps with ``l``
fixed, and one for the result, all in one private memory pool.  Each
chunk copies its new state into the state tensors the first graph made,
so every chunk reads and writes the same tensors and a chunk that is not
replayed leaves them as the identity steps would.  A call copies the
inputs into the graph's own, replays the encode, then the chunks, reading
``done`` between two chunks so that an early stop skips the rest, then
the result, and returns a copy of the result made before any other call
may replay the program: the outputs are the caller's, as ``jax.jit``'s
are.  A failed capture or replay raises; nothing falls back to the eager
loop.

Programs are cached by the caller's key (everything a replay silently
depends on: configuration, widths, the ``fused_logp`` choice, and the
address, shape and type of every caller-owned tensor the graph reads:
each parameter leaf, the LM tables, ``tok2lm``), the backend's matmul
precision switches, ``unroll`` and the inputs' shapes and types.  JAX's
``lru_cache(maxsize=32)`` bounds its jitted functions (one a
configuration, width and LM), and each of those caches a program for
every input shape it meets.  Here a program is one input shape, and
serving makes many: a batch on the ladder times the wav's length in
1-s buckets.  So the cache is bounded by the device memory the
programs' pools hold (``BUDGET_FRACTION`` of the card), and by
``MAX_PROGRAMS`` programs, each of which holds its parameters; the
least recently used are evicted and their memory freed.

The kernel wrappers count a launch when they are called, which under
capture is not a launch.  ``Graphed`` takes each counter's change during
a capture back out, and adds it again at every replay of that graph, so
the counters keep meaning launches on the card.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from ..ops.cuda import adpcm as adpcm_k
from ..ops.cuda import logmel as logmel_k
from ..ops.cuda import lstm as lstm_k
from ..ops.cuda import topk as topk_k

# the share of the card's memory that every cached program's private
# pool may hold together: a program holds ~82 MB a million batch samples
# (f32, bw 16; 834 MB at B=32 of 20 s), and the ~80 keys that a server
# on the 1-32 ladder meets on 1-20 s requests hold ~9.5 GB (H100)
BUDGET_FRACTION = 0.25
# and the most programs cached: each holds its parameters by reference
MAX_PROGRAMS = 256
# the ``*_jit`` forms' steps between two host reads of ``done``: at most
# max_len / UNROLL syncs a batch, at most UNROLL - 1 identity steps after
# an early stop
UNROLL = 4

# every kernel launch counter, (module, attribute)
COUNTERS = ((logmel_k, "launches"), (lstm_k, "launches"),
            (lstm_k, "bf16_launches"), (topk_k, "launches"),
            (topk_k, "fused_launches"), (adpcm_k, "launches"),
            (lstm_k, "bwd_launches"), (lstm_k, "bwd_bf16_launches"))

_cache: "OrderedDict[tuple, Graphed]" = OrderedDict()
_lock = threading.RLock()
_streams: dict = {}     # device -> the side stream of every warm-up and
                        # capture (one cuBLAS workspace, not one a program)
replays = 0             # calls of every program since the import
captures = 0            # programs captured (cache misses)
evictions = 0           # programs evicted


# --------------------------------------------------------------------------
# state trees
# --------------------------------------------------------------------------
def where_tree(flag, old, new):
    """``torch.where(flag, old, new)`` leaf by leaf over matching trees
    (dicts, lists, tuples of tensors); ``new`` itself when ``flag`` is
    None (a step that no later step can follow needs no guard)."""
    if flag is None:
        return new
    if isinstance(new, torch.Tensor):
        return torch.where(flag, old, new)
    if isinstance(new, dict):
        return {k: where_tree(flag, old[k], v) for k, v in new.items()}
    return type(new)(where_tree(flag, o, n) for o, n in zip(old, new))


def copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at its place in
    ``dst`` (the same object is left alone)."""
    if isinstance(src, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(src, dict):
        for k, v in src.items():
            copy_tree(dst[k], v)
    elif isinstance(src, (list, tuple)):
        for d, s in zip(dst, src):
            copy_tree(d, s)


def clone_tree(t):
    """A copy of every tensor of ``t`` (dicts, lists, tuples, named
    tuples; anything else as it is)."""
    if isinstance(t, torch.Tensor):
        return t.clone()
    if isinstance(t, dict):
        return {k: clone_tree(v) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(clone_tree(v) for v in t))
    if isinstance(t, (list, tuple)):
        return type(t)(clone_tree(v) for v in t)
    return t


def tensor_ids(*trees) -> tuple:
    """(address, shape, type) of every tensor in ``trees`` (dicts in key
    order, lists, tuples): a cached graph reads those addresses."""
    out = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append((t.data_ptr(), tuple(t.shape), t.dtype))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for tree in trees:
        walk(tree)
    return tuple(out)


def lm_key(dlm) -> tuple:
    """Everything of a ``DeviceNgramLM`` that its probes read."""
    return (dlm.order, dlm.probes, dlm.unk_id, dlm.hashed, dlm._bos_id,
            tensor_ids(dlm.tbls, dlm.uni))


# --------------------------------------------------------------------------
# the loop, eager
# --------------------------------------------------------------------------
def run_loop(loop, inputs: Sequence[torch.Tensor], unroll: int):
    """The decode eagerly: ``init``, then chunks of ``unroll`` guarded
    steps with one host read of ``done`` after each chunk but the last,
    then ``result``; a chunk's first step unguarded (module docstring)."""
    if unroll < 1:
        raise ValueError(f"unroll={unroll}: need at least 1")
    s = loop.init(*inputs)
    for start in range(0, loop.max_len, unroll):
        for l in range(start, min(start + unroll, loop.max_len)):
            s = loop.step(s, l, l > start)
        if start + unroll < loop.max_len and bool(s["done"]):
            break
    return loop.result(s)


# --------------------------------------------------------------------------
# the loop, as CUDA graphs
# --------------------------------------------------------------------------
def _counts() -> list:
    return [getattr(mod, attr) for mod, attr in COUNTERS]


def _add_counts(delta) -> None:
    for (mod, attr), d in zip(COUNTERS, delta):
        if d:
            setattr(mod, attr, getattr(mod, attr) + d)


class Graphed:
    """One decode program captured as CUDA graphs (module docstring).
    ``capture_ms`` and ``reserved_bytes`` are the capture's cost (its
    private pool's device memory); ``replays`` and ``done_reads`` count
    the calls and the host reads of ``done``; ``name`` is the entry
    point's and ``shapes`` the inputs'."""

    def __init__(self, loop, inputs: Sequence[torch.Tensor], unroll: int,
                 finish: Callable, name: str = ""):
        dev = inputs[0].device
        self.device = dev
        self.name = name
        self.shapes = [tuple(t.shape) for t in inputs]
        self.inputs = [t.clone() for t in inputs]
        # warm-up: builds the kernels, initialises cuBLAS and every lazy
        # cache a capture must find ready
        side = _streams.get(dev) or _streams.setdefault(
            dev, torch.cuda.Stream(dev))
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            finish(run_loop(loop, self.inputs, unroll))
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(dev)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = side
        self._chunks, self._final = [], None
        if loop.max_len == 0:           # no loop: one graph
            self._init, self.out = self._capture(
                lambda: finish(loop.result(loop.init(*self.inputs))))
        else:
            self._init, self.state = self._capture(
                lambda: loop.init(*self.inputs))
            for start in range(0, loop.max_len, unroll):
                stop = min(start + unroll, loop.max_len)
                self._chunks.append(self._capture(
                    lambda start=start, stop=stop: self._chunk(loop, start,
                                                               stop))[0])
            # a result made of the state's own tensors captures nothing
            final, self.out = self._capture(
                lambda: finish(loop.result(self.state)), may_be_empty=True)
            self._final = final if final[0] is not None else None
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.reserved_bytes = max(0, torch.cuda.memory_reserved(dev)
                                  - reserved0)
        self.replays = 0
        self.done_reads = 0
        self._last = None       # the event after the last call's copy-out

    def _chunk(self, loop, start: int, stop: int) -> None:
        s = self.state
        for l in range(start, stop):
            s = loop.step(s, l, l > start)
        copy_tree(self.state, s)

    def _capture(self, fn, may_be_empty: bool = False):
        """(graph and its counter changes, what ``fn`` returned); with
        ``may_be_empty`` the graph is None when ``fn`` issued no work."""
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass            # the first error is the one to report
                raise
            with warnings.catch_warnings(record=True) as said:
                warnings.simplefilter("always")
                graph.capture_end()
        for w in said:
            if may_be_empty and "Graph is empty" in str(w.message):
                graph = None
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-d for d in delta])    # a capture launches nothing
        return (graph, delta), out

    @staticmethod
    def _replay(graph_delta) -> None:
        graph, delta = graph_delta
        graph.replay()
        _add_counts(delta)

    def __call__(self, *inputs):
        """The decode of ``inputs``, a copy of the graphs' outputs.  The
        caller holds ``_lock``; a call from another stream first waits
        for the last call's copy-out, so it cannot overwrite the inputs
        or outputs that copy still reads."""
        stream = torch.cuda.current_stream(self.device)
        if self._last is not None:
            stream.wait_event(self._last)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        self._replay(self._init)
        for i, chunk in enumerate(self._chunks):
            self._replay(chunk)
            if i + 1 < len(self._chunks):
                self.done_reads += 1
                if bool(self.state["done"]):        # one host sync
                    break
        if self._final is not None:
            self._replay(self._final)
        out = clone_tree(self.out)
        self._last = stream.record_event()
        self.replays += 1
        global replays
        replays += 1
        return out


def _spec(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.dtype, t.device)


def _math_flags() -> tuple:
    """The backend switches a captured matmul or convolution keeps."""
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32)


def evict(cache: "OrderedDict", budget: int, max_programs: int) -> int:
    """Drop ``cache``'s least recently used programs until the rest hold
    at most ``budget`` bytes (their ``reserved_bytes``) and number at
    most ``max_programs``; the newest always stays.  Returns how many
    went."""
    n = 0
    while len(cache) > 1 and (
            len(cache) > max_programs
            or sum(p.reserved_bytes for p in cache.values()) > budget):
        cache.popitem(last=False)
        n += 1
    return n


def budget_bytes(dev) -> int:
    """The bytes the cached programs may hold on ``dev``."""
    return int(BUDGET_FRACTION
               * torch.cuda.get_device_properties(dev).total_memory)


def run(key: tuple, loop, inputs: Sequence[torch.Tensor], unroll: int,
        finish: Optional[Callable] = None):
    """``finish(result)`` of the decode ``loop`` on ``inputs``: eager on a
    CPU tensor, a replay of the cached program under ``key`` (plus the
    inputs' shapes and types and ``unroll``) on a CUDA tensor, whose
    outputs are copied out before another call can replay it.  The cache
    holds the programs of one card (the port runs one a process)."""
    finish = finish or (lambda r: r)
    if inputs[0].device.type != "cuda":
        return finish(run_loop(loop, inputs, unroll))
    key = (*key, _math_flags(), unroll, *(_spec(t) for t in inputs))
    global captures, evictions
    with _lock:
        prog = _cache.get(key)
        if prog is None:
            prog = Graphed(loop, inputs, unroll, finish, name=key[0])
            _cache[key] = prog
            captures += 1
            gone = evict(_cache, budget_bytes(prog.device), MAX_PROGRAMS)
            if gone:
                evictions += gone
                torch.cuda.empty_cache()
        else:
            _cache.move_to_end(key)
        return prog(*inputs)


def programs() -> list:
    """The cached programs, least recently used first, as (key,
    ``Graphed``)."""
    with _lock:
        return list(_cache.items())


def clear() -> None:
    """Drop every cached program and release its memory."""
    with _lock:
        _cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
