"""The compiled decode entry points' runner (the ``*_jit`` forms of
``decode/``, and the front end's ``features.front_end_jit``): a
device-resident decode loop, eager on the CPU and one CUDA graph on the
card.  This is the port's counterpart of the JAX package's ``jax.jit``
over a ``lax.while_loop``: "jit" in a ``*_jit`` name means a graph replay
here, and as XLA's loop does, the graph tests the loop's stop flag on the
card, so a call returns as soon as its work is queued.

A decode is a loop object with ``max_len``, ``init(*inputs)`` (encode the
batch; returns the loop state, a tree of tensors holding a 0-d bool
``done``), ``step(state, l, guard)`` (one step; with ``guard`` it is an
identity once ``done`` holds, as JAX's ``keep`` makes its stopping step)
and ``result(state)``.  A loop of no steps (``max_len`` 0: the front
end, the rescorer's selection) is ``result(init(*inputs))``.

``run_loop`` runs it eagerly in chunks of ``unroll`` steps and reads
``done`` on the host once per chunk (JAX's ``unroll``, ``beam.py``
``body_unrolled``).  Only a step after the first of its chunk can follow
the stop, so only those are guarded: the first found the loop running
(the host read before it, or on the card the IF node), and at
``unroll=1`` no step is guarded.  ``run`` is what the ``*_jit`` forms
call: on a CPU tensor ``run_loop``; on a CUDA tensor a cached
``Graphed`` program.

``Graphed`` captures, after one eager warm-up on a side stream (it builds
the kernels and initialises cuBLAS), the encode and the loop's initial
state, one part per chunk of ``unroll`` steps with ``l`` fixed, and the
result, all in one private memory pool, and composes them into one
executable graph (``_Composed``, ``csrc/runtime.cu``): every chunk after
the first sits inside a conditional IF node whose handle a one-thread
kernel sets from ``done`` just before it, so once ``done`` holds each
later chunk costs that kernel alone.  Each chunk copies its new state into
the state tensors the encode made (each tensor a step replaces is a copy
of its own, ``own_tree``), so every chunk reads and writes the same
tensors and a chunk that does not run leaves them as the identity steps
would.  A call copies the inputs into the graph's own, launches the one
graph, and returns a copy of the result made before any other call may
launch the program: the outputs are the caller's, as ``jax.jit``'s are.
Nothing is read on the host.  A failed capture, composition or launch
raises; nothing falls back to the eager loop or to host reads.

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
capture is not a launch.  Each capture's changes of the registered
counters (``utils/observe.py``) are taken back out, by name; a call adds those of the parts that always run (the encode, the
first chunk, the result) and leaves those of the guarded chunks pending
beside a copy of the graph's own count of the chunks that ran
(``_ran``, on its way to pinned host memory); ``settle`` adds them once
the call is done.  A decode's finalization calls ``settle`` after its
host reads, so the counters keep meaning launches on the card.  A
replay runs no Python, so each call first brings the kernels' caches up
to date (``ops/cuda/build.py`` ``refresh``), as an eager call would.

``StepGraphs`` compiles a step that writes new state into the caller's
tensors (the train step, JAX's jitted step with params and optimizer
state donated): one graph a key, warmed up and captured as above, all
of one ``StepGraphs`` in one shared pool, bounded by bytes (its docstring).
"""

from __future__ import annotations

import ctypes
import gc
import threading
import time
import warnings
from collections import OrderedDict, deque
from typing import Callable, Optional, Sequence

import torch

from ..ops.cuda import build
from . import observe

# the share of the card's memory that every cached program's private
# pool may hold together: a program holds ~82 MB a million batch samples
# (f32, bw 16; 834 MB at B=32 of 20 s), and the ~80 keys that a server
# on the 1-32 ladder meets on 1-20 s requests hold ~9.5 GB (H100)
BUDGET_FRACTION = 0.25
# and the most programs cached: each holds its parameters by reference
MAX_PROGRAMS = 256
# the share of the card's memory that one ``StepGraphs``'s pool and static
# inputs may hold before its next new key drops them (its docstring)
STEP_BUDGET_FRACTION = 0.5
# the ``*_jit`` forms' steps a chunk: on the card one IF node a chunk, at
# most UNROLL - 1 identity steps after an early stop; on the CPU one host
# read of ``done`` a chunk
UNROLL = 4

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


def _extent(t: torch.Tensor) -> tuple:
    """The byte range [start, end) a tensor's elements span."""
    n = 1 + sum((k - 1) * st for k, st in zip(t.shape, t.stride())) \
        if t.numel() else 0
    return t.data_ptr(), t.data_ptr() + n * t.element_size()


def written_paths(old, new, path: tuple = ()) -> list:
    """The places (tuples of keys and indices) of the tensors of ``old``
    that ``copy_tree(old, new)`` writes: those ``new`` replaces."""
    if isinstance(new, torch.Tensor):
        return [] if new is old else [path]
    if isinstance(new, dict):
        return [p for k, v in new.items()
                for p in written_paths(old[k], v, path + (k,))]
    if isinstance(new, (list, tuple)):
        return [p for i, (o, v) in enumerate(zip(old, new))
                for p in written_paths(o, v, path + (i,))]
    return []


def own_tree(tree, paths, path: tuple = ()):
    """``tree`` with a copy of its own of each tensor at ``paths``
    (``written_paths``): a graph copies each step's new state into those
    tensors, which must be neither another state tensor (the decoders'
    zero state holds one tensor in every slot) nor a caller's (a learned
    init state is a view of its parameter)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone() if path in paths else tree
    if isinstance(tree, dict):
        return {k: own_tree(v, paths, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(own_tree(v, paths, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(own_tree(v, paths, path + (i,))
                          for i, v in enumerate(tree))
    return tree


def check_writes(dst, src) -> None:
    """Raise unless the tensors of ``dst`` that ``copy_tree(dst, src)``
    writes share no memory with each other nor with any other tensor of
    ``dst``: a graph that copies its new state into its state tensors would
    otherwise write one buffer twice, or overwrite a tensor it reads."""
    written, leaves = [], {}

    def walk(d, s):
        if isinstance(d, torch.Tensor):
            leaves.setdefault(id(d), d)
            if s is not d:
                written.append(d)
        elif isinstance(d, dict):
            for k, v in d.items():
                walk(v, s.get(k, v))
        elif isinstance(d, (list, tuple)):
            for v, w in zip(d, s):
                walk(v, w)

    walk(dst, src)
    spans = [(t, _extent(t)) for t in leaves.values()]
    ids = [id(w) for w in written]
    for w in written:
        a0, a1 = _extent(w)
        if ids.count(id(w)) > 1 or any(t is not w and a0 < b1 and b0 < a1
                                       for t, (b0, b1) in spans):
            raise ValueError(
                f"a state tensor {tuple(w.shape)} {w.dtype} that each step "
                f"writes shares memory with another tensor of the state")


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


# --------------------------------------------------------------------------
# the loop, eager
# --------------------------------------------------------------------------
def run_loop(loop, inputs: Sequence[torch.Tensor], unroll: int,
             on_step: Optional[Callable] = None):
    """The decode eagerly: ``init``, then chunks of ``unroll`` guarded
    steps with one host read of ``done`` after each chunk but the last,
    then ``result``; a chunk's first step unguarded (module docstring).
    ``on_step(old, new)`` sees each step's state before and after."""
    if unroll < 1:
        raise ValueError(f"unroll={unroll}: need at least 1")
    s = loop.init(*inputs)
    for start in range(0, loop.max_len, unroll):
        for l in range(start, min(start + unroll, loop.max_len)):
            new = loop.step(s, l, l > start)
            if on_step is not None:
                on_step(s, new)
            s = new
        if start + unroll < loop.max_len and bool(s["done"]):
            break
    return loop.result(s)


# --------------------------------------------------------------------------
# the loop, as CUDA graphs
# --------------------------------------------------------------------------
def _plus(a: dict, b: dict) -> dict:
    """Two counter changes (``observe.count_changes``) summed, by name."""
    return {n: a.get(n, 0) + b.get(n, 0) for n in {**a, **b}}


def _warm_up(dev, fn) -> torch.cuda.Stream:
    """Run ``fn`` eagerly on the side stream of ``dev`` (every warm-up and
    capture takes it: one cuBLAS workspace, not one a program) and wait
    for it; returns the stream."""
    side = _streams.get(dev) or _streams.setdefault(
        dev, torch.cuda.Stream(dev))
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    return side


def _capture(fn, pool, stream, may_be_empty: bool = False,
             keep: bool = False):
    """(graph and its counter changes, what ``fn`` returned), ``fn``
    captured on ``stream`` into the memory pool ``pool``; with
    ``may_be_empty`` the graph is None when ``fn`` issued no work; with
    ``keep`` the graph is kept uninstantiated, a part for ``_Composed``.
    A failed capture raises."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    before = observe.counts()
    # no cyclic garbage collection while capturing: a destructor it ran
    # (a graph's, an event's) would call CUDA on this thread mid-capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
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
    finally:
        if collecting:
            gc.enable()
    for w in said:
        if may_be_empty and "Graph is empty" in str(w.message):
            graph = None
        else:
            warnings.warn_explicit(w.message, w.category, w.filename,
                                   w.lineno)
    delta = observe.count_changes(before)
    # a capture launches nothing
    observe.add_counts({n: -d for n, d in delta.items()})
    return (graph, delta), out


def _replay(graph_delta) -> None:
    graph, delta = graph_delta
    graph.replay()
    observe.add_counts(delta)


# the launch counts of the guarded chunks that calls replayed, waiting for
# their chunk count to reach the host: (event after its copy, the pinned
# count, the counter changes of the first n guarded chunks for each n)
_pending: deque = deque()


def settle(wait: bool = False) -> None:
    """Add to the launch counters what the guarded chunks of finished
    calls launched, in call order, as far as the first call still on the
    card; with ``wait``, wait for every call.  A decode's finalization
    calls it after its host reads; so does ``run``."""
    with _lock:
        while _pending:
            event, ran, cum = _pending[0]
            if wait:
                event.synchronize()
            elif not event.query():
                return
            _pending.popleft()
            observe.add_counts(cum[int(ran)])


class _Composed:
    """Captured parts as one executable graph (``csrc/runtime.cu``
    ``asr_graph_compose``): each part a copy of its captured graph, in
    order; a guarded part inside a conditional IF node whose handle a
    one-thread kernel sets from the 0-d bool ``done`` just before it, so
    the part runs only while ``done`` is false.  Launched on the caller's
    stream; destroyed with the object."""

    def __init__(self, parts, guarded, done: torch.Tensor):
        n = len(parts)
        raw = (ctypes.c_ulonglong * n)(*(g.raw_cuda_graph() for g in parts))
        flags = (ctypes.c_int * n)(*(int(x) for x in guarded))
        graph, exec_ = ctypes.c_ulonglong(), ctypes.c_ulonglong()
        fn = build.kernel("asr_graph_compose", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p])
        build.check("asr_graph_compose", fn(
            raw, flags, n, done.data_ptr(), ctypes.byref(graph),
            ctypes.byref(exec_)))
        self._graph, self._exec = graph.value, exec_.value

    def launch(self, stream: torch.cuda.Stream) -> None:
        fn = build.kernel("asr_graph_launch", [ctypes.c_ulonglong,
                                               ctypes.c_void_p])
        build.check("asr_graph_launch", fn(self._exec, stream.cuda_stream))

    def __del__(self):
        if not getattr(self, "_exec", None):
            return
        # a launch still on the card completes first (cudaGraphExecDestroy)
        fn = build.kernel("asr_graph_destroy", [ctypes.c_ulonglong,
                                                ctypes.c_ulonglong])
        fn(self._graph, self._exec)
        self._exec = None


class Graphed:
    """One decode program as one CUDA graph (module docstring).
    ``capture_ms`` and ``reserved_bytes`` are the capture's cost (its
    private pool's device memory); ``replays`` counts the calls; ``name``
    is the entry point's, ``shapes`` the inputs', and ``chunks`` the
    chunks of ``unroll`` steps, all but the first guarded."""

    def __init__(self, loop, inputs: Sequence[torch.Tensor], unroll: int,
                 finish: Callable, name: str = ""):
        dev = inputs[0].device
        self.device = dev
        self.name = name
        self.shapes = [tuple(t.shape) for t in inputs]
        self.inputs = [t.clone() for t in inputs]
        # warm-up: builds the kernels, initialises cuBLAS and every lazy
        # cache a capture must find ready, and finds the state tensors a
        # step replaces (its first chunk runs both kinds of step)
        written = set()
        side = _warm_up(dev, lambda: finish(run_loop(
            loop, self.inputs, unroll,
            lambda old, new: written.update(written_paths(old, new)))))
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(dev)
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = side
        self._exec = self._cum = None
        self.chunks = 0
        if loop.max_len == 0:           # no loop: one graph
            self._graph, self.out = self._capture(
                lambda: finish(loop.result(loop.init(*self.inputs))))
            self._fixed = self._graph[1]
        else:
            self._capture_loop(loop, unroll, finish, written)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.reserved_bytes = max(0, torch.cuda.memory_reserved(dev)
                                  - reserved0)
        self.replays = 0
        self._last = None       # the event after the last call's copy-out

    def _capture_loop(self, loop, unroll: int, finish: Callable,
                      written) -> None:
        """The parts of the one graph: the encode and the loop's initial
        state, a chunk of ``unroll`` steps at a time with ``l`` fixed (all
        but the first guarded, each counting itself in ``_ran``), the
        result; composed by ``_Composed``."""
        def init():
            # in the pool, as all the program's memory: zeroed every launch
            self._ran = torch.zeros((), dtype=torch.int32, device=self.device)
            return own_tree(loop.init(*self.inputs), written)

        (g, delta), self.state = self._capture(init, keep=True)
        parts, guarded, fixed, deltas = [g], [False], delta, []
        for start in range(0, loop.max_len, unroll):
            stop = min(start + unroll, loop.max_len)
            first = start == 0
            (g, delta), _ = self._capture(
                lambda start=start, stop=stop, first=first: self._chunk(
                    loop, start, stop, count=not first), keep=True)
            parts.append(g)
            guarded.append(not first)
            if first:
                fixed = _plus(fixed, delta)
            else:
                deltas.append(delta)
        self.chunks = len(deltas) + 1
        # a result made of the state's own tensors captures nothing
        (g, delta), self.out = self._capture(
            lambda: finish(loop.result(self.state)), may_be_empty=True,
            keep=True)
        if g is not None:
            parts.append(g)
            guarded.append(False)
            fixed = _plus(fixed, delta)
        self._parts = parts             # their pool stays while they do
        self._exec = _Composed(parts, guarded, self.state["done"])
        self._fixed = fixed
        cum = [{}]
        for delta in deltas:
            cum.append(_plus(cum[-1], delta))
        self._cum = cum

    def _chunk(self, loop, start: int, stop: int, count: bool) -> None:
        s = self.state
        for l in range(start, stop):
            s = loop.step(s, l, l > start)
        copy_tree(self.state, s)
        if count:
            self._ran.add_(1)

    def _capture(self, fn, may_be_empty: bool = False, keep: bool = False):
        return _capture(fn, self._pool, self._stream, may_be_empty, keep)

    def __call__(self, *inputs):
        """The decode of ``inputs``: the inputs copied in, one graph
        launched, the outputs copied out, nothing read on the host (the
        counters of the guarded chunks that ran are added by ``settle``
        once the call is done).  The caller holds ``_lock``; a call from
        another stream first waits for the last call's copy-out, so it
        cannot overwrite the inputs or outputs that copy still reads."""
        stream = torch.cuda.current_stream(self.device)
        if self._last is not None:
            stream.wait_event(self._last)
        build.refresh()         # the kernels' caches of changed weights
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        if self._exec is None:
            self._graph[0].replay()
        else:
            self._exec.launch(stream)
            ran = torch.empty((), dtype=torch.int32, pin_memory=True)
            ran.copy_(self._ran, non_blocking=True)
            _pending.append((stream.record_event(), ran, self._cum))
        observe.add_counts(self._fixed)
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
    settle()
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


# --------------------------------------------------------------------------
# a step that updates state in place, as CUDA graphs in one shared pool
# --------------------------------------------------------------------------
def _commit(fn, inputs, check: bool = False, written=None):
    """``fn(*inputs)``'s writes made (each new value copied into its state
    tree; with ``check``, ``check_writes`` first), its output returned;
    ``written``, a list, gets the state trees written."""
    writes, out = fn(*inputs)
    if check:
        check_writes([d for d, _ in writes], [s for _, s in writes])
    for dst, src in writes:
        copy_tree(dst, src)
        if written is not None:
            written.append(dst)
    return out


def _bump_versions(tree) -> None:
    """Count a replay's writes into the state's version counters, as the
    eager copies would: a kernel's cache of a tensor keys on its
    version."""
    if isinstance(tree, torch.Tensor):
        torch.autograd.graph.increment_version(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _bump_versions(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _bump_versions(v)


class _StaticInputs:
    """The static input buffers of every graph of one ``StepGraphs``: one
    flat buffer a position, each key's input a view at its start.
    Replays are serial and each copies its inputs in before it runs, so
    the keys share them.  A key that needs more than a buffer holds gets
    a new one of twice its size (or the need, if larger); the graphs that
    read the old keep it alive until they go, so the buffers of a
    position hold under four times the largest key's input."""

    def __init__(self):
        self.bufs: list = []

    def views(self, inputs) -> list:
        out = []
        for i, t in enumerate(inputs):
            n = t.numel() * t.element_size()
            if i == len(self.bufs):
                self.bufs.append(None)
            buf = self.bufs[i]
            if buf is None or buf.numel() < n:
                buf = self.bufs[i] = torch.empty(
                    max(n, 2 * (0 if buf is None else buf.numel())),
                    dtype=torch.uint8, device=t.device)
            out.append(buf[:n].view(t.dtype).view(t.shape))
        return out


class _StepProgram:
    """One key's graph of a ``StepGraphs`` step: views of the shared
    static inputs, the graph (captured into the shared pool after one
    eager warm-up that commits nothing) and its outputs."""

    def __init__(self, fn, inputs, pool, static: _StaticInputs):
        dev = inputs[0].device
        self.inputs = static.views(inputs)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        # warm-up: builds the kernels, initialises cuBLAS and every lazy
        # cache a capture must find ready; its new state is dropped
        side = _warm_up(dev, lambda: fn(*self.inputs))
        # the warm-up's memory goes back to the card, not to a cache the
        # pool cannot use
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(dev)
        self._written = []
        self._graph, self.out = _capture(
            lambda: _commit(fn, self.inputs, check=True,
                            written=self._written), pool, side)
        torch.cuda.synchronize(dev)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.reserved_bytes = max(0, torch.cuda.memory_reserved(dev)
                                  - reserved0)
        self.replays = 0

    def __call__(self, *inputs):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        _replay(self._graph)
        _bump_versions(self._written)
        self.replays += 1
        # a copy made before any graph of the pool can overwrite the outputs
        return clone_tree(self.out)


class StepGraphs:
    """A step that writes new state into the caller's tensors, compiled:
    the counterpart of ``jax.jit(..., donate_argnums=...)`` over the train
    step (``train/step.py`` ``CompiledStep``).

    ``__call__(key, fn, inputs)``: ``fn(*inputs)`` returns ``(writes,
    out)``, ``writes`` pairs (state tree, its new value), ``out`` a tree
    of tensors.  On a CPU tensor ``fn`` runs eagerly and its new values
    are copied into the state.  On a CUDA tensor the call replays one
    graph captured for ``key`` (plus the math switches and the inputs'
    shapes and types): the inputs copied into the graph's own, the new
    state copied into the state's tensors inside the graph, and ``out``
    copied out before the next replay.  The key must hold the state
    tensors' addresses (``tensor_ids``): a graph reads and writes those.
    A failed capture or replay raises.

    All graphs of one ``StepGraphs`` share one memory pool and one set of
    static input buffers (``_StaticInputs``): the state lives outside
    them, replays are strictly serial, and each replay's outputs are
    copied out before the next, so a graph may reuse what another left.
    The pool only grows (``pool_bytes``, its growth over the captures
    since it was made), and by how much depends on the order in which
    the keys come (``tools/step_memory.py`` measures it over an epoch's
    keys).  So the graphs are bounded by the bytes of the pool and the
    input buffers together: when they hold more than ``budget_fraction``
    of the card, the next new key first drops every graph and the pool
    (``resets``), and the keys met again are captured anew.  The card
    then holds at most the budget plus one key's capture.
    ``MAX_PROGRAMS`` bounds the count (least recently used out)."""

    def __init__(self):
        self.budget_fraction = STEP_BUDGET_FRACTION
        self._cache: "OrderedDict[tuple, _StepProgram]" = OrderedDict()
        self._pool = None
        self._static = _StaticInputs()
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.resets = 0
        self.pool_bytes = 0
        self.capture_ms = 0.0       # the captures' time, warm-ups apart

    def input_bytes(self) -> int:
        """The bytes of the static input buffers, those the cached graphs
        read and the newest."""
        held = {b.data_ptr(): b.numel() for b in self._static.bufs
                if b is not None}
        for prog in self._cache.values():
            for t in prog.inputs:
                st = t.untyped_storage()
                held[st.data_ptr()] = st.nbytes()
        return sum(held.values())

    def __call__(self, key: tuple, fn: Callable,
                 inputs: Sequence[torch.Tensor]):
        if inputs[0].device.type != "cuda":
            return _commit(fn, inputs)
        key = (*key, _math_flags(), *(_spec(t) for t in inputs))
        with self._lock:
            prog = self._cache.get(key)
            if prog is None:
                budget = self.budget_fraction * (
                    torch.cuda.get_device_properties(inputs[0].device)
                    .total_memory)
                if self._cache and (self.pool_bytes + self.input_bytes()
                                    > budget):
                    self._cache.clear()
                    self._pool, self.pool_bytes = None, 0
                    self.resets += 1
                    torch.cuda.empty_cache()
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog = _StepProgram(fn, inputs, self._pool, self._static)
                self._cache[key] = prog
                self.captures += 1
                self.pool_bytes += prog.reserved_bytes
                self.capture_ms += prog.capture_ms
                evict(self._cache, float("inf"), MAX_PROGRAMS)
            else:
                self._cache.move_to_end(key)
            self.replays += 1
            return prog(*inputs)

    def programs(self) -> list:
        """The cached graphs, least recently used first, as (key,
        program with ``capture_ms``, ``reserved_bytes``, ``replays``)."""
        with self._lock:
            return list(self._cache.items())


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
