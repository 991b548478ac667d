"""Hand-written CUDA kernels of the port (sources in ``csrc/``, built and
loaded by ``build``), one module a kernel: K1 ``logmel``, K2 ``lstm``,
K3/K4 ``topk``, K5 ``adpcm``, K6 ``attention``, K7 ``gemm``, K8
``subsample``.

A module is the only place that knows its kernel.  It owns:

* the kernel and its public function, which makes the dispatch decision;
* the plain PyTorch twin (``*_plain``), the model of the kernel's
  arithmetic that the tests hold it to;
* the plan: how a launch spreads the work, and which inputs the kernel
  takes as they come (``plan``; ``grain``, ``takes``);
* its counters, module-level ints registered with ``utils/observe.py``
  where they are defined: ``launches`` (and the like) count kernel
  launches, K7's and K8's ``fallbacks`` the calls they do not compute;
* any cache of its operands that must be brought up to date before a
  captured graph replays, registered with ``build.on_replay``.

The public function: a CPU tensor takes the twin and counts no launch.  A
CUDA tensor launches the kernel.  Where a well-formed input is off the
kernel's grain, the function brings it there and launches: K6 pads a
key row to whole 16-byte units with zero columns and copies keys off a
16-byte boundary, K7 pads K to a multiple of 8 and copies an x it cannot
read in place.  K7's ``linear`` (and ``linear_pair``) is also the port's
product where K7 does not compute it: under autograd (K7 has no
backward) and in other dtypes it takes the plain ``x @ w + b``, as the
port did before K7, counted in ``fallbacks`` (on the CPU too); K8's
``convs`` there returns None, counted the same way, and its caller runs
the two ``F.conv2d`` of before K8.
Everything else raises: shapes that disagree, mixed dtypes or a dtype
the kernel has no version of, an operand layout it cannot read, a needed
gradient where the kernel has no backward, K6 at a width whose key tiles
overflow shared memory, and K2 at a hidden size above 1024.
"""
