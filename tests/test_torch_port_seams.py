"""PyTorch port: the seam between a hand-written kernel's module and the
rest of the port, on the CPU.

* The graph runner (``utils/graphs.py``) imports nothing of the port but
  the kernels' shared runtime (``ops/cuda/build.py``) and the counter
  registry (``utils/observe.py``), and reads no private attribute of a
  module it imports; nothing under ``ops/`` imports a layer above it.
* Every counter the benchmark reads (``port_bench/kernels/*.json``, and
  the program's counters that ``port_bench/encoders/*.py`` forward) is
  registered and is an int on its module.
* The registry itself: counts, changes by name, additions; the refresh
  list runs K7's; the LM's graph key.
"""

import ast
import glob
import importlib
import json
import os
import sys
import types

import pytest

from chinese_asr_tpu_torch.ops.cuda import build
from chinese_asr_tpu_torch.ops.cuda import gemm as tgemm
from chinese_asr_tpu_torch.utils import graphs, observe

from torch_port_util import GOLD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "chinese_asr_tpu_torch"
PKG_DIR = os.path.join(ROOT, PKG)
BENCH = os.path.join(ROOT, "port_bench")
# the layers above ``ops/``
ABOVE_OPS = tuple(f"{PKG}.{m}" for m in ("models", "decode", "lm", "train",
                                         "api", "serve"))


def _module_of(path: str) -> str:
    rel = os.path.relpath(path, ROOT)[:-len(".py")].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _is_module(name: str) -> bool:
    base = os.path.join(ROOT, *name.split("."))
    return os.path.isfile(base + ".py") or os.path.isdir(base)


def _imports(path: str) -> set:
    """Every module ``path`` imports, at top level or inside a function,
    relative imports resolved; ``from pkg import name`` counts as
    ``pkg.name`` where that is a module."""
    mod = _module_of(path)
    pkg = mod if path.endswith("__init__.py") else mod.rsplit(".", 1)[0]
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg.rsplit(".", node.level - 1)[0] \
                    if node.level > 1 else pkg
                base = f"{base}.{node.module}" if node.module else base
            else:
                base = node.module
            for a in node.names:
                sub = f"{base}.{a.name}"
                out.add(sub if _is_module(sub) else base)
    return out


def test_graph_runner_imports_only_the_runtime_and_the_registry():
    path = os.path.join(PKG_DIR, "utils", "graphs.py")
    ours = {m for m in _imports(path) if m.split(".")[0] == PKG}
    assert ours == {f"{PKG}.ops.cuda.build", f"{PKG}.utils.observe"}
    # and reads no private attribute of a module it imports
    tree = ast.parse(open(path).read())
    names = {a.asname or a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom)) for a in n.names}
    private = {f"{n.value.id}.{n.attr}" for n in ast.walk(tree)
               if isinstance(n, ast.Attribute) and n.attr.startswith("_")
               and isinstance(n.value, ast.Name) and n.value.id in names}
    assert not private, private


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(PKG_DIR, "ops", "**", "*.py"), recursive=True)),
    ids=lambda p: os.path.relpath(p, PKG_DIR))
def test_ops_import_no_layer_above_them(path):
    bad = {m for m in _imports(path)
           if any(m == a or m.startswith(a + ".") for a in ABOVE_OPS)}
    assert not bad, f"{_module_of(path)} imports {sorted(bad)}"


def _bench_counters() -> list:
    """(module, attribute) of every counter ``port_bench/kernels/*.json``
    names."""
    out = []
    for fn in sorted(glob.glob(os.path.join(BENCH, "kernels", "*.json"))):
        with open(fn) as f:
            for v in json.load(f)["kernels"].values():
                out.extend(tuple(c) for c in v["counters"])
    return out


def _forwarded_counters() -> list:
    """(program module, attribute) of every counter a
    ``port_bench/encoders/*.py`` module forwards from the program in its
    ``__getattr__``: the attribute names it compares ``name`` with and the
    module it looks up in ``sys.modules``."""
    out = []
    for fn in sorted(glob.glob(os.path.join(BENCH, "encoders", "*.py"))):
        for fdef in ast.walk(ast.parse(open(fn).read())):
            if not (isinstance(fdef, ast.FunctionDef)
                    and fdef.name == "__getattr__"):
                continue
            consts = [n.value for n in ast.walk(fdef)
                      if isinstance(n, ast.Constant)
                      and isinstance(n.value, str)]
            mods = [c for c in consts if c.startswith(PKG + ".")]
            attrs = [n.comparators[0].value for n in ast.walk(fdef)
                     if isinstance(n, ast.Compare)
                     and isinstance(n.comparators[0], ast.Constant)]
            out.extend((m, a) for m in mods for a in attrs)
    return out


def test_the_benchmark_names_counters_the_program_forwards():
    for family in ("conformer", "e_branchformer"):
        assert (f"port_bench.encoders.{family}", "blocks") in _bench_counters()
        assert (f"{PKG}.models.{family}", "blocks") in _forwarded_counters()


@pytest.mark.parametrize("mod,attr",
                         _bench_counters() + _forwarded_counters(),
                         ids=lambda x: x)
def test_every_counter_the_benchmark_reads_is_registered(mod, attr):
    module = importlib.import_module(mod)
    assert isinstance(getattr(module, attr), int)
    if mod.startswith(PKG + "."):
        assert (module, attr) in observe.counters().values()


def test_registry_counts_by_name():
    name = "counter_probe_for_tests"
    fake = types.ModuleType(f"{PKG}_probe.{name}")
    fake.hits = 3
    sys.modules[fake.__name__] = fake
    try:
        before = observe.counts()
        observe.register_counters(fake.__name__, "hits")
        assert observe.counters()[f"{name}.hits"] == (fake, "hits")
        # registered after ``before``: it changed from 0 to 3
        assert observe.count_changes(before) == {f"{name}.hits": 3}
        now = observe.counts()
        fake.hits += 2
        assert observe.count_changes(now) == {f"{name}.hits": 2}
        observe.add_counts({f"{name}.hits": -5})
        assert fake.hits == 0 and observe.count_changes(now) == {
            f"{name}.hits": -3}
        # the same counter again is the same entry; another module's
        # counter of the same name is refused, and the first one stays
        observe.register_counters(fake.__name__, "hits")
        other = types.ModuleType(f"{PKG}_other.{name}")
        other.hits = 0
        sys.modules[other.__name__] = other
        with pytest.raises(ValueError):
            observe.register_counters(other.__name__, "hits")
        assert observe.counters()[f"{name}.hits"] == (fake, "hits")
    finally:
        observe._counters.pop(f"{name}.hits", None)
        del sys.modules[fake.__name__]
        sys.modules.pop(f"{PKG}_other.{name}", None)


def test_counter_changes_sum_by_name():
    a, b = {"x.launches": 2}, {"y.launches": 1, "x.launches": 3}
    assert graphs._plus(a, b) == {"x.launches": 5, "y.launches": 1}
    assert graphs._plus({}, a) == a


def test_refresh_runs_the_kernels_caches():
    assert tgemm.refresh in build._refreshers
    calls = []
    build.on_replay(lambda: calls.append(1))
    try:
        build.refresh()
        build.refresh()
    finally:
        build._refreshers.pop()
    assert calls == [1, 1]


def test_lm_graph_key_is_what_its_probes_read():
    from chinese_asr_tpu_torch.lm.device_ngram import DeviceNgramLM
    dlm = DeviceNgramLM.from_arpa(os.path.join(GOLD, "lm.arpa"), "cpu")
    key = dlm.graph_key()
    assert key == (dlm.order, dlm.probes, dlm.unk_id, dlm.hashed,
                   int(dlm.begin_context(1)[0, -1]),
                   graphs.tensor_ids(dlm.tbls, dlm.uni))
    assert dlm.to("cpu").graph_key()[:5] == key[:5]
