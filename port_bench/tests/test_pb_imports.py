"""Nothing under port_bench/ imports JAX or the JAX package, judged by the
whole top-level module name (the port's name begins with the JAX
package's)."""

import ast
import os
import sys

import pytest

from port_bench.lib import common


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_under_port_bench_imports_jax():
    found = []
    for d, _, files in os.walk(common.BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                found += [(p, m) for m in _imports(p)
                          if m in common.FORBIDDEN]
    assert not found


def test_the_port_is_not_taken_for_the_jax_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "chinese_asr_tpu_torch_probe",
                        sys.modules[__name__])
    common.require_no_jax()          # a longer name is not the JAX package


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla", "flax",
                                  "chinese_asr_tpu.api"])
def test_a_run_holding_jax_exits_without_a_result(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, sys.modules[__name__])
    with pytest.raises(SystemExit) as e:
        common.require_no_jax()
    assert e.value.code != 0
