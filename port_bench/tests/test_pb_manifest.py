"""BENCHMARK.json against the contract's limits, and every file it and
the cells name found by name."""

import json
import os
import re

from port_bench.lib import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def bench():
    return common.manifest()


def test_keys_and_names_are_legal():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert len(b["command"]) <= 32 and b["command"][1].startswith(
        b["paths"][0] + "/")
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) <= 64 * 1024


def test_metrics_by_the_contract():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", [c])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        reported = common.cell_metrics(b, c, False)
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert common.cell_metrics(b, c, True)


def test_every_named_file_is_found():
    b = bench()
    for c in b["configs"]:
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        cfg = common.load("configs", c["name"])
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = common.load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        mix = common.load("traffic", w["traffic"])
        assert os.path.exists(os.path.join(common.BENCH, "lib",
                                           mix["kind"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(common.reader(m["name"]))


def test_layers_agree_with_the_kernel_maps():
    b = bench()
    layers = {m["layer"] for m in b["per_layer"]}
    for k, m in common.kernel_maps().items():
        assert m["layer"] in layers, k


def test_shared_code_names_no_cell_config_or_metric():
    b = bench()
    names = ([c["name"] for c in b["configs"]]
             + [w["name"] for w in b["workloads"]]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
             + [w["traffic"] for w in b["workloads"]])
    shared = [os.path.join(common.BENCH, "run.py")] + [
        os.path.join(common.BENCH, "lib", f)
        for f in os.listdir(os.path.join(common.BENCH, "lib"))
        if f.endswith(".py")]
    for path in shared:
        with open(path) as f:
            text = f.read()
        for n in names:
            assert not re.search(r"[\"']" + re.escape(n) + r"[\"']", text), \
                (path, n)
