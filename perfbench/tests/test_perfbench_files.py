"""Cells, mixes, drivers, limits and metric readers are found by name
from files, and agree with BENCHMARK.json; nothing under perfbench/
imports JAX or the JAX package, and the reference nothing of the
program (top-level module names compared whole)."""

import ast
import json
import os

import pytest

from perfbench.run import ROOT, load_metric, metric_names

PB = os.path.join(ROOT, "perfbench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    c = next(w for w in BENCH["workloads"] if w["name"] == cell)
    cfg = json.load(open(os.path.join(PB, "configs", c["config"] + ".json")))
    mix = json.load(open(os.path.join(PB, "traffic", c["traffic"] + ".json")))
    assert os.path.exists(os.path.join(PB, "drivers", mix["driver"] + ".py"))
    from perfbench.generators import GENERATORS
    assert mix["generator"] in GENERATORS
    limits = json.load(open(os.path.join(PB, "limits", cell + ".json")))
    assert limits and all(v > 0 for v in limits.values())
    conf = next(x for x in BENCH["configs"] if x["name"] == c["config"])
    assert conf["file"] == f"perfbench/configs/{c['config']}.json"
    assert conf["source"] == cfg["source"] and conf["reduced"] == cfg["reduced"]
    assert metric_names(BENCH, c, False) and metric_names(BENCH, c, True)
    assert "setup_s" in metric_names(BENCH, c, False)


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_readers_declare_what_the_benchmark_says(group):
    for m in BENCH[group]:
        r = load_metric(m["name"])
        assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"],
                                                m["source"]), m["name"]
        if group == "per_layer":
            assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"]), m["name"]
        assert callable(r.read)


def test_wrapped_calls_exist_in_the_program():
    import importlib
    for m in BENCH["per_layer"]:
        r = load_metric(m["name"])
        targets = getattr(r, "WRAP", ())
        for t in (targets,) if isinstance(targets, str) else targets:
            mod, attr = t.split(":")
            owner = importlib.import_module(mod)
            for part in attr.split("."):
                owner = getattr(owner, part)
            assert callable(owner), t


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _py_files(PB):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(PB, "reference")):
        assert "repro_torch" not in set(_imports(path)), path
