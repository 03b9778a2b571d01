"""The benchmark's data: BENCHMARK.json's shape, and a cell, a
configuration and a per-layer metric added as new files and entries, with
no edit to a file the benchmark has."""

import hashlib
import json
import os
import re

import pytest

from perfbench import cells
from perfbench.cells import ROOT
from perfbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _digests(root):
    out = {}
    for base, _, files in os.walk(os.path.join(root, "perfbench")):
        if "__pycache__" in base:
            continue
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_benchmark_json_has_its_fixed_shape():
    b = cells.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"img_per_s", "peak_mem_gib", "setup_s"}
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells_ = {w["name"] for w in b["workloads"]}
    reports = {w: {m["name"] for m in b["end_to_end"]
                   if w in m.get("workloads", [w])} for w in cells_}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        listed = m.get("workloads", cells_)
        assert m["moves"] in e2e and set(listed) <= cells_
        # every cell the metric is read in reports the metric it moves
        assert all(m["moves"] in reports[w] for w in listed)
        layers.setdefault(m["layer"], []).append(m["name"])
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in b["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
        cell = cells.load_cell(w["name"])
        got = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2 and cell["per_layer"]


def test_a_cell_and_a_metric_are_added_as_files(tmp_path):
    before = _digests(ROOT)
    root = tiny.make_root(str(tmp_path))
    metric = os.path.join(root, "perfbench", "metrics", "steps_run.py")
    with open(metric, "w") as f:
        f.write('"""steps_run: the window\'s steps."""\n\n\n'
                "def read(ctx):\n    return float(ctx['steps'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "steps_run", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "step runner", "moves": "img_per_s",
        "workloads": ["spark-tiny"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(root)
    # every file the benchmark had is there, byte for byte
    assert all(after[k] == v for k, v in before.items())
    cell = cells.load_cell("spark-tiny", root)
    assert cell["config"]["name"] == "spark-tiny"
    assert [m["name"] for m in cell["per_layer"]][-1] == "steps_run"
    got = cells.read_metrics(cell["per_layer"][-1:], {"steps": 7}, root)
    assert got == {"steps_run": {"value": 7.0, "unit": "steps"}}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        cells.load_cell("no-such-cell")
