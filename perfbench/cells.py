"""The benchmark's data: BENCHMARK.json at the root of the checkout, one
file a configuration (perfbench/configs/<config>.json), one a cell
(perfbench/workloads/<cell>.json) and one reader a metric
(perfbench/metrics/<metric>.py), each found by its name. A cell, a
configuration or a metric is added as new files and entries; no file the
harness already has needs an edit.

A configuration file holds:
  task        the reference module, perfbench/reference/<task>.py;
  preset      the program's preset that the settings start from;
  settings    the program's configuration keys as run (dotted names),
              applied over the preset and read by the reference;
  the model's widths, the corpus and its source, what was assumed.
A cell file holds:
  config      the configuration's name;
  batch       the images of one step on this card;
  runner      "graph" (the train step replayed from one CUDA graph,
              fed by a gather from the resident corpus) or "eager" (the
              step run op by op, each batch copied from host memory);
  overrides   program settings of this cell, over the configuration's;
  profile_steps   the steady steps a traced run profiles;
  limits      each compared number's limit (see perfbench/check.py).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, suffix: str, root: str) -> str:
    path = os.path.join(root, "perfbench", kind, name + suffix)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    return path


def load_cell(name: str, root: str = ROOT) -> Dict[str, Any]:
    """The cell `name` with its configuration and its metrics: "workload"
    (the cell's file), "config" (the configuration's file, with
    "steps_per_epoch" and the settings merged with the cell's overrides),
    "end_to_end" and "per_layer" (BENCHMARK.json's entries that this cell
    reports)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    work = load_json(_named("workloads", name, ".json", root))
    if work["config"] != entry["config"]:
        raise ValueError(f"{name}: its file names config {work['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    cfg = load_json(_named("configs", work["config"], ".json", root))
    settings = dict(cfg["settings"])
    settings.update(work.get("overrides", {}))
    cfg = dict(cfg, settings=settings)
    # the schedules count the global batches an epoch of the corpus holds,
    # as the pretrain CLI's sampler does
    cfg["steps_per_epoch"] = math.ceil(cfg["corpus_images"]
                                       / settings["train.batch_size"])

    def mine(m):
        return name in m.get("workloads", [name])

    return {"name": name, "entry": entry, "workload": work, "config": cfg,
            "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def metric_reader(name: str, root: str = ROOT):
    """The `read(ctx)` function of perfbench/metrics/<name>.py."""
    path = _named("metrics", name, ".py", root)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], ctx: Dict[str, Any],
                 root: str = ROOT) -> Dict[str, Dict[str, Any]]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read; a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def reference_module(task: str):
    """perfbench/reference/<task>.py, the configuration's plain reference."""
    return importlib.import_module(f"perfbench.reference.{task}")
