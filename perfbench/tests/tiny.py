"""Tiny cells for the CPU tests: a copy of the benchmark in a temporary
root with one configuration and one cell added as files and entries, cut
to a size a CPU runs in seconds. The program's SparK model is built at the
same reduced widths (its class patched in cmx_torch.ssl.spark, which the
pretrain CLI's build_task imports when it runs); CM-UNet's widths are
fixed, so its tiny cell keeps them and shrinks the views. Both take a
larger learning rate and no warm-up, so that three steps move every
parameter by many float32 ulps; CM-UNet's is the smaller (2e-4), since
Adam's steps of lr per weight against a target drawn apart turn its
losses by 1e-3 and more from summation order alone at 2e-2."""

from __future__ import annotations

import functools
import json
import os
import shutil

from perfbench.cells import ROOT

TINY_WIDTHS = [8, 16, 32, 64]
TINY_BOTTLENECK = 128
TINY = {
    "spark": {"config": {"data.image_size": 32, "model.dtype": "float32",
                         "train.batch_size": 8, "optim.lr": 0.02,
                         "optim.warmup_epochs": 0},
              "batch": 4, "corpus_images": 16},
    "cmunet": {"config": {"data.image_size": 48, "task.view_size": 32,
                          "model.dtype": "float32", "train.batch_size": 8,
                          "optim.lr": 2e-4, "optim.warmup_epochs": 0},
               "batch": 4, "corpus_images": 16},
}
# float32 against float32: what parts them is the order of sums, which Adam
# turns into a sign where a gradient is near zero, so the later steps'
# losses and the changes part by more than the first gradient does. At the
# tiny CM-UNet's batch of 4 (InfoNCE and the projector's batch norm over 4)
# that sign noise moves its gradients' norms at step 3 by up to 1.2% (the
# worst leaf) and 0.13% (the median), so its cell compares no gradient; at
# the cells' own warm-up rates the weights of step 3 lie a few ulps apart
# (PERF.md).
LIMITS = {"loss_gap": 2e-3, "change_gap": 5e-2, "stats_gap": 5e-3}
TASK_LIMITS = {"spark": {"grad_gap": 1e-3, "grad_median_gap": 1e-3,
                         "kernel_grad_gap": 1e-3, "grad_median_diff": 1e-3},
               "cmunet": {"target_gap": 1e-3}}


def make_root(tmp: str, runner: str = "graph") -> str:
    """A copy of BENCHMARK.json and perfbench/ under `tmp` with the cells
    "spark-tiny" and "cmunet-tiny" added; returns the root."""
    root = os.path.join(tmp, "bench")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for task, base in (("spark", "spark-unet256"),
                       ("cmunet", "cmunet-unet224")):
        with open(os.path.join(root, "perfbench", "configs",
                               base + ".json")) as f:
            cfg = json.load(f)
        cfg["name"] = task + "-tiny"
        cfg["settings"].update(TINY[task]["config"])
        cfg["corpus_images"] = TINY[task]["corpus_images"]
        if task == "spark":
            cfg["widths"], cfg["bottleneck_width"] = (TINY_WIDTHS,
                                                      TINY_BOTTLENECK)
        with open(os.path.join(root, "perfbench", "configs",
                               f"{task}-tiny.json"), "w") as f:
            json.dump(cfg, f)
        cell = {"config": f"{task}-tiny", "batch": TINY[task]["batch"],
                "runner": runner, "overrides": {}, "profile_steps": 1,
                "limits": dict(LIMITS, **TASK_LIMITS[task])}
        with open(os.path.join(root, "perfbench", "workloads",
                               f"{task}-tiny.json"), "w") as f:
            json.dump(cell, f)
        bench["configs"].append(dict(bench["configs"][0], name=f"{task}-tiny",
                                     file=f"perfbench/configs/{task}-tiny.json"))
        bench["workloads"].append({"name": f"{task}-tiny",
                                   "config": f"{task}-tiny", "traffic": "tiny",
                                   "chips": 1, "why": "a CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "spark-b128-fused" in m.get("workloads", []):
                m["workloads"].append(f"{task}-tiny")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def patch_spark_widths(monkeypatch) -> None:
    """The program's SparKModel at the tiny widths."""
    import cmx_torch.ssl.spark as spark

    monkeypatch.setattr(spark, "SparKModel", functools.partial(
        spark.SparKModel, widths=TINY_WIDTHS,
        bottleneck_width=TINY_BOTTLENECK))


def add_cell(root: str, name: str, base: str, overrides: dict) -> None:
    """Cell `name` in `root`: the tiny cell `base` with program settings
    `overrides` over its own, added as a file and an entry."""
    work_dir = os.path.join(root, "perfbench", "workloads")
    with open(os.path.join(work_dir, base + ".json")) as f:
        cell = json.load(f)
    cell["overrides"] = dict(cell["overrides"], **overrides)
    with open(os.path.join(work_dir, name + ".json"), "w") as f:
        json.dump(cell, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == base)
    bench["workloads"].append(dict(entry, name=name, traffic=name))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if base in m.get("workloads", []):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(bench, f)
