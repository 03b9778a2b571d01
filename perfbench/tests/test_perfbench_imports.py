"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level name: the port's name begins with the JAX package's), and
the reference loads nothing of the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.cells import ROOT

BENCH = os.path.join(ROOT, "perfbench")
NOT_IMPORTED = {"jax", "jaxlib", "flax", "cmx"}


def _sources():
    for base, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_cmx(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    assert not names & NOT_IMPORTED
    if os.sep + "reference" + os.sep in path:
        assert "cmx_torch" not in names


def test_the_top_level_name_is_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "cmx_torch_like", sys)
    assert "cmx_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cmx.ops", sys)
    assert "cmx.ops" in harness.forbidden_modules()


_RUN = """
import functools, json, sys, tempfile
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.tests import tiny
import cmx_torch.ssl.spark as spark
spark.SparKModel = functools.partial(spark.SparKModel,
    widths=tiny.TINY_WIDTHS, bottleneck_width=tiny.TINY_BOTTLENECK)
root = tiny.make_root(tempfile.mkdtemp())
harness.run("spark-tiny", 5, 0.1, False, device="cpu", root=root)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from perfbench import check, weights
from perfbench.reference import cmunet, draws, nn, optim, spark
cfg = {{"task": "spark", "widths": [4, 8, 8, 8], "bottleneck_width": 8,
        "steps_per_epoch": 1, "settings": {{
        "data.image_size": 32, "task.mask_ratio": 0.6, "optim.name": "lamb",
        "optim.lr": 1e-3, "optim.base_lr_scaled": False,
        "optim.weight_decay": 0.0, "optim.wd_end": None,
        "optim.clip_norm": 5.0, "optim.warmup_epochs": 0,
        "train.epochs": 1, "train.batch_size": 2}}}}
p, s = spark.param_spec(cfg)
w = weights.make_weights(p + s, 1, "cpu")
init = {{"params": {{n: w[n] for n, _, _ in p}},
        "stats": {{n: w[n] for n, _, _ in s}}, "extra": {{}}}}
check.follow(cfg, init, [torch.rand(2, 32, 32)], 1, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code.format(root=ROOT)],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_cmx():
    loaded = _modules(_RUN)
    assert "cmx_torch" in loaded
    assert not loaded & NOT_IMPORTED


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(_REF)
    assert not loaded & (NOT_IMPORTED | {"cmx_torch"})
