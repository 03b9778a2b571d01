"""The MoCo v2 configuration on the CPU: a tiny MoCo cell run through the
harness follows the reference (perfbench/reference/moco.py) and is
`correct`, and a key encoder left in eval mode is not; the reference's
FLOPs an image against a count by hand; `span_momentum_ms` reads the
`momentum` span of a trace, and nothing without a trace or where the
program has no such span (the parent of the span)."""

import functools
import json
import os
import types

import pytest
import torch

from perfbench import cells, check, harness
from perfbench.cells import load_cell
from perfbench.tests import tiny
from perfbench.tests.test_perfbench_spans import STEP, _close, _ctx, _open

SEED = 2 ** 31 + 2024  # more than 32 signed bits hold
WIDTHS, BNECK = [8, 16, 32, 64], 128
# float32 against float32 at encoder widths 8-128: the forwards part by the
# order of sums (~1e-6); the gradients of step 3 also by a 2x2 max-pool
# window whose two largest entries tie to rounding, which at these widths
# carries a few percent of a leaf's gradient (tests/
# test_torch_port_moco_reference.py); the key encoder's change is the EMA's.
LIMITS = {"loss_gap": 1e-4, "stats_gap": 1e-4, "target_gap": 0.1,
          "grad_median_gap": 0.1, "change_gap": 0.1}


@pytest.fixture
def root(tmp_path, monkeypatch):
    """A copy of the benchmark with the cell "moco-tiny": moco-unet224 at
    encoder widths 8-128, 48^2 images cut to 32^2 views, float32, a queue
    of 64, batch 8; the program's encoder at the same widths."""
    import cmx_torch.models.unet as unet

    torch.set_num_threads(4)
    monkeypatch.setattr(unet, "UNetEncoderGAP", functools.partial(
        unet.UNetEncoderGAP, widths=WIDTHS, bottleneck=BNECK))
    root = tiny.make_root(str(tmp_path))
    base = os.path.join(root, "perfbench")
    with open(os.path.join(base, "configs", "moco-unet224.json")) as f:
        cfg = json.load(f)
    cfg["settings"].update({"data.image_size": 48, "task.view_size": 32,
                            "model.dtype": "float32", "train.batch_size": 8,
                            "task.num_negatives": 64})
    cfg.update(name="moco-tiny", widths=WIDTHS, bottleneck_width=BNECK,
               corpus_images=16)
    with open(os.path.join(base, "configs", "moco-tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "workloads", "moco-b256-graph.json")) as f:
        cell = json.load(f)
    cell.update(config="moco-tiny", batch=8, profile_steps=1, limits=LIMITS)
    with open(os.path.join(base, "workloads", "moco-tiny.json"), "w") as f:
        json.dump(cell, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="moco-tiny",
                                 file="perfbench/configs/moco-tiny.json"))
    bench["workloads"].append({"name": "moco-tiny", "config": "moco-tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "a CPU test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_a_tiny_moco_cell_is_correct(root):
    line = harness.run("moco-tiny", SEED, 0.3, False, device="cpu",
                       root=root)
    assert line is not None and line["correct"], line and line["checks"]
    assert line["failed"] == 0 and set(line["checks"]) == \
        set(LIMITS) | {"failed_steps"}


def test_the_reference_follows_the_program_and_not_a_fault(root,
                                                           monkeypatch):
    """harness.Program and check.follow as a run takes them: within the
    limits; with the key encoder in eval mode, the loss, the running
    statistics and the key encoder fail them."""
    cell = load_cell("moco-tiny", root)
    readings = {}
    for fault in (False, True):
        prog = harness.Program(cell, SEED, "cpu")
        if fault:
            key = prog.state.extra["key_model"]
            key.train = types.MethodType(
                lambda self, mode=True: torch.nn.Module.train(self, False),
                key)
        warm = prog.warm()
        batches = [prog.batch_of(i) for i in range(harness.WARM_STEPS)]
        ref = check.follow(cell["config"], prog.init, batches, SEED, "cpu")
        readings[fault] = check.compare(warm, ref)
    assert check.judge(readings[False], LIMITS), readings[False]
    for k in ("loss_gap", "stats_gap"):
        assert readings[True][k] > 10 * LIMITS[k], readings[True]


def test_image_flops_against_a_count_by_hand():
    conf = load_cell("moco-b256-graph")["config"]
    ref = cells.reference_module(conf["task"])
    # the 5-level encoder on one 224^2 view: two 3x3 convs a level,
    # 2 * 9 * cin * cout * h * w each
    levels = [(224, 1, 64), (112, 64, 128), (56, 128, 256), (28, 256, 512),
              (14, 512, 1024)]
    forward = sum(2 * 9 * (cin * c + c * c) * h * h for h, cin, c in levels)
    first = 2 * 9 * 1 * 64 * 224 * 224  # the image takes no gradient
    queue = 2 * 1024 * 65536  # q . queue^T, forward and the backward to q
    want = (3 * forward - first) + forward + 2 * queue
    assert ref.image_flops(conf) == pytest.approx(want, rel=1e-12)
    assert 77.7e9 < 3 * forward - first < 77.9e9
    assert 25.9e9 < forward < 26.1e9


def test_span_momentum_ms_reads_the_momentum_span():
    read = cells.metric_reader("span_momentum_ms")
    assert read({"batch": 256}) is None  # no trace
    assert read(_ctx([STEP] * 2)) is None  # a program with no such span
    step = STEP + [(_open("momentum"), 1), ("cudnn_fprop", 12),
                   (_open("norm"), 1), ("reduce_kernel", 3),
                   (_close("norm"), 1), (_close("momentum"), 1)]
    markers = sum(name.startswith("cmx::span_") for name, _ in step)
    assert read(_ctx([step] * 2, per_step=markers)) == pytest.approx(12e-3)
