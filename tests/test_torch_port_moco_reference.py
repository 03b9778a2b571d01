"""The port's MoCo v2 train step against the benchmark's plain reference
(perfbench/reference/moco.py), on the CPU in float32.

The program is built as the benchmark builds it (perfbench.harness.Program:
the pretrain CLI's build_task, the preset's SGD, the reference's weights
with the key encoder drawn apart and a queue of unit rows), at encoder
widths 8-128, 48^2 images cut to 32^2 views, batch 8, a queue of 64 x 128,
K4's plain version as the crop, and three eager steps; the reference takes
the same weights, batches and step seeds. After each step the two are held
to each other in the loss, the gradients (read from SGD's trace as the
benchmark reads them), the parameters after the update, both encoders'
running statistics, the key encoder's EMA, and the queue's rows and its
pointer. The benchmark's own comparison (perfbench/check.py) never reads
the queue, so this test is its only guard.

Tolerances: both sides compute in float32 and differ in the order of their
sums (the program's one-pass shifted batch-norm moments against the
reference's two-pass ones, the crop's products, the convolutions'
algorithms), about 1e-6 of a value: the loss, both encoders' running
statistics and the queue's rows, which the forwards alone make, are held
to 1e-5 and 1e-4. The backward is not continuous in the forward's values:
a 2x2 max-pool window whose two largest entries lie within rounding of
each other sends its gradient to one or the other, and at these widths one
window at the 4x4 level carries a few percent of every gradient below it
(5.5% measured here, between two runs of the reference itself on one and
on two threads). So the gradients, and each parameter's and key
parameter's change from the initial weights (the SGD update and the EMA,
which carry the gradients), are held to 10%: each leaf by the norm of its
difference over the larger of its norm and the median leaf's, as
perfbench/check.py holds them, since a conv bias that feeds a batch norm
has a gradient of zero to rounding and moves from zero by rounding. The
pointer is exact. A planted fault, the key encoder run in eval mode (its
running statistics in place of the batch's), reads tens of times over
every bound. Spans on and off give the same numbers, bit for bit.
"""

import functools
import statistics
import types

import pytest
import torch

from perfbench import cells, harness
from perfbench.reference import moco as ref_moco
from perfbench.reference.draws import step_generator
from perfbench.reference.nn import set_fp32_math

WIDTHS, BNECK = (8, 16, 32, 64), 128
SEED = 2 ** 31 + 23  # more than 32 signed bits hold
STEPS = 3
TINY = {"data.image_size": 48, "task.view_size": 32, "model.dtype": "float32",
        "train.batch_size": 8, "task.num_negatives": 64}

LOSS_TOL = 1e-5  # the order of sums: ~5e-7 read here
FORWARD_TOL = 1e-4  # running statistics, queue rows: ~4e-6 read here
BACKWARD_TOL = 0.1  # gradients, updates, EMA: one max-pool window's share


@pytest.fixture(scope="module", autouse=True)
def _narrow():
    """The program's MoCo encoder at the test's widths on two threads, and
    the span switch and the thread count restored, for the module's
    tests."""
    import cmx_torch.models.unet as unet
    from cmx_torch.utils import profiling

    was, threads = profiling.spans_on(), torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet, "UNetEncoderGAP", functools.partial(
            unet.UNetEncoderGAP, widths=WIDTHS, bottleneck=BNECK))
        yield
    profiling.set_spans(was)
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def spans_off():
    """The program with spans off, after each step, and the reference's
    readings beside it."""
    prog, got = _program({"train.trace_spans": False})
    return prog, got, _reference(prog)


def _cell(overrides=None):
    cfg = cells.load_json(f"{cells.ROOT}/perfbench/configs/moco-unet224.json")
    cfg["settings"].update(TINY, **(overrides or {}))
    cfg.update(widths=list(WIDTHS), bottleneck_width=BNECK,
               corpus_images=16)
    cfg["steps_per_epoch"] = 2
    return {"config": cfg, "workload": {"batch": 8, "runner": "eager"}}


def _program(overrides=None, fault=None):
    """(the program, after each of its steps: loss, gradients, parameters,
    statistics, key parameters, queue and pointer)."""
    prog = harness.Program(_cell(overrides), SEED, "cpu")
    extra = prog.state.extra
    if fault is not None:
        fault(extra)
    names = [n for n, _ in prog.model.named_parameters()]
    prev, out = None, []
    for i in range(STEPS):
        before = harness.sgd_before(prog.tx)
        loss = float(prog.step(i)["loss"])
        trace = [t.detach().clone() for t in prog.tx.trace]
        grads = harness.sgd_gradients(prog.tx, trace, prev, before)
        prev = trace
        out.append({
            "loss": loss, "grads": dict(zip(names, grads)),
            "params": {n: p.detach().clone()
                       for n, p in prog.model.named_parameters()},
            "stats": {n: b.clone() for n, b in prog.named_stats().items()},
            "target": {n: p.clone() for n, p in
                       extra["key_model"].named_parameters()},
            "queue": extra["queue"].clone(),
            "ptr": int(extra["queue_ptr"])})
    return prog, _moved(out, prog.init)


def _reference(prog):
    """The reference from the program's initial weights, on its batches:
    after each step, what `_program` reads."""
    set_fp32_math()
    init = prog.init
    step = ref_moco.Step(_cell()["config"], init["params"], init["stats"],
                         init["extra"], "fp32")
    out = []
    for i in range(STEPS):
        loss, grads, new_stats = step.loss_and_grads(
            prog.batch_of(i), step_generator("cpu", SEED, i))
        step.opt.step(step.params, grads)
        step.commit(new_stats)
        params, stats = step.state()
        out.append({"loss": float(loss),
                    "grads": {k: g.detach() for k, g in grads.items()},
                    "params": {k: v.clone() for k, v in params.items()},
                    "stats": stats,
                    "target": dict(step.targets()),
                    "queue": step.queue.clone(), "ptr": step.ptr})
    return _moved(out, init)


def _moved(steps, init):
    """Each step's parameters and key parameters as their change from the
    initial weights: a bias starts at zero, so its own size is rounding."""
    for s in steps:
        s["params"] = {k: v - init["params"][k]
                       for k, v in s["params"].items()}
        s["target"] = {k: v - init["extra"]["target." + k]
                       for k, v in s["target"].items()}
    return steps


def _leaf_gaps(got, want):
    """Each leaf's norm of the difference over max(its norm, the median
    leaf's norm)."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in want.items()}
    floor = statistics.median(norms.values())
    return {k: float(torch.linalg.vector_norm(got[k] - want[k]))
            / max(norms[k], floor, 1e-30) for k in want}


def _rel(got, want):
    """Each leaf's largest difference over its largest magnitude."""
    return {k: float((got[k] - want[k]).abs().max())
            / max(float(want[k].abs().max()), 1e-30) for k in want}


def _worst(prog_steps, ref_steps):
    """By quantity, the worst reading over the steps."""
    worst = {}

    def keep(name, value):
        worst[name] = max(worst.get(name, 0.0), value)

    for got, want in zip(prog_steps, ref_steps):
        assert set(got["grads"]) == set(want["grads"])
        assert set(got["stats"]) == set(want["stats"])
        keep("loss", abs(got["loss"] - want["loss"]) / abs(want["loss"]))
        for k in ("grads", "params", "target"):
            keep(k, max(_leaf_gaps(got[k], want[k]).values()))
        keep("stats", max(_rel(got["stats"], want["stats"]).values()))
        keep("queue", _rel({"q": got["queue"]}, {"q": want["queue"]})["q"])
        keep("ptr", abs(got["ptr"] - want["ptr"]))
    return worst


BOUNDS = {"loss": LOSS_TOL, "stats": FORWARD_TOL, "queue": FORWARD_TOL,
          "grads": BACKWARD_TOL, "params": BACKWARD_TOL,
          "target": BACKWARD_TOL, "ptr": 0}


def test_the_port_follows_the_reference_step_by_step(spans_off):
    prog, got, want = spans_off
    assert [s["ptr"] for s in got] == [8, 16, 24]
    # the rows past the pointer are the initial queue's, on both sides
    assert torch.equal(got[-1]["queue"][24:], prog.init["extra"]["queue"][24:])
    worst = _worst(got, want)
    assert all(worst[k] <= BOUNDS[k] for k in BOUNDS), worst


def _key_encoder_in_eval(extra):
    """The planted fault: the key encoder's train() leaves it in eval
    mode, so its keys come from its running statistics."""
    key = extra["key_model"]
    key.train = types.MethodType(
        lambda self, mode=True: torch.nn.Module.train(self, False), key)


def test_a_key_encoder_in_eval_mode_fails_the_comparison():
    prog, got = _program(fault=_key_encoder_in_eval)
    worst = _worst(got, _reference(prog))
    for k in ("loss", "stats", "queue", "grads", "params", "target"):
        assert worst[k] > 5 * BOUNDS[k], (k, worst)


def test_spans_on_and_off_give_the_same_step(spans_off):
    _, on = _program({"train.trace_spans": True})
    _, off, _ = spans_off
    for a, b in zip(on, off):
        assert a["loss"] == b["loss"] and a["ptr"] == b["ptr"]
        assert torch.equal(a["queue"], b["queue"])
        for k in ("grads", "params", "stats", "target"):
            for n in b[k]:
                assert torch.equal(a[k][n], b[k][n]), (k, n)
