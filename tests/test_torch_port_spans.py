"""The program's spans (cmx_torch.utils.profiling.span), held on the CPU.

* Spans on or off, a SparK step (fused bf16 through K1-K3's plain versions
  and unfused norms, reduced widths) and a CM-UNet step (narrow encoder and
  decoders, both necks) give the same loss, gradients, parameters, BN
  buffers, optimizer state and metrics, bit for bit.
* Spans off: `span` returns one shared context, the autograd graph holds no
  span edge, no marker is launched and a profile holds no `cmx.` range.
* Spans on: the profile holds the spans of the step (feed, views, forward,
  norm, loss, backward, optimizer, guard) inside the host range
  `cmx.eager`, each range properly nested, the forward's norms and losses
  inside `cmx.forward` and their backward spans inside `cmx.backward`.
* `train.trace_spans` parses through apply_overrides; build_task sets the
  switch from it, or from `train.profile_dir`.
* StepGraph.report carries the set-up counters (`first_replay_s` None where
  nothing is captured), and `kernel_load_s` is the change of
  `_build.load_seconds` over the first eager step.
The card test in test_torch_port_cuda.py holds the markers of a captured
graph's replays.
"""

import copy
import functools
import time
from collections import Counter

import numpy as np
import pytest
import torch

from cmx_torch.ops import _build
from cmx_torch.ops import fused_conv as tfc
from cmx_torch.train.graph import StepGraph
from cmx_torch.train.state import TrainState
from cmx_torch.train.trainer import make_train_body
from cmx_torch.utils import profiling

WIDTHS, BNECK = (8, 16, 32, 64), 128
STEP_SPANS = {"eager", "feed", "views", "forward", "norm", "loss", "backward",
              "optimizer", "guard"}


@pytest.fixture(autouse=True)
def _spans_restored():
    """Every test leaves the process's span switch as it found it."""
    was = profiling.spans_on()
    yield
    profiling.set_spans(was)


def _imgs(n, size, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, size, size)).astype(
        np.float32) + 1.0)


def _spark(monkeypatch):
    """SparK at reduced widths, fused bf16 at 64^2 (64^2 and 32^2 stages
    through FlatDoubleConv, the rest through MaskedBatchNorm), K3's plain
    version as its loss."""
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer

    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK, fused=True,
                       dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    task, _ = make_spark_task(model, input_size=64, pallas_loss=True)
    tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                        named_params=model.named_parameters())
    return TrainState.create(model=model, tx=tx, seed=3), task, tx, \
        _imgs(6, 64, 0)


def _cmunet(monkeypatch):
    """CM-UNet with a narrow encoder and decoders (the bottleneck keeps its
    1024 channels, the reduce kernel's input), 32^2 views, AdamW."""
    import cmx_torch.ssl.cmunet as cm
    from cmx_torch.models.unet import UNetDecoder, UNetEncoder
    from cmx_torch.train.optim import make_optimizer

    monkeypatch.setattr(cm, "UNetEncoder", functools.partial(
        UNetEncoder, WIDTHS))
    monkeypatch.setattr(cm, "UNetDecoder", functools.partial(
        UNetDecoder, widths=WIDTHS))
    model = cm.CMUNetOnline(torch.float32, 32)
    model.reset_parameters(torch.Generator().manual_seed(4))
    task, _ = cm.make_cmunet_task(model, view_size=32)
    tx = make_optimizer("adamw", 1e-3, 0.05, clip_norm=5.0,
                        named_params=model.named_parameters())
    extra = task.init_extra(torch.Generator().manual_seed(5))
    return TrainState.create(model=model, tx=tx, seed=9, extra=extra), \
        task, tx, _imgs(6, 48, 3)


TASKS = {"spark": _spark, "cmunet": _cmunet}
IDXS = [torch.tensor([2, 0, 3, 1]), torch.tensor([5, 1, 4, 0])]


def _tensors(state):
    out = {f"model/{n}": t for n, t in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"opt/{k}/{i}"] = t
    for k, v in (state.extra or {}).items():
        if isinstance(v, torch.nn.Module):
            out.update({f"extra/{k}/{n}": t
                        for n, t in v.state_dict().items()})
        else:
            out[f"extra/{k}"] = v
    return out


def _loss_and_grads(state, task, tx, corpus):
    gen = torch.Generator().manual_seed(state.step_seed())
    loss, _ = task.loss_fn(state.model, corpus.index_select(0, IDXS[0]), gen,
                           None, state.extra)
    grads = torch.autograd.grad(loss, tx.params, allow_unused=True)
    return loss, grads


def _steps(state, task, tx, corpus):
    graph = StepGraph(make_train_body(task, tx),
                      lambda idx: corpus.index_select(0, idx), "cpu")
    return torch.stack([graph.step(state, idx) for idx in IDXS]), graph


def _edges(fn):
    """The span edges in the autograd graph below `fn`."""
    seen, todo, found = set(), [fn], 0
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        found += type(node).__name__ == "_EdgeBackward"
        todo += [n for n, _ in node.next_functions]
    return found


@pytest.mark.parametrize("task", sorted(TASKS))
def test_spans_leave_the_step_bit_for_bit(task, monkeypatch):
    """Loss and gradients of one loss_fn, then two StepGraph steps (the
    gather, the body, the guard): every parameter, BN buffer, optimizer
    state, `extra` tensor and metric, spans off against spans on."""
    state, t, tx, corpus = TASKS[task](monkeypatch)
    runs = []
    for on in (False, True):
        profiling.set_spans(on)
        s = copy.deepcopy(state)
        s_tx = s.opt
        loss, grads = _loss_and_grads(s, t, s_tx, corpus)
        assert (_edges(loss.grad_fn) > 0) == on
        rows, _ = _steps(s, t, s_tx, corpus)
        runs.append((loss, grads, rows, _tensors(s)))
    (l0, g0, r0, t0), (l1, g1, r1, t1) = runs
    assert torch.equal(l0, l1)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(g0, g1))
    assert torch.equal(r0, r1)
    assert list(t0) == list(t1)
    for n, v in t0.items():
        assert torch.equal(v, t1[n]), n


def _profiled_steps(task, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    state, t, tx, corpus = TASKS[task](monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(state, t, tx, corpus)
    return [(e.name[4:], e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("cmx.")]


def test_spans_off_open_nothing_and_launch_nothing(monkeypatch):
    profiling.set_spans(False)
    assert profiling.span("norm") is profiling.span("loss")
    assert profiling.host_range("eager") is profiling.span("norm")
    x = torch.ones(3, requires_grad=True)
    with profiling.span("norm", x) as sp:
        assert sp.inputs(x) is x and sp.outputs(x) is x
    n0 = profiling.span_mark.launches
    assert _profiled_steps("spark", monkeypatch) == []
    assert profiling.span_mark.launches == n0


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and outer != inner


@pytest.mark.parametrize("task,losses", [("spark", 1), ("cmunet", 2)])
def test_spans_on_name_the_step_nested(task, monkeypatch, losses):
    """Per step: one `cmx.eager` holding every span; the spans of the
    table, `views` inside `forward`, each loss span once inside `forward`
    and once inside `backward`, norms in both; on each thread the ranges
    nest (none overlaps another in part); no marker on the CPU."""
    profiling.set_spans(True)
    n0 = profiling.span_mark.launches
    ranges = _profiled_steps(task, monkeypatch)
    assert profiling.span_mark.launches == n0
    assert {r[0] for r in ranges} == STEP_SPANS
    for a in ranges:
        for b in ranges:
            if a[3] == b[3] and a is not b:
                assert (a[2] <= b[1] or b[2] <= a[1] or _inside(a, b)
                        or _inside(b, a)), (a, b)
    count = Counter(r[0] for r in ranges)
    assert count["eager"] == len(IDXS)
    eager = [r for r in ranges if r[0] == "eager"]
    assert all(any(_inside(e, r) for e in eager)
               for r in ranges if r[0] != "eager")
    for name in ("forward", "backward", "feed", "views", "optimizer"):
        assert count[name] == len(IDXS), name
    assert count["guard"] == 2 * len(IDXS)

    def within(name, outer):
        return [r for r in ranges if r[0] == name
                and any(_inside(o, r) for o in ranges if o[0] == outer)]

    assert len(within("views", "forward")) == len(IDXS)
    assert len(within("loss", "forward")) == losses * len(IDXS)
    assert len(within("loss", "backward")) == losses * len(IDXS)
    fwd, bwd = within("norm", "forward"), within("norm", "backward")
    assert fwd and bwd and len(fwd) + len(bwd) == count["norm"]
    for name in ("optimizer", "guard", "feed"):
        assert not within(name, "forward") and not within(name, "backward")


def test_trace_spans_key_and_profile_dir_set_the_switch(monkeypatch):
    import cmx_torch.ssl.spark as sp
    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.config.config import Config, apply_overrides

    monkeypatch.setattr(sp, "SparKModel", functools.partial(
        sp.SparKModel, widths=WIDTHS, bottleneck_width=BNECK))
    cfg = Config()
    cfg.task.name = "spark"
    assert cfg.train.trace_spans is False
    for overrides, on in ([], False), (["train.trace_spans=True"], True), \
            (["train.trace_spans=False", "train.profile_dir=prof"], True), \
            (["train.profile_dir="], False):
        apply_overrides(cfg, overrides)
        build_task(cfg, torch.float32, "cpu")
        assert profiling.spans_on() is on, overrides


def test_step_graph_reports_its_set_up_counters(monkeypatch):
    """On the CPU every step is eager: eager_s is the first step's seconds,
    kernel_load_s what _build.load spent during it (a fake library load of
    50 ms here), first_replay_s None."""
    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def slow_build_all():
        time.sleep(0.05)
        return {"span_marks": "fake.so"}

    monkeypatch.setattr(_build, "build_all", slow_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.delitem(_build._libs, "span_marks", raising=False)
    loaded0 = _build.load_seconds

    def body(state, batch, gen):
        _build.load("span_marks")
        return {"loss": batch.sum()}

    graph = StepGraph(body, lambda idx: idx.float(), "cpu")
    state = TrainState(step=0, model=None, opt=None, seed=1)
    for idx in IDXS:
        graph.step(state, idx)
    monkeypatch.delitem(_build._libs, "span_marks")
    rep = graph.report
    assert _build.load_seconds - loaded0 == pytest.approx(
        rep["kernel_load_s"])
    assert 0.05 <= rep["kernel_load_s"] <= rep["eager_s"]
    assert rep["first_replay_s"] is None and rep["capture_s"] is None
    assert rep["eager_steps"] == len(IDXS) and rep["replays"] == 0


def test_span_names_are_the_csrc_list_and_unknown_names_raise():
    assert profiling.span_names() == (
        "feed", "views", "forward", "norm", "loss", "backward", "optimizer",
        "guard", "momentum")
    profiling.set_spans(True)
    with pytest.raises(ValueError, match="unknown span"):
        profiling.span("nowhere")


def test_chip_smoke_busy_time_counts_overlapping_kernels_once():
    """chip_smoke.py's busy ms a step: the union of the device intervals
    (two kernels overlapping completely count once; host events none)."""
    import importlib.util
    import pathlib
    import types

    from torch.autograd import DeviceType

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_busy", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    def ev(a, b, dev=DeviceType.CUDA):
        return types.SimpleNamespace(
            time_range=types.SimpleNamespace(start=a, end=b), device_type=dev)

    prof = types.SimpleNamespace(events=lambda: [
        ev(0, 80), ev(0, 80), ev(100, 150), ev(140, 160), ev(155, 158),
        ev(10, 500, DeviceType.CPU)])
    assert smoke.busy_ms_a_step(prof, 2) == pytest.approx((80 + 60) / 2e3)
