"""perfbench/spans.py on synthetic traces: each kernel goes to its innermost
span, step by step; the readers' sums with the kernels outside every span
make the step's kernel time; unpaired or missing markers give None."""

import pytest

from perfbench import cells, devtrace, spans
from perfbench.devtrace import Trace

SPAN_METRICS = ["span_views_ms", "span_norm_ms", "span_loss_ms",
                "span_optimizer_ms", "span_guard_ms", "span_model_ms"]


def _open(name):
    return f"cmx::span_open_{name}()"


def _close(name):
    return f"cmx::span_close_{name}()"


# one step: (kernel name, us); spans nest as the program's do
STEP = [(_open("feed"), 1), ("indexSelectLargeIndex", 4), (_close("feed"), 1),
        (_open("forward"), 1),
        (_open("views"), 1), ("crop_kernel", 6), (_close("views"), 1),
        ("cudnn_fprop", 20),
        (_open("norm"), 1), ("reduce_kernel", 8), ("elementwise_kernel", 5),
        (_close("norm"), 1),
        ("elementwise_kernel relu", 2),
        (_open("loss"), 1), ("softmax", 3), (_close("loss"), 1),
        (_close("forward"), 1),
        (_open("backward"), 1),
        (_open("loss"), 1), ("softmax_bwd", 4), (_close("loss"), 1),
        (_open("norm"), 1), ("reduce_kernel", 9), (_close("norm"), 1),
        ("cudnn_dgrad", 30),
        (_close("backward"), 1),
        (_open("optimizer"), 1), ("multi_tensor_apply_kernel", 7),
        (_close("optimizer"), 1),
        (_open("guard"), 1), ("copy_kernel", 2), (_close("guard"), 1),
        ("stack_metrics", 1)]                       # the host's metrics row
MARKERS = sum(name.startswith("cmx::span_") for name, _ in STEP)
EXPECT = {None: 1, "feed": 4, "views": 6, "forward": 22, "norm": 22,
          "loss": 7, "backward": 30, "optimizer": 7, "guard": 2}


def _trace(steps_of_kernels, window=None):
    ev, t = [], 10.0
    for kernels in steps_of_kernels:
        for name, us in kernels:
            ev.append({"name": name, "cat": "kernel", "ts": t, "dur": us})
            t += us + 0.5
    lo, hi = window or (0.0, t + 10.0)
    ev.append({"name": devtrace.WINDOW, "cat": "user_annotation", "ts": lo,
               "dur": hi - lo})
    return Trace(ev, steps=len(steps_of_kernels))


def _ctx(steps_of_kernels, per_step=MARKERS, **kw):
    return {"trace": _trace(steps_of_kernels, **kw),
            "graph": {"capture_calls": {"span_mark": per_step}}}


def test_kernels_go_to_their_innermost_span_in_each_of_three_steps():
    ctx = _ctx([STEP] * 3)
    got = spans.split(ctx)
    assert got == pytest.approx({k: v * 1e-3 for k, v in EXPECT.items()})
    assert spans.span_ms(ctx, "forward", "backward", "feed") == \
        pytest.approx((22 + 30 + 4) * 1e-3)


def test_the_readers_add_up_to_the_step_kernel_time():
    ctx = _ctx([STEP] * 3)
    got = cells.read_metrics(
        [{"name": n, "unit": "ms"} for n in SPAN_METRICS + ["span_cover_pct"]],
        ctx)
    total = sum(us for name, us in STEP if not name.startswith("cmx::span_"))
    outside = EXPECT[None]
    assert sum(got[n]["value"] for n in SPAN_METRICS) + outside * 1e-3 == \
        pytest.approx(total * 1e-3)
    assert got["span_cover_pct"]["value"] == pytest.approx(
        100 * (total - outside) / total)


@pytest.mark.parametrize("broken", [
    "a close that is not the innermost span's",
    "a span left open at the step's end",
    "steps that differ in their markers",
    "a marker lost",
    "the graph's count differs",
    "no graph",
    "no trace",
])
def test_unpaired_or_missing_markers_give_none(broken):
    steps = [list(STEP) for _ in range(3)]
    per_step = MARKERS
    if broken.startswith("a close"):
        i = steps[1].index((_close("norm"), 1))
        j = steps[1].index((_close("forward"), 1))
        steps[1][i], steps[1][j] = steps[1][j], steps[1][i]
    elif broken.startswith("a span left"):
        # the window's count holds: the close comes two steps late
        steps[0].remove((_close("guard"), 1))
        steps[2].append((_close("guard"), 1))
    elif broken.startswith("steps that differ"):
        i = steps[1].index((_open("loss"), 1))
        steps[1][i:i + 3] = [(_open("norm"), 1), ("softmax", 3),
                             (_close("norm"), 1)]
    elif broken == "a marker lost":
        steps[2].remove((_open("loss"), 1))
    elif broken.startswith("the graph"):
        per_step += 2
    ctx = _ctx(steps, per_step)
    if broken == "no graph":
        ctx["graph"] = None
    elif broken == "no trace":
        ctx["trace"] = None
    assert spans.split(ctx) is None
    assert spans.span_ms(ctx, "norm") is None
    assert spans.cover_pct(ctx) is None
    for n in SPAN_METRICS:
        assert cells.metric_reader(n)(ctx) is None


def test_a_graph_without_markers_reads_nothing():
    """The parent's graph, or a cell with spans off: no span_mark count."""
    ctx = _ctx([[("cudnn_fprop", 20)]] * 3)
    ctx["graph"] = {"capture_calls": {"flat_bwd_mega": 4}}
    assert spans.split(ctx) is None


@pytest.mark.parametrize("metric,key", [("eager_step_s", "eager_s"),
                                        ("kernel_load_s", "kernel_load_s"),
                                        ("first_replay_s", "first_replay_s")])
def test_set_up_counters_read_the_graph_report(metric, key):
    read = cells.metric_reader(metric)
    assert read({"graph": {key: 1.25}}) == 1.25
    assert read({"graph": {"capture_s": 2.0}}) is None  # the parent's report
    assert read({"graph": None}) is None
