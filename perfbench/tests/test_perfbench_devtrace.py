"""The idle arithmetic: the union of device intervals, never above the
window."""

import pytest

from perfbench import devtrace
from perfbench.devtrace import Trace


def _trace(kernels, window=(0.0, 100.0), host=()):
    ev = [{"name": devtrace.WINDOW, "cat": "user_annotation",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"name": n, "cat": "kernel", "ts": a, "dur": b - a}
           for n, a, b in kernels]
    ev += [{"name": n, "cat": "cuda_runtime", "ts": a, "dur": b - a}
           for n, a, b in host]
    return Trace(ev, steps=2)


def test_union_merges_overlaps_and_clips():
    assert devtrace.union([(5, 10), (0, 3), (2, 6), (20, 30), (95, 120)],
                          0, 100) == [(0, 10), (20, 30), (95, 100)]


def test_overlapping_kernels_count_once():
    # two streams overlapping completely: the sum of kernels is 160 us in a
    # 100 us window, the busy time 80 us
    tr = _trace([("a", 0, 80), ("b", 0, 80)])
    assert tr.busy_s == pytest.approx(80e-6)
    assert 0.0 <= tr.window_s - tr.busy_s


@pytest.mark.parametrize("kernels", [
    [("a", -50, 150)],
    [("a", 0, 60), ("b", 40, 100), ("c", 10, 90)],
    [],
])
def test_idle_share_stays_in_0_100(kernels):
    tr = _trace(kernels)
    idle = 100 * (tr.window_s - tr.busy_s) / tr.window_s
    assert 0.0 <= idle <= 100.0


def test_ms_per_step_top_ops_and_gaps():
    tr = _trace([("void cmx::k<true>", 0, 30), ("gemm_x", 45, 50),
                 ("void cmx::k<true>", 60, 90)],
                host=[("cudaGraphLaunch", 28, 46),
                      ("cudaEventSynchronize", 85, 99)])
    assert tr.ms_per_step([r"cmx::k"]) == pytest.approx(60e-3 / 2)
    assert tr.ms_per_step([r"nothing"]) is None
    assert tr.top_ops(1) == [["void cmx::k<true>", pytest.approx(60e-6)]]
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["cudaGraphLaunch", "no host range",
                                    "cudaEventSynchronize"]
    assert [g[1] for g in gaps] == pytest.approx([15e-6, 10e-6, 10e-6])
