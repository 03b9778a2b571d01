"""The program's spans in a device trace: the device time of a profiled
step by the span each kernel ran in.

With `train.trace_spans` on, the program launches a marker kernel on the
step's stream where each of its spans opens and where it closes,
`cmx::span_open_<name>` and `cmx::span_close_<name>`
(cmx_torch/csrc/span_marks.cu, cmx_torch/utils/profiling.py), backward
spans included; the step's CUDA graph holds them and replays them with
the step. The markers are paired in time order, as a stack: a kernel
belongs to the innermost span open when it starts, or to none. The markers
themselves are left out of every sum.

The split is read only where it is sound, and never guessed: None without
a trace or a graph report whose `capture_calls` count the markers it holds
(`span_mark`), where the window holds another number of markers than that
count times the profiled steps, where the steps' markers differ (one
graph's replays launch the same ones), or where a step's markers do not
pair (a close that is not the innermost open span's, or a span still open
at the step's last marker).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

MARKER = re.compile(r"cmx::span_(open|close)_(\w+)")


def split(ctx: Dict[str, Any]) -> Optional[Dict[Optional[str], float]]:
    """{span name, or None for no span: device ms a step of the kernels
    whose innermost span it is}, markers left out; None where unsound."""
    tr, graph = ctx.get("trace"), ctx.get("graph")
    if tr is None or not graph:
        return None
    per_step = (graph.get("capture_calls") or {}).get("span_mark")
    if not per_step:
        return None
    kernels = sorted(tr.kernels(), key=lambda e: float(e["ts"]))
    marks = [MARKER.search(e["name"]) for e in kernels]
    if sum(m is not None for m in marks) != per_step * tr.steps:
        return None
    edges = [m.groups() for m in marks if m is not None]
    if any(edges[i] != edges[i % per_step] for i in range(len(edges))):
        return None  # one graph's replays launch the same markers
    out: Dict[Optional[str], float] = {None: 0.0}
    stack = []
    seen = 0
    for e, m in zip(kernels, marks):
        if m is None:
            key = stack[-1] if stack else None
            out[key] = out.get(key, 0.0) + float(e["dur"])
            continue
        edge, name = m.groups()
        if edge == "open":
            stack.append(name)
        elif not stack or stack.pop() != name:
            return None
        seen += 1
        if seen % per_step == 0 and stack:
            return None
    return {k: v * 1e-3 / tr.steps for k, v in out.items()}


def span_ms(ctx: Dict[str, Any], *names: str) -> Optional[float]:
    """Device ms a step of the kernels whose innermost span is one of
    `names`; None where the split is unsound."""
    got = split(ctx)
    return None if got is None else sum(got.get(n, 0.0) for n in names)


def cover_pct(ctx: Dict[str, Any]) -> Optional[float]:
    """The share of a step's kernel time (markers left out) that lies
    inside some span; None where the split is unsound or empty."""
    got = split(ctx)
    if got is None:
        return None
    total = sum(got.values())
    return None if total <= 0 else 100.0 * (total - got[None]) / total
