"""What a traced run reads from torch.profiler's trace of a few steady
steps: the device's intervals, its busy and idle time in the window, the
device time of kernels by name, and the longest idle gaps with what the
host was doing in each.

The window is the host range "perfbench.window" that opens and closes on
a device synchronise. Busy time is the union of every kernel, memcpy and
memset interval inside it, so kernels that overlap count once and the idle
share never passes 100% or falls below 0.
"""

from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "perfbench.window"

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The merged intervals, clipped to [lo, hi], in order."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Trace:
    """A Chrome trace (times in microseconds) reduced to the window."""

    def __init__(self, events: List[dict], steps: int):
        self.steps = steps
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace has no {WINDOW!r} range")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and "dur" in e and e.get("name") != WINDOW]
        self.busy = union(((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in self.device), self.lo, self.hi)

    @classmethod
    def load(cls, path: str, steps: int) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, steps)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e.get("cat") == "kernel"
                and self.lo <= float(e["ts"]) <= self.hi]

    def ms_per_step(self, patterns: Iterable[str],
                    exclude: Iterable[str] = ()) -> Optional[float]:
        """Device ms a step of the kernels whose name matches any regular
        expression of `patterns` and none of `exclude`; None when none ran."""
        inc = [re.compile(p) for p in patterns]
        exc = [re.compile(p) for p in exclude]
        hits = [float(e["dur"]) for e in self.kernels()
                if any(p.search(e["name"]) for p in inc)
                and not any(p.search(e["name"]) for p in exc)]
        if not hits:
            return None
        return sum(hits) * 1e-3 / self.steps

    def top_ops(self, n: int = 10, width: int = 160) -> List[list]:
        """[[name, seconds]] of the device operations that took most time
        in the window, summed over the profiled steps; names cut to
        `width` characters (a kernel's template arguments run to
        hundreds)."""
        by: Dict[str, float] = {}
        for e in self.device:
            if self.lo <= float(e["ts"]) <= self.hi:
                key = e["name"][:width]
                by[key] = by.get(key, 0.0) + float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])][:n]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """[[what the host was doing, seconds]] of the longest gaps in
        the window with nothing on the device. The host's activity is the
        innermost host range open at the gap's start."""
        edges = [self.lo] + [x for ab in self.busy for x in ab] + [self.hi]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            open_ = [e for e in self.host
                     if float(e["ts"]) <= a < float(e["ts"]) + float(e["dur"])]
            what = (max(open_, key=lambda e: float(e["ts"]))["name"]
                    if open_ else "no host range")
            out.append([what, (b - a) * 1e-6])
        return out
