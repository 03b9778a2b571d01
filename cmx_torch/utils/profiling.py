"""Profiling hooks (port of cmx/utils/profiling.py): a device trace by
torch.profiler in place of jax.profiler, and a step timer that waits for
the device in place of block_until_ready.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], name: str = "trace.json",
          device: Optional[torch.device] = None) -> Iterator[Optional[str]]:
    """Trace the block with torch.profiler (host ops, and the card's
    kernels when `device` is a CUDA device, or, with no device, when a card
    is present) and write a Chrome trace to <log_dir>/<name>, also when the
    block raises; yields that path. A no-op that yields None without a
    log_dir."""
    if not log_dir:
        yield None
        return
    cuda = (device.type == "cuda" if device is not None
            else torch.cuda.is_available())
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(log_dir, name)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield path
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(path)


def _cuda_devices(result: Any) -> set:
    """The CUDA devices of the tensors in a tensor, list, tuple or dict."""
    if torch.is_tensor(result):
        return {result.device} if result.is_cuda else set()
    items = (result.values() if isinstance(result, dict)
             else result if isinstance(result, (list, tuple)) else ())
    return set().union(*(_cuda_devices(r) for r in items))


class StepTimer:
    """Step timer for honest device timings: a measured block ends when the
    devices of its result (tensors, or lists, tuples and dicts of them)
    have finished."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, result_to_block=None):
        """Time the block; `result_to_block` is the result (or a container
        the block fills in) whose devices the timer waits for."""
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            for dev in _cuda_devices(result_to_block):
                torch.cuda.synchronize(dev)
        self.times.append(time.perf_counter() - t0)

    def summary(self, skip_first: int = 1) -> dict:
        ts = (self.times[skip_first:] if len(self.times) > skip_first
              else self.times)
        if not ts:
            return {"mean_s": 0.0, "p50_s": 0.0, "min_s": 0.0}
        ss = sorted(ts)
        return {
            "mean_s": sum(ts) / len(ts),
            "p50_s": ss[len(ss) // 2],
            "min_s": ss[0],
        }
