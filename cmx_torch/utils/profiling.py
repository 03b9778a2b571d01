"""Profiling hooks (port of cmx/utils/profiling.py): a device trace by
torch.profiler in place of jax.profiler, a step timer that waits for the
device in place of block_until_ready, and the program's spans.

Spans name the parts of a train step on the device timeline, where a CUDA
graph's replayed kernels otherwise carry no trace of the code that
captured them. They are off unless the process's switch is on
(`set_spans`; the pretrain CLI's build_task sets it from
`train.trace_spans`, or `train.profile_dir`). `span(name, *tensors)` is
then a host range `cmx.<name>` (torch.profiler.record_function) and, on
the stream of the first CUDA tensor given, a marker kernel of the port's
own where it opens and where it closes (`cmx::span_open_<name>`,
`cmx::span_close_<name>`, csrc/span_marks.cu), which a graph captures and
replays with the step. A span whose work has a backward marks it too:
`sp.inputs(x)` and `sp.outputs(y)` pass the span's input and output
through an identity autograd Function whose backward opens the span where
the output's gradient arrives and closes it where the input's leaves, so
the backward's kernels lie between a second pair of markers; the
gradients pass on unchanged. Autograd's engine runs a device's nodes
latest-made first, so a backward span holds the backward of what its
forward made and nothing else. A kernel belongs to the innermost span
open when it starts. With the switch off, `span` returns one shared
context that does nothing and whose inputs/outputs return the tensor
they are given.

The names, in csrc/span_marks.cu's CMX_SPANS order:
  feed       the StepGraph's row gather from the resident corpus
  views      a task's crops, rotations, blurs, flips, noise and mask draws
  forward    the task's loss_fn, outside narrower spans
  norm       a batch norm's moments, folds and running update (the fused
             DoubleConv's K1/K2 calls whole), forward and backward
  loss       a loss head, forward and backward
  backward   torch.autograd.grad, outside narrower spans
  optimizer  the global gradient norm and the optimizer's update
  guard      the NaN guard's buffer copies and restores, and post_update
  momentum   a momentum network's forward without gradient and the row
             normalisation of its output (MoCo's key encoder; CM-UNet's
             target stays under `forward`)
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import time
from typing import Any, Iterator, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

_spans_on = False  # the process's span switch


def set_spans(on: bool) -> None:
    """Turn the process's spans on or off (off by default). A CUDA graph
    holds the markers of the spans that were on when it was captured."""
    global _spans_on
    _spans_on = bool(on)


def spans_on() -> bool:
    return _spans_on


@functools.lru_cache(maxsize=None)
def span_names() -> Tuple[str, ...]:
    """The span names of csrc/span_marks.cu's CMX_SPANS, in its order."""
    from cmx_torch.ops import _build

    text = (_build.CSRC / "span_marks.cu").read_text()
    body = re.search(r"#define CMX_SPANS\(X\)((?:[^\n]*\\\n)*[^\n]*)", text)
    return tuple(re.findall(r"X\((\w+)\)", body.group(1)))


@functools.lru_cache(maxsize=None)
def _span_lib():
    from cmx_torch.ops import _build

    lib = _build.load("span_marks")
    if lib.cmx_span_count() != len(span_names()):
        raise RuntimeError("cmx_torch: the span library holds "
                           f"{lib.cmx_span_count()} spans, span_names() "
                           f"{len(span_names())}")
    return lib


def span_mark(index: int, close: bool, device: torch.device) -> None:
    """Launch span `index`'s open (or close) marker on the CUDA device
    `device`'s current stream. `span_mark.launches` counts the launches."""
    from cmx_torch.ops import _build

    stream = torch.cuda.current_stream(device).cuda_stream
    err = _span_lib().cmx_span_mark(index, int(close), stream)
    _build.check(err, "span_mark")
    span_mark.launches += 1


span_mark.launches = 0


class _Edge(torch.autograd.Function):
    """Identity on a tensor; its backward calls `edge` (a span's backward
    open or close) and passes the gradient on as it came."""

    @staticmethod
    def forward(ctx, edge, x):
        ctx.edge = edge
        ctx.set_materialize_grads(False)
        return x

    @staticmethod
    def backward(ctx, grad):
        ctx.edge(grad)
        return None, grad


class _NullSpan:
    """What `span` returns with spans off: nothing opens, nothing marks."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def inputs(x):
        return x

    outputs = inputs


_NULL = _NullSpan()


class _Span:
    """One span's forward range and markers, and its backward's."""

    def __init__(self, name: str, tensors: tuple):
        names = span_names()
        if name not in names:
            raise ValueError(f"unknown span {name!r}: one of {names}")
        self.name, self.index = name, names.index(name)
        self.device = next((t.device for t in tensors if t.is_cuda), None)
        self.range = None
        self.closes = False  # whether `inputs` marked a backward close
        self.backward_range = None  # the backward's range, while open

    def _mark(self, close: bool, device: Optional[torch.device]) -> None:
        if device is not None and device.type == "cuda":
            span_mark(self.index, close, device)

    def __enter__(self):
        self.range = torch.profiler.record_function("cmx." + self.name)
        self.range.__enter__()
        self._mark(False, self.device)
        return self

    def __exit__(self, *exc):
        self._mark(True, self.device)
        self.range.__exit__(*exc)
        return False

    def _backward_open(self, grad) -> None:
        self.backward_range = torch.profiler.record_function(
            "cmx." + self.name)
        self.backward_range.__enter__()
        self._mark(False, None if grad is None else grad.device)

    def _backward_close(self, grad) -> None:
        if self.backward_range is None:  # the outputs' gradient never came
            return
        self._mark(True, None if grad is None else grad.device)
        self.backward_range.__exit__(None, None, None)
        self.backward_range = None

    def inputs(self, x: torch.Tensor) -> torch.Tensor:
        """The span's input, marked: the backward closes the span once its
        gradient is made. Call it first in the span."""
        if not (x.requires_grad and torch.is_grad_enabled()):
            return x
        self.closes = True
        return _Edge.apply(self._backward_close, x)

    def outputs(self, y: torch.Tensor) -> torch.Tensor:
        """The span's output, marked: the backward opens the span when its
        gradient arrives. Only a span whose input was marked is."""
        if not (self.closes and y.requires_grad):
            return y
        return _Edge.apply(self._backward_open, y)


def span(name: str, *tensors: torch.Tensor):
    """The span `name` (one of span_names()) around a block, its markers
    on the stream of the first CUDA tensor of `tensors` (none on the CPU);
    with spans off, a shared context that does nothing."""
    if not _spans_on:
        return _NULL
    return _Span(name, tensors)


def host_range(name: str):
    """A host range `cmx.<name>` with spans on (no marker); with spans off,
    the shared context that does nothing."""
    if not _spans_on:
        return _NULL
    return torch.profiler.record_function("cmx." + name)
