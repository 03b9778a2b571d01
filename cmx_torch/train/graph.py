"""Train steps replayed from one CUDA graph: the port's counterpart of cmx's
`train.scan` (cmx/cli/pretrain.py:127-163 `make_device_feed`'s scan_run,
cmx/train/harness.py:195-285 `_fit_scan`).

cmx compiles a segment of steps -- the batch's row gather and the train
step -- into one `lax.scan` device program: one host dispatch for many
steps. `StepGraph` gives one process on a card the same, one host dispatch
a step:
  * the first step of a run runs eagerly: a real step, which also fills
    every lazy cache (kernel builds and shared-memory attributes, tables
    moved to the device, cuBLAS/cuDNN handles, NCCL's communicator);
  * the second is captured as a CUDA graph -- the gather from a static
    index buffer, then the trainer's body (train/trainer.py) -- in a
    private memory pool, and replayed;
  * every later step copies its indices into the static buffer, re-seeds
    the run's generator from (seed, step) and replays the graph; its
    metrics are copied out of the graph's tensors on the device.
On the CPU every step runs the same gather and body eagerly, and so on a
card under a gloo group (`mesh.backend()`): gloo stages every collective
through the host, which no graph can capture.

The graph holds the addresses of everything the step reads and writes:
parameters, optimizer state, BN buffers, the task's `extra`, the gathered
corpus. Whatever changes them between replays copies into them in place
(the checkpoint restore, the validation's buffer restore and the
fine-tune's best-state copies do); a resumed run captures after its
restore.

Draws: one generator for the run, registered with the graph and re-seeded
from `TrainState.step_seed()` before every step. Re-seeding resets the
Philox offset to 0, and a replay reads the generator's seed and offset when
it is launched, so a step draws what `TrainState.step_generator` gives the
eager step.

A capture that fails raises `GraphCaptureError`, naming the operation that
broke it; nothing falls back to eager steps on the card. The capture runs
under torch.cuda.set_sync_debug_mode("error"), so a host synchronisation
(or a copy from pageable host memory) raises where it is made.

Launch accounting: a kernel wrapper counts its launches when it is called,
so its count sees the eager steps and the capture, never a replay. Each
graph's report (`StepGraph.report`, also appended to `REPORTS`) holds the
wrapper calls made during its capture (`capture_calls`; with spans on,
`span_mark` counts the span markers the graph holds, and
`library_conv_channels_last` / `library_conv_channels_first` count its
library convolutions by layout), the collectives it
captured (`capture_collectives`, from `mesh.counts`), its `replays`, its
`eager_steps`, `capture_s` and the bytes its pool holds: a kernel ran
eager calls + capture_calls x replays times.

Set-up counters, in the report too: `eager_s`, the first eager step, ended
on a device synchronise; `kernel_load_s`, the seconds cmx_torch.ops._build
spent building and loading kernel libraries during it; `first_replay_s`,
the first replay, ended on a synchronise (None where nothing is captured).
Each costs one synchronise, once. With spans on (cmx_torch.utils.profiling)
the gather is the span `feed`, and the host ranges `cmx.eager`,
`cmx.capture` and `cmx.replay` hold each step's host work.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List

import torch

from cmx_torch.ops import _build
from cmx_torch.parallel import mesh
from cmx_torch.train.state import TrainState
from cmx_torch.utils import profiling

REPORTS: List[Dict[str, Any]] = []  # every captured graph's report
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A train step that a CUDA graph could not capture."""


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the wrapper's name, the
    library convolution calls by layout (`library_conv_channels_last`,
    `library_conv_channels_first`) and the 4-D batch norms by path
    (`norm_kernel_channels_last`, `norm_kernel_channels_first`,
    `norm_plain`: cmx_torch.models.blocks)."""
    from cmx_torch.models import blocks
    from cmx_torch.ops import (batch_norm, fused_conv, fused_conv_flat,
                               pallas_crop, pallas_ops)

    fns = (fused_conv_flat.flat_conv3x3_mask_stats,
           fused_conv_flat.flat_bwd_mega, pallas_ops.spark_loss_pallas,
           pallas_ops.spark_loss_bwd, pallas_crop.crop_resize_pallas,
           pallas_ops.bn_relu_mask_pallas, fused_conv.conv_stem_stats,
           fused_conv.conv3x3_mask_stats, fused_conv.bwd_mega,
           *batch_norm.WRAPPERS, profiling.span_mark)
    return {**{fn.__name__: fn.launches for fn in fns},
            **blocks.LIBRARY_CONV_CALLS, **blocks.NORM_CALLS}


def _culprit(exc: BaseException) -> str:
    """Where a failed capture broke: the innermost frame of the port below
    the runner in the first exception of the chain, and its message."""
    first = exc
    while first.__context__ is not None:
        first = first.__context__
    frames = traceback.extract_tb(first.__traceback__)
    here = os.path.abspath(__file__)
    ours = [f for f in frames if os.path.abspath(f.filename).startswith(_PKG)
            and os.path.abspath(f.filename) != here]
    where = (ours or frames or [None])[-1]
    at = (f"{where.filename}:{where.lineno} in {where.name}: {where.line}"
          if where is not None else "an unknown operation")
    return f"{at} ({type(first).__name__}: {first})"


class StepGraph:
    """Steps of one shape: `gather(idx)` makes the batch from resident
    tensors, `body(state, batch, gen)` runs the step (make_train_body's).
    `step(state, idx)` runs one step and returns its metrics as one fp32
    row (names in `names`); `run(state, idxs)` runs idxs.shape[0] steps and
    returns each metric stacked (s,), on the device."""

    def __init__(self, body: Callable, gather: Callable, device,
                 label: str = "step"):
        self.body, self.gather = body, gather
        self.device = torch.device(device)
        # whether steps after the first replay a graph: on a card, unless
        # the scope's group is gloo's
        self.captures = (self.device.type == "cuda"
                         and mesh.backend() != "gloo")
        self.gen = torch.Generator(device=self.device)
        self.graph = None
        self.static_idx = None
        self.static_metrics = None
        self.names: List[str] = []
        self.report: Dict[str, Any] = {
            "label": label, "eager_steps": 0, "replays": 0,
            "capture_calls": {}, "capture_collectives": {},
            "capture_s": None, "pool_bytes": None,
            "eager_s": None, "kernel_load_s": None, "first_replay_s": None}

    def _row(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.names:
            self.names = list(metrics)
        return torch.stack([metrics[k].float() for k in self.names])

    def _eager(self, state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        first = not self.report["eager_steps"]
        t0, load0 = time.perf_counter(), _build.load_seconds
        with profiling.host_range("eager"):
            self.gen.manual_seed(state.step_seed())
            with profiling.span("feed", idx):
                batch = self.gather(idx)
            metrics = self.body(state, batch, self.gen)
            state.step += 1
            self.report["eager_steps"] += 1
            row = self._row(metrics)
        if first:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.report["eager_s"] = time.perf_counter() - t0
            self.report["kernel_load_s"] = _build.load_seconds - load0
        return row

    def _capture(self, state: TrainState, idx: torch.Tensor) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # the warm-up's blocks, for the pool
        free0 = torch.cuda.mem_get_info(self.device)[0]
        self.static_idx = idx.clone()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        self.gen.manual_seed(state.step_seed())
        before, collectives = launch_counts(), dict(mesh.counts)
        mode = torch.cuda.get_sync_debug_mode()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    with profiling.span("feed", self.static_idx):
                        batch = self.gather(self.static_idx)
                    self.static_metrics = self.body(state, batch, self.gen)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
        except Exception as e:  # named, then raised: no eager fallback
            raise GraphCaptureError(
                f"cannot capture the {self.report['label']} step as a CUDA "
                f"graph: {_culprit(e)}") from e
        torch.cuda.synchronize(self.device)
        self.report["capture_s"] = time.perf_counter() - t0
        after = launch_counts()
        self.report["capture_calls"] = {
            k: after[k] - before[k] for k in after if after[k] != before[k]}
        self.report["capture_collectives"] = {
            k: v - collectives.get(k, 0) for k, v in mesh.counts.items()
            if v != collectives.get(k, 0)}
        self.report["pool_bytes"] = free0 - torch.cuda.mem_get_info(
            self.device)[0]
        self.graph = graph
        REPORTS.append(self.report)

    def step(self, state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        if not self.captures or not self.report["eager_steps"]:
            return self._eager(state, idx)
        if self.graph is None:
            with profiling.host_range("capture"):
                self._capture(state, idx)
        elif idx.shape != self.static_idx.shape:
            raise ValueError(f"the {self.report['label']} graph was captured "
                             f"for indices {tuple(self.static_idx.shape)}, "
                             f"not {tuple(idx.shape)}")
        first = not self.report["replays"]
        t0 = time.perf_counter()
        with profiling.host_range("replay"):
            self.static_idx.copy_(idx)
            self.gen.manual_seed(state.step_seed())
            self.graph.replay()
            state.step += 1
            self.report["replays"] += 1
            row = self._row(self.static_metrics)
        if first:
            torch.cuda.synchronize(self.device)
            self.report["first_replay_s"] = time.perf_counter() - t0
        return row

    def run(self, state: TrainState, idxs: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        cols = torch.stack([self.step(state, idx) for idx in idxs]).t()
        return dict(zip(self.names, cols.contiguous()))
