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
On the CPU every step runs the same gather and body eagerly.

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
wrapper calls made during its capture (`capture_calls`), its `replays`,
its `eager_steps`, `capture_s` and the bytes its pool holds: a kernel ran
eager calls + capture_calls x replays times.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Callable, Dict, List

import torch

from cmx_torch.train.state import TrainState

REPORTS: List[Dict[str, Any]] = []  # every captured graph's report
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class GraphCaptureError(RuntimeError):
    """A train step that a CUDA graph could not capture."""


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, by the wrapper's name."""
    from cmx_torch.ops import (fused_conv, fused_conv_flat, pallas_crop,
                               pallas_ops)

    fns = (fused_conv_flat.flat_conv3x3_mask_stats,
           fused_conv_flat.flat_bwd_mega, pallas_ops.spark_loss_pallas,
           pallas_ops.spark_loss_bwd, pallas_crop.crop_resize_pallas,
           pallas_ops.bn_relu_mask_pallas, fused_conv.conv_stem_stats,
           fused_conv.conv3x3_mask_stats, fused_conv.bwd_mega)
    return {fn.__name__: fn.launches for fn in fns}


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
        self.gen = torch.Generator(device=self.device)
        self.graph = None
        self.static_idx = None
        self.static_metrics = None
        self.names: List[str] = []
        self.report: Dict[str, Any] = {
            "label": label, "eager_steps": 0, "replays": 0,
            "capture_calls": {}, "capture_s": None, "pool_bytes": None}

    def _row(self, metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
        if not self.names:
            self.names = list(metrics)
        return torch.stack([metrics[k].float() for k in self.names])

    def _eager(self, state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        self.gen.manual_seed(state.step_seed())
        metrics = self.body(state, self.gather(idx), self.gen)
        state.step += 1
        self.report["eager_steps"] += 1
        return self._row(metrics)

    def _capture(self, state: TrainState, idx: torch.Tensor) -> None:
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()  # the warm-up's blocks, for the pool
        free0 = torch.cuda.mem_get_info(self.device)[0]
        self.static_idx = idx.clone()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        self.gen.manual_seed(state.step_seed())
        before = launch_counts()
        mode = torch.cuda.get_sync_debug_mode()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    self.static_metrics = self.body(
                        state, self.gather(self.static_idx), self.gen)
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
        self.report["pool_bytes"] = free0 - torch.cuda.mem_get_info(
            self.device)[0]
        self.graph = graph
        REPORTS.append(self.report)

    def step(self, state: TrainState, idx: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda" or not self.report["eager_steps"]:
            return self._eager(state, idx)
        if self.graph is None:
            self._capture(state, idx)
        elif idx.shape != self.static_idx.shape:
            raise ValueError(f"the {self.report['label']} graph was captured "
                             f"for indices {tuple(self.static_idx.shape)}, "
                             f"not {tuple(idx.shape)}")
        self.static_idx.copy_(idx)
        self.gen.manual_seed(state.step_seed())
        self.graph.replay()
        state.step += 1
        self.report["replays"] += 1
        return self._row(self.static_metrics)

    def run(self, state: TrainState, idxs: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
        cols = torch.stack([self.step(state, idx) for idx in idxs]).t()
        return dict(zip(self.names, cols.contiguous()))
