#!/usr/bin/env python3
"""Chip smoke test of cmx_torch, the PyTorch/CUDA port of cmx, on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  0. build every CUDA kernel of the port from cmx_torch/csrc (nvcc, sm_90a);
     build the SparK pretraining step as the CLI builds it (task.name=spark,
     model.fused_conv=True, task.pallas_loss=True, full widths, 256^2, bf16,
     batch 32, LAMB lr 2e-4 wd 0.04 clip 5) and run one step with the
     kernel wrappers recording their calls (cmx_torch.ops._build.recorded);
  1. every recorded call replayed through its public wrapper and through
     its plain PyTorch version on the same operands: error and tolerance,
     kernel / plain / library time (CUDA events), and the least time the
     card could take for the same work (bound);
  2. the main path: launch counters zeroed, STEPS steps, every kernel's
     count checked against the recorded calls per step, finite loss and
     grad norm, step time; a torch.profiler window of two steps (device
     time by kernel, the device's busy share); then the same step with
     model.fused_conv=False task.pallas_loss=False (no kernel of the port),
     timed and profiled the same way;
  3. the fused step against the unfused plain-PyTorch model from the same
     weights and draws (loss and BN running stats within bf16 margins).
Then the K1-K8 bounds at the recorded shapes, and three lines: the kernels
as JSON, the card's name and power limit (nvidia-smi), and
{"ok": true, "device": {...}} last.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

BATCH = 32       # the SparK step's batch on one card
STEPS = 8        # steps of the main-path run (the first two are warm-up)
ITERS = 5        # timed launches per kernel measurement


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(a, b) -> tuple:
    a, b = a.float(), b.float()
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    return err, err / max(scale, 1e-12)


def kernels():
    """wrapper name -> (wrapper, plain version, route, source, TPU kernel)."""
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.ops import pallas_ops as po

    return {
        "flat_conv3x3_mask_stats": (
            ff.flat_conv3x3_mask_stats, ff.flat_conv3x3_mask_stats_plain,
            "cuda", "cmx_torch/csrc/flat_conv_fwd.cu",
            "cmx/ops/fused_conv_flat.py:115"),
        "flat_bwd_mega": (
            ff.flat_bwd_mega, ff.flat_bwd_mega_plain, "cuda",
            "cmx_torch/csrc/flat_conv_bwd.cu",
            "cmx/ops/fused_conv_flat.py:271"),
        "spark_loss_pallas": (
            po.spark_loss_pallas, po.spark_loss_pallas_plain, "triton",
            "cmx_torch/ops/pallas_ops.py", "cmx/ops/pallas_ops.py:68"),
    }


def make_cfg(batch: int, fused: bool = True):
    from cmx_torch.config.config import Config, apply_overrides

    cfg = Config()
    apply_overrides(cfg, [
        "task.name=spark", f"model.fused_conv={fused}",
        f"task.pallas_loss={fused}", "data.image_size=256",
        f"train.batch_size={batch}", "optim.name=lamb", "optim.lr=2e-4",
        "optim.weight_decay=0.04", "optim.clip_norm=5.0",
    ])
    return cfg


def make_step(cfg):
    """(state, step, imgs): the CLI's SparK step on the card."""
    import torch

    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    task, model = build_task(cfg, torch.bfloat16, "cuda")
    tx = make_optimizer(cfg.optim.name, cfg.optim.lr, cfg.optim.weight_decay,
                        clip_norm=cfg.optim.clip_norm,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx, seed=cfg.train.seed)
    gen = torch.Generator(device="cuda").manual_seed(1)
    S = cfg.data.image_size
    imgs = torch.randn((cfg.train.batch_size, S, S), generator=gen,
                       device="cuda")
    return state, make_train_step(task, tx), imgs


def record_step(state, step, imgs):
    """One step with the wrappers recording their calls (also the warm-up
    that compiles the Triton kernel)."""
    import torch

    from cmx_torch.ops import _build

    _build.recorded = []
    try:
        step(state, imgs)
        torch.cuda.synchronize()
        return _build.recorded
    finally:
        _build.recorded = None


def stage_of(args) -> tuple:
    """(H, W, Cin, Cout, need_dx) of a recorded flat_bwd_mega call."""
    y, src, H, W, need_dx = args[1], args[2], args[12], args[13], args[15]
    return H, W, src.shape[1], y.shape[1], need_dx


def kernel_phase(calls, iters: int):
    """Phase 1: every recorded call through its wrapper and its plain
    version on the same operands."""
    import torch
    import torch.nn.functional as F

    from cmx_torch.ops import pallas_ops as po
    from cmx_torch.utils import roofline as rl

    res = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None,
                      flops=0.0, nbytes=0.0) for name in kernels()}
    for i, (name, args) in enumerate(calls):
        fn, plain = kernels()[name][:2]
        out, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        r = res[name]
        lib_ms = None
        if name == "flat_conv3x3_mask_stats":
            src, w, H, W = args[0], args[2], args[4], args[5]
            B, Cin = src.shape[:2]
            C = w.shape[3]
            ey, ry = rel_err(out[0], ref[0])
            _, rs = rel_err(out[1], ref[1])
            _, rq = rel_err(out[2], ref[2])
            ok = ry <= 1e-2 and rs <= 1e-3 and rq <= 1e-3
            err = ey
            msg = (f"{Cin}->{C} pre_norm={args[6] is not None}: y "
                   f"max_abs_err={ey:.3e} rel_err={ry:.3e} (tol 1e-2, bf16 "
                   f"store) sum rel_err={rs:.3e} sumsq rel_err={rq:.3e} (tol "
                   f"1e-3, sum order)")
            nbytes, flops = rl.conv3x3_fwd_work(B, H, W, Cin, C)
            peak = rl.PEAK_BF16
            xin = src.reshape(B, Cin, H, W)
            wl = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous()
            lib_ms = time_ms(lambda: F.conv2d(xin, wl, padding=1), iters)
        elif name == "flat_bwd_mega":
            H, W, Cin, C, need_dx = stage_of(args)
            B = args[1].shape[0]
            ew, rw = rel_err(out[1], ref[1])
            ok = rw <= 1e-3
            err = ew
            msg = (f"{Cin}->{C} pre_h={args[14] is not None} need_dx="
                   f"{need_dx}: dW max_abs_err={ew:.3e} rel_err={rw:.3e} "
                   f"(tol 1e-3, sum order)")
            if need_dx:
                eh, rh = rel_err(out[0], ref[0])
                ok = ok and rh <= 1e-2
                msg += (f" dX max_abs_err={eh:.3e} rel_err={rh:.3e} (tol 1e-2,"
                        f" bf16)")
            nbytes, flops = rl.conv3x3_bwd_work(B, H, W, Cin, C, need_dx)
            peak = rl.PEAK_BF16
        else:
            rec, imgs, act, patch = args
            B, H, W = imgs.shape
            el, rl_ = rel_err(out, ref)
            em, rm = rel_err(po._masked_l2_triton(rec, imgs, act, patch),
                             po.masked_l2_plain(rec, imgs, act, patch))
            ok = rl_ <= 1e-4 and rm <= 1e-4
            err = max(el, em)
            msg = (f"loss max_abs_err={el:.3e} rel_err={rl_:.3e}, per-patch "
                   f"map max_abs_err={em:.3e} rel_err={rm:.3e} (tol 1e-4, "
                   f"sum order)")
            nbytes, flops = rl.spark_loss_work(B, H, W, patch)
            peak = rl.PEAK_FP32
        n = iters * (4 if name == "spark_loss_pallas" else 1)  # short kernel
        t_k = time_ms(lambda: fn(*args), n)
        t_p = time_ms(lambda: plain(*args), n)
        bms, _ = rl.bound_ms(nbytes, flops, peak)
        lib = ("library_ms=null" if lib_ms is None else
               f"library_ms={lib_ms:.4f} (F.conv2d bf16: conv only, does less "
               f"work)")
        print(f"call {i} {name} B={B} {H}x{W} {msg} kernel_ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} {lib} bound_ms={bms:.4f}", flush=True)
        if not ok:
            fail(f"call {i}: {name} disagrees with its plain version")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += t_k
        r["plain_ms"] += t_p
        r["flops"] += flops
        r["nbytes"] += nbytes
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
        del out, ref
    return res


def run_steps(state, step, imgs, steps: int, label: str):
    """Mean step time over steps - 2 steps after 2 warm-up steps; every
    step's loss and grad norm finite."""
    import torch

    metrics = []
    t0 = time.perf_counter()
    for i in range(steps):
        metrics.append(step(state, imgs))
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / (steps - 2) * 1e3
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        print(f"{label} step {i}: "
              + " ".join(f"{k}={v:.6g}" for k, v in vals.items()), flush=True)
        if not (math.isfinite(vals["loss"]) and math.isfinite(vals["grad_norm"])
                and vals["nonfinite"] == 0.0):
            fail(f"{label} step {i} is not finite: {vals}")
    B = imgs.shape[0]
    print(f"{label}: step_ms={dt:.3f} img_per_s={B / dt * 1e3:.2f} (batch {B}, "
          f"256^2, bf16, mean of {steps - 2} steps after 2 warm-up steps)",
          flush=True)
    return dt


def profile_steps(run_step, n: int, step_ms: float, label: str) -> None:
    """Device time by kernel over n steps (torch.profiler / CUPTI), and the
    device's busy share of the step time measured without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    print(f"{label} profile of {n} steps: device busy {busy_ms:.3f} ms/step "
          f"of step_ms={step_ms:.3f} ({100 * busy_ms / step_ms:.1f}%); "
          f"{sum(e.count for e in kernels) // n} device operations/step; "
          f"top by device time:", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        ms = e.self_device_time_total / 1e3 / n
        print(f"  {ms:9.3f} ms/step {100 * ms / busy_ms:5.1f}%  "
              f"x{e.count // n:<4d} {e.key[:100]}", flush=True)


def step_phase(state, step, imgs, per_step: dict, steps: int):
    """Phase 2: the main path, its launch counts, time and profile."""
    wrappers = {name: k[0] for name, k in kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    step_ms = run_steps(state, step, imgs, steps, "fused")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: per_step.get(name, 0) * steps for name in wrappers}
    print(f"launches in {steps} steps: {launches} (expected from the recorded "
          f"step: {expect})", flush=True)
    if launches != expect or 0 in launches.values():
        fail("the step did not run every kernel the expected number of times")
    profile_steps(lambda: step(state, imgs), 2, step_ms, "fused")
    return launches, step_ms


def unfused_phase(batch: int, steps: int) -> float:
    """The same step with model.fused_conv=False task.pallas_loss=False: no
    kernel of the port runs (checked), cuDNN convs and eager BN instead."""
    import torch

    wrappers = [k[0] for k in kernels().values()]
    before = [fn.launches for fn in wrappers]
    state, step, imgs = make_step(make_cfg(batch, fused=False))
    step_ms = run_steps(state, step, imgs, steps, "unfused")
    if [fn.launches for fn in wrappers] != before:
        fail("the unfused step launched a kernel of the port")
    profile_steps(lambda: step(state, imgs), 2, step_ms, "unfused")
    del state, step, imgs
    torch.cuda.empty_cache()
    return step_ms


def reference_phase():
    """Phase 3: the fused step's forward/BN stats against the unfused
    plain-PyTorch model from the same weights and draws (batch 2, 256^2)."""
    import torch

    from cmx_torch.cli.pretrain import build_task
    from cmx_torch.ops.augment import _crop_window_params
    from cmx_torch.ops.masking import spark_active_mask
    from cmx_torch.ssl.spark import make_spark_task

    cfg = make_cfg(2)
    _, fused_model = build_task(cfg, torch.bfloat16, "cuda")
    cfg_plain = make_cfg(2, fused=False)
    _, plain_model = build_task(cfg_plain, torch.bfloat16, "cuda")
    plain_model.load_state_dict(fused_model.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(3)
    imgs = torch.randn((2, 256, 256), generator=gen, device="cuda")
    draws = {"crop": _crop_window_params(gen, 2, 256, 256, 256, (0.67, 1.0),
                                         (3 / 4, 4 / 3)),
             "flip": torch.tensor([True, False], device="cuda"),
             "active": spark_active_mask(gen, 2, 16, 0.6)}
    losses = {}
    for name, model, cfg_i in (("fused", fused_model, cfg),
                               ("plain", plain_model, cfg_plain)):
        task, _ = make_spark_task(model, augment=True, input_size=256,
                                  pallas_loss=cfg_i.task.pallas_loss)
        model.train()
        loss, _ = task.loss_fn(model, imgs, gen, draws)
        loss.backward()
        losses[name] = float(loss.detach())
    d_loss = abs(losses["fused"] - losses["plain"]) / abs(losses["plain"])
    bs_f = dict(fused_model.named_buffers())
    d_bs = max(float((b - bs_f[n]).abs().max())
               for n, b in plain_model.named_buffers())
    print(f"reference: loss fused={losses['fused']:.6f} "
          f"plain={losses['plain']:.6f} rel diff={d_loss:.3e} (tol 2e-2); "
          f"BN running stats max abs diff={d_bs:.3e} (tol 5e-2)", flush=True)
    if not (math.isfinite(losses["fused"]) and d_loss <= 2e-2 and d_bs <= 5e-2):
        fail("the fused step disagrees with the plain-PyTorch model")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    repo = Path(__file__).resolve().parent
    if not (repo / "cmx_torch" / "csrc").is_dir():
        fail(f"cmx_torch/ is not beside {Path(__file__).name}: run it from a "
             "checkout of the repository")
    sys.path.insert(0, str(repo))
    from cmx_torch import resolve_device
    from cmx_torch.ops import _build
    from cmx_torch.utils import roofline as rl

    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    state, step, imgs = make_step(make_cfg(BATCH))
    print(f"model params: {sum(p.numel() for p in state.model.parameters())}; "
          f"TF32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    calls = record_step(state, step, imgs)
    per_step = collections.Counter(name for name, _ in calls)
    print(f"recorded step: kernel calls per step {dict(per_step)}", flush=True)
    missing = set(kernels()) - set(per_step)
    if missing:
        fail(f"the step called no {sorted(missing)}")
    stages = [stage_of(args) for name, args in reversed(calls)
              if name == "flat_bwd_mega"]  # the backward runs in reverse

    kern = kernel_phase(calls, ITERS)
    del calls
    torch.cuda.empty_cache()
    launches, step_ms = step_phase(state, step, imgs, per_step, STEPS)
    del state, step, imgs
    torch.cuda.empty_cache()
    unfused_ms = unfused_phase(BATCH, STEPS)
    print(f"fused step_ms={step_ms:.3f} unfused step_ms={unfused_ms:.3f} "
          f"(fused/unfused {step_ms / unfused_ms:.3f})", flush=True)
    reference_phase()

    print(f"bounds of every TPU kernel's work in one step (batch {BATCH}; "
          f"stages {stages}):", flush=True)
    for r in rl.table(BATCH, stages):
        print(f"  {r['kernel']} {r['name']}: {r['launches']} launch(es), "
              f"{r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP, "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    rows = []
    for name, (_, _, route, source, replaces) in kernels().items():
        k = kern[name]
        peak = rl.PEAK_FP32 if route == "triton" else rl.PEAK_BF16
        bms, by = rl.bound_ms(k["nbytes"], k["flops"], peak)
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": k["library_ms"]})
    print(f"per-step kernel times (ms, sum over one step's launches); "
          f"step_ms={step_ms:.3f}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
