"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison with the plain reference.

Set-up builds the program as the pretrain CLI does (cmx_torch.cli.pretrain:
build_task, the preset's schedules and optimizer, the train state), with
the benchmark's own weights, made on the card from the seed and loaded
into the model (and into the task's `extra`: CM-UNet's target and reduce
kernel); the benchmark's synthetic corpus; and the step runner of
the cell:
  graph  make_device_feed's scan_run: the corpus resident on the card, one
         row gather and one replay of the captured CUDA graph a step;
  eager  make_train_step's step, each batch gathered on the host and
         copied from host memory, as the CLI does without the device feed.
The first three steps run through that same runner on rows that all
differ: the first runs eagerly (and fills every lazy cache), the second is
captured, the third replayed. The program's reading of those steps is
taken, then the window runs from step 4. The gradients of that reading come
from the optimizer's own state, read by its kind (READERS): Adam's first
moment for lamb and adamw, the momentum trace for sgd; a run of any other
optimizer is refused before set-up. A task's momentum network (CM-UNet's
EMA target, MoCo's key encoder) is the one module its `extra` holds,
whatever the key; its parameters and buffers are read under "target.".

The window opens and closes on a device synchronise and keeps the host at
most two steps ahead of the device. Every metric reads the context this
module fills (see perfbench/metrics). After the window: the peak memory is
read; with --trace 1 a few more steps are profiled; the program's state is
freed; the reference follows the first three steps in float32 and the two
readings are compared (perfbench/check.py).
"""

from __future__ import annotations

import collections
import gc
import math
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import cells, check, weights
from perfbench.cells import ROOT
from perfbench.flops import step_flops

FORBIDDEN = ("jax", "jaxlib", "flax", "cmx")  # top-level module names
CACHE = os.path.join(ROOT, ".perfbench_cache")
MAX_STEPS = 8192  # index rows made for a run
WARM_STEPS = 3


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    Triton's and torch's extensions here, the port's CUDA kernels in
    cmx_torch/_build/ (the port's own fixed directory)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.makedirs(CACHE, exist_ok=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def process_start_time() -> float:
    """The wall-clock time this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Refused(Exception):
    """A cell the harness cannot read: the run names why and prints no
    result."""


def momentum_net(extra: Any) -> Optional[torch.nn.Module]:
    """The one module a task's `extra` holds (CM-UNet's `target_model`,
    MoCo's `key_model`), or None; a second one is refused."""
    if not isinstance(extra, dict):
        return None
    keys = sorted(k for k, v in extra.items()
                  if isinstance(v, torch.nn.Module))
    if len(keys) > 1:
        raise Refused(f"the task's extra holds {len(keys)} modules {keys}; "
                      "the harness reads one momentum network")
    return extra[keys[0]] if keys else None


def _host(tensors) -> List[torch.Tensor]:
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tensors]


def adam_gradients(tx, now, prev, before) -> List[torch.Tensor]:
    """lamb, adamw: Adam's first moment m_i = b1 m_(i-1) + (1 - b1) g_i,
    so g_i = (m_i - b1 m_(i-1)) / (1 - b1)."""
    b1 = tx.b1
    return [(m if prev is None else m - b1 * prev[j]) / (1 - b1)
            for j, m in enumerate(now)]


def sgd_before(tx) -> Tuple[List[torch.Tensor], float]:
    """sgd, before a step: its parameters as the update reads them and its
    weight decay at the step's count, on the host."""
    wd = tx.weight_decay  # a value or a schedule of the step count
    return _host(tx.params), float(wd(tx.count) if callable(wd) else wd)


def sgd_gradients(tx, now, prev, before) -> List[torch.Tensor]:
    """sgd: the trace t_i = g_i + wd p + mu t_(i-1), wd p on the leaves its
    decay mask selects, so g_i = t_i - mu t_(i-1) - wd p."""
    params, wd = before
    mu = tx.momentum
    out = []
    for j, t in enumerate(now):
        g = t if prev is None else t - mu * prev[j]
        out.append(g - wd * params[j] if tx.decay[j] else g)
    return out


# optimizer kind -> (the state that holds the gradient, what is read before
# a compared step or None, the gradients from the state after the step and
# after the step before)
READERS = {"lamb": ("mu", None, adam_gradients),
           "adamw": ("mu", None, adam_gradients),
           "sgd": ("trace", sgd_before, sgd_gradients)}


def program_config(cell: Dict[str, Any]):
    """The program's Config: the preset, then the configuration's
    settings and the cell's overrides."""
    from cmx_torch.config.config import Config, apply_overrides
    from cmx_torch.config.presets import PRESETS

    cfg = PRESETS[cell["config"]["preset"]](Config())
    apply_overrides(cfg, [f"{k}={v!r}" for k, v in
                          cell["config"]["settings"].items()])
    return cfg


class Program:
    """The system under test for one run: its train state, its step runner
    and what the benchmark made for it."""

    def __init__(self, cell: Dict[str, Any], seed: int, device):
        from cmx_torch import resolve_device
        from cmx_torch.cli.pretrain import build_task, make_device_feed
        from cmx_torch.train.optim import make_optimizer
        from cmx_torch.train.schedules import (cosine_anneal, scaled_base_lr,
                                               warmup_cosine)
        from cmx_torch.train.state import TrainState
        from cmx_torch.train.trainer import make_train_step

        conf, work = cell["config"], cell["workload"]
        self.marks = [("imports", time.time())]
        self.dev = dev = resolve_device(device)
        self.batch = int(work["batch"])
        cfg = program_config(cell)
        cfg.train.seed = seed
        kind = cfg.optim.name.lower()
        if kind not in READERS:
            raise Refused(f"the harness cannot read the gradient from the "
                          f"state of optimizer {kind!r} (it reads "
                          f"{', '.join(READERS)})")
        self.reader = READERS[kind]
        dtype = (torch.bfloat16 if cfg.model.dtype == "bfloat16"
                 else torch.float32)
        ref = cells.reference_module(conf["task"])
        pspec, sspec = ref.param_spec(conf)
        espec = ref.extra_spec(conf)
        made = weights.make_weights(pspec + sspec + espec, seed, dev)
        self.marks.append(("weights", time.time()))
        task, model = build_task(cfg, dtype, dev)
        self._load(model, made, pspec, sspec)
        extra = None
        if task.init_extra:
            extra = task.init_extra(torch.Generator(device=dev).manual_seed(
                (seed + 1) % (2 ** 63)))
            own = dict(extra)
            net = momentum_net(extra)
            if net is not None:
                own.update({"target." + n: p for n, p in
                            net.named_parameters()})
            with torch.no_grad():
                for name, _, _ in espec:
                    own[name].copy_(made[name])
        # the reference's copy, kept on the host
        self.init = {k: {n: made[n].cpu() for n, _, _ in spec}
                     for k, spec in (("params", pspec), ("stats", sspec),
                                     ("extra", espec))}
        del made
        self.marks.append(("model", time.time()))

        spe = conf["steps_per_epoch"]
        total = cfg.train.epochs * spe
        lr_peak = (scaled_base_lr(cfg.optim.lr, cfg.train.batch_size)
                   if cfg.optim.base_lr_scaled else cfg.optim.lr)
        lr = warmup_cosine(lr_peak, total, cfg.optim.warmup_epochs * spe)
        wd = (cosine_anneal(cfg.optim.weight_decay, cfg.optim.wd_end, total)
              if cfg.optim.wd_end is not None else cfg.optim.weight_decay)
        self.tx = make_optimizer(cfg.optim.name, lr, wd,
                                 momentum=cfg.optim.momentum,
                                 clip_norm=cfg.optim.clip_norm,
                                 named_params=model.named_parameters())
        self.state = TrainState.create(model=model, tx=self.tx, seed=seed,
                                       extra=extra)
        self.task, self.model = task, model

        self.marks.append(("optimizer", time.time()))
        corpus = weights.make_corpus(conf["corpus_images"],
                                     cfg.data.image_size, seed, dev)
        self.imgs = corpus.cpu().numpy()  # host memory, as a loaded corpus
        del corpus
        self.rows = weights.index_rows(len(self.imgs), self.batch, MAX_STEPS,
                                       seed)
        self.marks.append(("corpus", time.time()))
        self.runner = work["runner"]
        self.graph = None
        if self.runner == "graph":
            _, _, scan_run = make_device_feed(self.imgs, dev, task=task,
                                              tx=self.tx, scan=True)
            self.scan_run, self.graph = scan_run, scan_run.graph
            self.rows_dev = torch.from_numpy(self.rows).to(dev)
        elif self.runner == "eager":
            self.step_fn = make_train_step(task, self.tx)
        else:
            raise ValueError(f"unknown runner {self.runner!r}")
        self.marks.append(("runner", time.time()))

    @staticmethod
    @torch.no_grad()
    def _load(model, made, pspec, sspec) -> None:
        """The benchmark's weights into the program's model, by name; every
        parameter and buffer is made, and no other."""
        own = dict(model.named_parameters())
        own.update(model.named_buffers())
        names = [n for n, _, _ in pspec + sspec]
        if sorted(own) != sorted(names):
            raise ValueError(
                "the program's model and the reference's spec differ: "
                f"{sorted(set(own) ^ set(names))[:8]}")
        for n in names:
            if own[n].shape != made[n].shape:
                raise ValueError(f"{n}: program {tuple(own[n].shape)}, "
                                 f"reference {tuple(made[n].shape)}")
            own[n].copy_(made[n])

    def batch_of(self, i: int) -> torch.Tensor:
        """Step i's images as a host tensor (what the reference is fed)."""
        return torch.from_numpy(self.imgs[self.rows[i]])

    def step(self, i: int) -> Dict[str, torch.Tensor]:
        """Train step i (from 0) through the cell's runner; its metrics on
        the device."""
        if self.runner == "graph":
            out = self.scan_run(self.state, self.rows_dev[i:i + 1])
            return {k: v[0] for k, v in out.items()}
        return self.step_fn(self.state, self.batch_of(i).to(self.dev))

    def named_stats(self) -> Dict[str, torch.Tensor]:
        out = dict(self.model.named_buffers())
        net = momentum_net(self.state.extra)
        if net is not None:
            out.update({"target." + k: v for k, v in net.named_buffers()})
        return out

    @torch.no_grad()
    def _changes(self, names) -> Dict[str, Dict[str, float]]:
        """Norms of each parameter's, running statistic's and drawn target
        parameter's change from the initial weights."""
        norm = torch.linalg.vector_norm
        params = dict(self.model.named_parameters())
        stats0 = dict(self.init["stats"])
        stats0.update({"target." + k: v
                       for k, v in self.init["stats"].items()})
        net = momentum_net(self.state.extra)
        targets = dict(net.named_parameters()) if net is not None else {}
        init_t = self.init["extra"]
        return {
            "params": {n: float(norm(params[n].float() - self.init["params"][n]
                                     .to(self.dev))) for n in names},
            "stats": {n: float(norm(b.float() - stats0[n].to(self.dev)))
                      for n, b in self.named_stats().items()},
            "target": {n: float(norm(targets[n].float()
                                     - init_t["target." + n].to(self.dev)))
                       for n in check.apart_targets(self.init)}}

    def warm(self) -> check.Reading:
        """The first three steps, and the program's reading of them. The
        gradients of steps 1 and 3 come from the optimizer's state, copied
        to the host after steps 1 to 3 (off the device, so they leave its
        peak as it was), by the optimizer's kind (READERS): Adam's first
        moment for lamb and adamw; for sgd the momentum trace, with the
        parameters and the weight decay as steps 1 and 3 read them, copied
        before those steps."""
        names = [n for n, _ in self.model.named_parameters()]
        state, read_before, gradients = self.reader
        losses, states, vectors = [], {}, {}
        for i in range(WARM_STEPS):
            before = (read_before(self.tx) if read_before is not None
                      and i in check.GRAD_STEPS else None)
            losses.append(self.step(i)["loss"])
            if i in check.GRAD_STEPS or i + 1 in check.GRAD_STEPS:
                states[i] = _host(getattr(self.tx, state))
            if i in check.GRAD_STEPS:
                vectors[i] = dict(zip(names, gradients(
                    self.tx, states[i], states.get(i - 1), before)))
        grads = {n: float(torch.linalg.vector_norm(g))
                 for n, g in vectors[0].items()}
        moved = self._changes(names)
        return check.Reading([float(x) for x in losses], grads, vectors,
                             moved["params"], moved["stats"], moved["target"])

    def window(self, seconds: float) -> Dict[str, Any]:
        """Steps from step 4 for `seconds`: the window's steps, length and
        the failed steps (a non-finite loss or gradient norm)."""
        cuda = self.dev.type == "cuda"
        pending: collections.deque = collections.deque()
        outs = []
        _sync(self.dev)
        t0 = time.perf_counter()
        start_wall = time.time()
        i = WARM_STEPS
        while True:
            outs.append(self.step(i)["nonfinite"])
            i += 1
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > 2:
                    pending.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds or i >= MAX_STEPS - 16:
                break
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        failed = int((torch.stack(outs) > 0).sum())
        self.next_step = i
        return {"steps": i - WARM_STEPS, "seconds": elapsed,
                "start_wall": start_wall, "failed": failed}

    def profile(self, steps: int, path: str):
        """`steps` more steps under torch.profiler; the parsed trace."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from perfbench.devtrace import WINDOW, Trace

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                _sync(self.dev)
                for k in range(steps):
                    self.step(self.next_step + k)
                _sync(self.dev)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
        return Trace.load(path, steps)

    def free(self) -> None:
        """Drop the program's state, graph and tensors."""
        for name in ("scan_run", "graph", "step_fn", "state", "task",
                     "model", "tx", "rows_dev"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def environment_line(dev: torch.device) -> str:
    """The card, its power limit, clocks and temperature; the library
    versions; the cuDNN and TF32 flags."""
    import importlib.metadata
    import subprocess

    smi = "nvidia-smi: not available"
    if dev.type == "cuda":
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                 "clocks.max.sm,clocks.mem,temperature.gpu",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=30).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            smi = f"nvidia-smi failed: {e}"
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "none"
    cudnn = torch.backends.cudnn
    return (f"environment: {smi}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, cuDNN {cudnn.version()}, Triton {triton}; "
            f"cudnn.benchmark={cudnn.benchmark} "
            f"cudnn.deterministic={cudnn.deterministic} "
            f"cudnn.allow_tf32={cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None,
        root: str = ROOT,
        out=sys.stdout, err=sys.stderr) -> Optional[Dict[str, Any]]:
    """One run of cell `name`; returns the result line's object, or None
    (after naming the cause on `err`) when the run may print none."""
    t_start = process_start_time() if t_start is None else t_start
    cell = cells.load_cell(name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=err)
            return None
        chips = int(cell["entry"]["chips"])
        if torch.cuda.device_count() < chips:
            print(f"{name} needs {chips} cards, found "
                  f"{torch.cuda.device_count()}", file=err)
            return None
        torch.cuda.reset_peak_memory_stats()

    try:
        prog = Program(cell, seed, dev)
    except Refused as e:
        print(f"{name}: {e}", file=err)
        return None
    warm = prog.warm()
    prog.marks.append(("warm steps", time.time()))
    win = prog.window(seconds)
    setup_s = win["start_wall"] - t_start
    # after the window, so that nvidia-smi's time stays out of setup_s
    print(environment_line(prog.dev), file=out, flush=True)
    print("set-up, seconds from the process's start at the end of each "
          "stage: " + ", ".join(f"{k} {t - t_start:.3f}"
                                for k, t in prog.marks), file=err, flush=True)
    peak = (torch.cuda.max_memory_allocated(prog.dev)
            if dev.type == "cuda" else 0)
    batch = prog.batch
    ctx: Dict[str, Any] = {
        "cell": cell, "batch": batch, "steps": win["steps"],
        "window_s": win["seconds"], "setup_s": setup_s,
        "peak_bytes": peak, "graph": (prog.graph.report if prog.graph
                                      else None)}
    ctx["step_flops"] = step_flops(cell["config"], batch)
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(prog.dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {}
    if trace:
        tr = prog.profile(int(cell["workload"]["profile_steps"]),
                          os.path.join(CACHE, f"trace-{name}.json"))
        ctx["trace"] = tr
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
        metrics = cells.read_metrics(cell["per_layer"], ctx, root)
    else:
        metrics = cells.read_metrics(cell["end_to_end"], ctx, root)
    prog.free()

    ref = check.follow(cell["config"], prog.init,
                       [prog.batch_of(i) for i in range(WARM_STEPS)], seed,
                       prog.dev)
    numbers = check.compare(warm, ref)
    limits = cell["workload"]["limits"]
    correct = check.judge(numbers, limits) and win["failed"] == 0
    found = forbidden_modules() if dev.type == "cuda" else []
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=err)
        return None
    line = {"correct": correct, "attempted": win["steps"],
            "failed": win["failed"], "metrics": metrics,
            "device": device_info}
    line.update(result)
    line["checks"] = dict(check.report(numbers, limits),
                          failed_steps={"value": win["failed"], "limit": 0})
    for k in check.NUMBERS:
        if k in numbers and k not in limits:
            print(f"reading {k} {numbers[k]!r} (not compared)", file=err)
    for k in limits:
        print(f"check {k} {numbers.get(k, math.inf)!r} limit {limits[k]!r}",
              file=err)
    print(f"check failed_steps {win['failed']} limit 0", file=err, flush=True)
    return line
