"""The comparison that decides `correct`: the program's first three train
steps against the reference's on the same weights, batches and seeds.

A reading of three steps holds:
  losses   each step's loss;
  grads    each parameter's gradient norm at step 1, as the optimizer got
           it (after the clip, before any weight decay); the program's is
           worked out from its optimizer state after step 1, by the
           optimizer's kind (perfbench.harness.READERS): lamb and adamw
           from Adam's first moment, (1 - b1) g; sgd from its momentum
           trace, g + wd p with wd p on the decayed leaves only, so the
           program's parameters and weight decay before the step are read
           too;
  vectors  the gradients themselves at steps 1 and 3, by step index (0,
           2): the program's from its state after steps 1, 2 and 3,
           g_3 = (m_3 - b1 m_2) / (1 - b1) for Adam's moment,
           g_3 = t_3 - mu t_2 - wd p for SGD's trace, p as step 3 read
           it; step 3 is the first that a graph cell replays, as its
           window does;
  change   each parameter's norm of (after step 3 - initial);
  stats    each running statistic's norm of (after step 3 - initial), the
           target's under "target.";
  target   each momentum network's parameter's norm of (after step 3 -
           initial) (CM-UNet's EMA target, MoCo's key encoder: the one
           module the task's `extra` holds), for the parameters drawn
           apart from the online ones.
The numbers compared, each by the worst leaf, as a gap of norms (not the
norm of a difference) over the reference's norm of that leaf or the median
leaf's, whichever is larger:
  loss_gap     max over the steps of |loss - ref| / |ref|;
  grad_gap     the gradients' norms at steps 1 and 3, the larger of the
               two, over the parameters whose reference gradient at step 1
               is at least a thousandth of the median parameter's: a conv
               bias before a batch norm has a gradient of zero to
               rounding, whose size is the rounding of the precision it
               was summed in;
  grad_median_gap  the same gap of the median parameter: steady from seed
               to seed where one leaf's gradient is all rounding in
               bfloat16 (PERF.md);
  kernel_grad_gap  grad_gap over the parameters of two or more dimensions:
               a bias's gradient is one cancelling sum, which bfloat16
               turns by a tenth and more, where a kernel's norm sums many.
               A kernel whose gradient is mostly its images' spread, as at
               the bottleneck, grows by up to sqrt(2) when half a batch is
               left out;
  grad_median_diff  the norm of the difference of the two gradient
               vectors, not a gap of norms, over the same floor: the
               median parameter, the larger of steps 1 and 3. Both sides
               start step 1 from the same weights, and at warm-up learning
               rates step 3 from weights a few ulps apart, so a gradient's
               direction is compared too;
  change_gap   over the same parameters (Adam moves such a bias by its
               rounding alone);
  stats_gap    over every running statistic;
  target_gap   over every target parameter (cells with a momentum
               network).
A cell's limits name the numbers it compares; one with no limit is printed
and not judged (PERF.md gives why).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Optional

import torch

NUMBERS = ("loss_gap", "grad_gap", "grad_median_gap", "kernel_grad_gap",
           "grad_median_diff", "change_gap", "stats_gap", "target_gap")
GRAD_STEPS = (0, 2)  # the steps whose gradient vectors are compared
STILL = 1e-3  # a gradient under this share of the median leaf's: rounding


@dataclasses.dataclass
class Reading:
    losses: List[float]
    grads: Dict[str, float]
    vectors: Dict[int, Dict[str, torch.Tensor]]
    change: Dict[str, float]
    stats: Dict[str, float]
    target: Dict[str, float]


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def _gaps(prog: Dict[str, float], ref: Dict[str, float],
          names: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms over max(its reference norm, the median
    leaf's); a leaf missing on one side reads infinity."""
    names = list(ref) if names is None else names
    if set(prog) != set(ref):
        return {"(leaves differ)": math.inf}
    if not names:
        return {}
    floor = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)
            for k in names}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: _norm(v) for k, v in tensors.items()}


def _worst(prog, ref, names=None) -> float:
    return max(_gaps(prog, ref, names).values(), default=0.0)


def _vector_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                 names: List[str]) -> Dict[str, float]:
    """Each leaf's norm of (program's tensor - reference's) over max(its
    reference norm, the median leaf's), on the reference's device; leaves
    that differ on the two sides read infinity."""
    if set(prog) != set(ref):
        return {"(leaves differ)": math.inf}
    norms = {k: _norm(ref[k]) for k in names}
    floor = statistics.median(norms.values()) if names else 0.0
    return {k: _norm(prog[k].to(ref[k].device) - ref[k])
            / max(norms[k], floor, 1e-30) for k in names}


def _diffs(prog: Reading, ref: Reading, names: List[str]
           ) -> Dict[int, Dict[str, float]]:
    """By step, _vector_gaps of the gradients; a step missing on one side
    reads infinity."""
    out = {}
    for i in GRAD_STEPS:
        p, r = prog.vectors.get(i), ref.vectors.get(i)
        out[i] = ({"(step missing)": math.inf} if p is None or r is None
                  else _vector_gaps(p, r, names))
    return out


def _step_gaps(prog: Reading, ref: Reading, names: List[str]
               ) -> Dict[int, Dict[str, float]]:
    """By step, each leaf's gap of gradient norms (_gaps); a step missing
    on one side reads infinity."""
    out = {}
    for i in GRAD_STEPS:
        p, r = prog.vectors.get(i), ref.vectors.get(i)
        out[i] = ({"(step missing)": math.inf} if p is None or r is None
                  else _gaps(_norms(p), _norms(r), names))
    return out


def kernels(ref: Reading) -> List[str]:
    """The parameters of two or more dimensions (conv and dense kernels,
    mask tokens), as weight decay picks them."""
    return [k for k, v in ref.vectors[GRAD_STEPS[0]].items() if v.dim() >= 2]


def moving(ref: Reading) -> List[str]:
    """The parameters whose reference gradient is not nought to rounding."""
    floor = statistics.median(ref.grads.values())
    return [k for k, g in ref.grads.items() if g >= STILL * floor]


def worst_leaves(prog: Reading, ref: Reading) -> Dict[str, list]:
    """For each leaf-wise number, its three worst leaves: [name, gap,
    program's norm, reference's norm]."""
    out = {}
    live = moving(ref)
    for i, gaps in _step_gaps(prog, ref, live).items():
        out[f"grad_gap.{i + 1}"] = [
            [k, g] for k, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:3]]
    for name, p, r, names in (("change_gap", prog.change, ref.change, live),
                              ("stats_gap", prog.stats, ref.stats, None),
                              ("target_gap", prog.target, ref.target, None)):
        gaps = _gaps(p, r, names)
        out[name] = [[k, g, p.get(k), r.get(k)] for k, g in
                     sorted(gaps.items(), key=lambda kv: -kv[1])[:3]]
    for i, gaps in _diffs(prog, ref, live).items():
        out[f"grad_vector.{i + 1}"] = [
            [k, g] for k, g in sorted(gaps.items(), key=lambda kv: -kv[1])[:3]]
    return out


def compare(prog: Reading, ref: Reading) -> Dict[str, float]:
    """The numbers the limits hold, by name."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog.losses, ref.losses))
    if len(prog.losses) != len(ref.losses):
        loss = math.inf
    live = moving(ref)
    gaps = _step_gaps(prog, ref, live).values()
    kern = set(kernels(ref))
    diffs = _diffs(prog, ref, live).values()
    out = {"loss_gap": loss,
           "grad_gap": max(max(d.values()) for d in gaps),
           "grad_median_gap": max(statistics.median(d.values())
                                  for d in gaps),
           "kernel_grad_gap": max(max((v for k, v in d.items()
                                       if k in kern or k.startswith("(")),
                                      default=0.0) for d in gaps),
           "change_gap": _worst(prog.change, ref.change, live),
           "stats_gap": _worst(prog.stats, ref.stats),
           "grad_median_diff": max(statistics.median(d.values())
                                   for d in diffs)}
    if ref.target or prog.target:
        out["target_gap"] = _worst(prog.target, ref.target)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the limits name there, finite and at most its limit."""
    return bool(limits) and all(
        math.isfinite(numbers.get(k, math.inf))
        and numbers.get(k, math.inf) <= limits[k] for k in limits)


def follow(cfg: dict, init: dict, batches: List[torch.Tensor], run_seed: int,
           device, precision: str = "fp32", half_batch: bool = False
           ) -> Reading:
    """The reference's reading over `batches` (one a step) from the initial
    weights `init` ({"params", "stats", "extra"}). `precision` "fp8" is the
    control; `half_batch` plants the fault of a step that leaves out half of
    its batch and takes the mean over the rest."""
    from perfbench.cells import reference_module
    from perfbench.reference.draws import step_generator
    from perfbench.reference.nn import set_fp32_math

    set_fp32_math()
    dev = torch.device(device)
    ref = reference_module(cfg["task"])
    step = ref.Step(cfg, {k: v.to(dev) for k, v in init["params"].items()},
                    {k: v.to(dev) for k, v in init["stats"].items()},
                    {k: v.to(dev) for k, v in init["extra"].items()},
                    precision)
    losses, grads, vectors = [], None, {}
    for i, imgs in enumerate(batches):
        imgs = imgs.to(dev)
        if half_batch:
            imgs = imgs[: imgs.shape[0] // 2]
        loss, g, new_stats = step.loss_and_grads(imgs, step_generator(
            dev, run_seed, i))
        g = step.opt.clip(g)
        if grads is None:
            grads = {k: _norm(v) for k, v in g.items()}
        if i in GRAD_STEPS:
            vectors[i] = {k: v.detach().clone() for k, v in g.items()}
        step.opt.step(step.params, g)
        step.commit(new_stats)
        losses.append(float(loss))
        del g, new_stats
    params, stats = step.state()
    stats0 = dict(init["stats"])
    stats0.update({"target." + k: v for k, v in init["stats"].items()})
    apart = set(apart_targets(init))
    return Reading(
        losses, grads, vectors,
        {k: _norm(v - init["params"][k].to(dev)) for k, v in params.items()},
        {k: _norm(v - stats0[k].to(dev)) for k, v in stats.items()},
        {k: _norm(v - init["extra"]["target." + k].to(dev))
         for k, v in step.targets().items() if k in apart})


def apart_targets(init: dict) -> List[str]:
    """The target parameters drawn apart from the online ones: a bias or
    a scale starts equal on both nets, so the EMA moves it by rounding."""
    extra, params = init["extra"], init["params"]
    return [k for k in params if "target." + k in extra
            and not torch.equal(extra["target." + k], params[k])]


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """The result line's "checks": each number compared beside its limit."""
    def value(k):
        v = numbers.get(k, math.inf)
        return v if math.isfinite(v) else str(v)  # JSON has no infinity

    return {k: {"value": value(k), "limit": limits[k]} for k in limits}
