"""The reference optimizers and schedules: LAMB, AdamW and SGD with
momentum as optax defines them, in float32, with Python floats for the
schedules.

Each starts with the gradients clipped to a global norm. LAMB and AdamW
take Adam's bias-corrected moments; weight decay adds wd * p to the
direction of every kernel of two or more dimensions that is not a mask
token; LAMB scales each leaf's direction by |p| / |direction| (1 where
either is 0). SGD is optax.chain(add_decayed_weights(wd, mask),
trace(momentum, nesterov=False), scale(-lr)): wd * p added to the gradient
of the same kernels, the trace t <- g + momentum * t, the step -lr * t.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def warmup_cosine(peak: float, total: int, warmup: int, step: int) -> float:
    """Linear from 0 to `peak` over `warmup` steps, then a half cosine to 0
    at `total`."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * 0.5 * (1 + math.cos(math.pi * t))


def cosine_anneal(start: float, end: float, total: int, step: int) -> float:
    t = min(max(step / max(total, 1), 0.0), 1.0)
    return end + (start - end) * 0.5 * (1 + math.cos(math.pi * t))


def decays(name: str, p: torch.Tensor) -> bool:
    return p.dim() >= 2 and "mask_token" not in name


class Optimizer:
    """`kind` "lamb" (eps 1e-6), "adamw" (eps 1e-8) or "sgd" (with
    `momentum`); `hyper(step)` gives (lr, wd) for the update that follows
    `step` earlier ones."""

    def __init__(self, kind: str, params: Dict[str, torch.Tensor], hyper,
                 clip_norm: Optional[float], b1: float = 0.9,
                 b2: float = 0.999, momentum: Optional[float] = None):
        if kind not in ("lamb", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {kind!r}")
        if kind == "sgd" and momentum is None:
            raise ValueError("sgd needs optim.momentum in the "
                             "configuration's settings")
        self.kind, self.hyper, self.clip_norm = kind, hyper, clip_norm
        self.count = 0
        if kind == "sgd":
            self.momentum = momentum
            self.trace = {k: torch.zeros_like(p) for k, p in params.items()}
            return
        self.b1, self.b2 = b1, b2
        self.eps = 1e-6 if kind == "lamb" else 1e-8
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def clip(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.clip_norm is None:
            return grads
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        factor = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        return {k: g * factor for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """Update `params` in place with gradients already clipped."""
        lr, wd = self.hyper(self.count)
        self.count += 1
        if self.kind == "sgd":
            for k, p in params.items():
                g = grads[k] + wd * p if decays(k, p) else grads[k]
                self.trace[k] = g + self.momentum * self.trace[k]
                p.sub_(lr * self.trace[k])
            return
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + self.eps)
            if decays(k, p):
                u = u + wd * p
            if self.kind == "lamb":
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
                u = u * torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            p.sub_(lr * u)


def schedule(cfg: dict):
    """hyper(step) -> (lr, wd) from a configuration's settings, as the
    pretrain CLI builds them: the peak lr scaled by the global batch / 256
    when optim.base_lr_scaled, a linear warm-up of optim.warmup_epochs and a
    half cosine over train.epochs; wd constant, or a half cosine to
    optim.wd_end. `cfg["steps_per_epoch"]` counts the global batches an
    epoch of the corpus holds."""
    s = cfg["settings"]
    steps = cfg["steps_per_epoch"]
    total = s["train.epochs"] * steps
    peak = s["optim.lr"] * (s["train.batch_size"] / 256
                            if s["optim.base_lr_scaled"] else 1.0)
    warm = s["optim.warmup_epochs"] * steps
    wd0, wd1 = s["optim.weight_decay"], s["optim.wd_end"]

    def hyper(step: int):
        wd = wd0 if wd1 is None else cosine_anneal(wd0, wd1, total, step)
        return warmup_cosine(peak, total, warm, step), wd

    return hyper


def from_settings(cfg: dict, params: Dict[str, torch.Tensor]) -> Optimizer:
    """The optimizer a configuration's settings state over `params`:
    optim.name, optim.clip_norm, optim.momentum (sgd) and schedule(cfg)."""
    s = cfg["settings"]
    return Optimizer(s["optim.name"], params, schedule(cfg),
                     s["optim.clip_norm"], momentum=s.get("optim.momentum"))
