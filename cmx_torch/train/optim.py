"""Optimizers (port of cmx/train/optim.py:26-110).

Only LAMB is ported (SparK's optimizer); sgd, adamw and lars wait (ROADMAP).
`Lamb` reproduces cmx's make_optimizer("lamb", ..., clip_norm) exactly:

  clip_by_global_norm(clip) ->
  optax.lamb = scale_by_adam(b1, b2, eps=1e-6, eps_root=0, bias-corrected)
               -> add_decayed_weights(wd, no_decay_mask)
               -> scale_by_trust_ratio()   (every leaf, 1-D ones included;
                                            ratio 1 where either norm is 0)
               -> scale by -lr

lr and wd may be callables of the optimizer's step count (optax's
inject_hyperparams). The update is computed out of place and committed with
torch.where(finite, new, old), so a non-finite step keeps parameters and
optimizer state without a host synchronisation.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

import torch

ScalarOrSchedule = Union[float, Callable]


def no_decay_mask(named_params: Iterable[Tuple[str, torch.Tensor]]) -> List[bool]:
    """True where weight decay applies: >=2-D kernels that are not mask
    tokens (Spark/utils/lr_control.py:32-53)."""
    return [("mask_token" not in name) and p.dim() >= 2
            for name, p in named_params]


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient entry (optax.global_norm)."""
    return torch.sqrt(torch.stack([g.float().square().sum() for g in grads]).sum())


def _value(v: ScalarOrSchedule, count: torch.Tensor):
    return v(count) if callable(v) else v


class Lamb:
    """LAMB over `named_params` (an iterable of (name, tensor)) with the
    optional global-norm clip chained before it."""

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 clip_norm: Optional[float] = None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.decay = no_decay_mask(named)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clip_norm = clip_norm
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """Apply one update in place; with `finite` False (a 0-d bool
        tensor) parameters and state stay as they were."""
        grads = [g.float() for g in grads]
        if self.clip_norm is not None:
            g_norm = global_grad_norm(grads)
            keep = g_norm < self.clip_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.clip_norm)
                     for g in grads]
        lr = _value(self.learning_rate, self.count)
        wd = _value(self.weight_decay, self.count)
        count_inc = self.count + 1
        bc1 = 1 - self.b1 ** count_inc.float()
        bc2 = 1 - self.b2 ** count_inc.float()
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=self.count.device)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            mu = (1 - self.b1) * g + self.b1 * self.mu[i]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            pf = p.float()
            if self.decay[i]:
                u = u + wd * pf
            pn = torch.linalg.vector_norm(pf)
            un = torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            new_p = pf + (-lr) * (u * ratio)
            p.copy_(torch.where(finite, new_p, pf).to(p.dtype))
            self.mu[i].copy_(torch.where(finite, mu, self.mu[i]))
            self.nu[i].copy_(torch.where(finite, nu, self.nu[i]))
        self.count.copy_(torch.where(finite, count_inc, self.count))


def make_optimizer(name: str, learning_rate: ScalarOrSchedule,
                   weight_decay: ScalarOrSchedule = 0.0, *,
                   clip_norm: Optional[float] = None, named_params=None,
                   b1: float = 0.9, b2: float = 0.999):
    """The named optimizer over `named_params` (name, tensor) pairs."""
    name = name.lower()
    if name == "lamb":
        return Lamb(named_params, learning_rate, weight_decay, b1=b1, b2=b2,
                    clip_norm=clip_norm)
    if name in ("sgd", "adamw", "lars"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP: other "
            "optimizers)")
    raise ValueError(f"unknown optimizer {name!r}")
