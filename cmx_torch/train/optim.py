"""Optimizers (port of cmx/train/optim.py:26-110, and the fine-tune
harness's Adam, cmx/train/harness.py:102).

LAMB (SparK's optimizer), SGD (MoCo's) and Adam (the fine-tune harness's)
are ported; adamw and lars wait (ROADMAP). `Lamb` reproduces cmx's
make_optimizer("lamb", ..., clip_norm) exactly:

  clip_by_global_norm(clip) ->
  optax.lamb = scale_by_adam(b1, b2, eps=1e-6, eps_root=0, bias-corrected)
               -> add_decayed_weights(wd, no_decay_mask)
               -> scale_by_trust_ratio()   (every leaf, 1-D ones included;
                                            ratio 1 where either norm is 0)
               -> scale by -lr

`Sgd` reproduces make_optimizer("sgd", ..., momentum, clip_norm) with a
parameter example (the CLI's call):

  clip_by_global_norm(clip) ->
  add_decayed_weights(wd, no_decay_mask) -> optax.sgd(lr, momentum)
      = trace: t <- g + momentum * t (nesterov off) -> scale by -lr

`Adam` reproduces optax.inject_hyperparams(optax.adam)(learning_rate), the
harness's optimizer, which cmx builds outside make_optimizer:

  scale_by_adam(b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected)
      -> scale by -lr,   every hyperparameter a 0-d fp32 device tensor, as
                         inject_hyperparams makes them (an Adam per fit)

lr and wd may be callables of the optimizer's step count (optax's
inject_hyperparams). The update is computed out of place and committed with
torch.where(finite, new, old), so a non-finite step keeps parameters and
optimizer state (count included) without a host synchronisation.
`state_dict()` / `load_state_dict()` carry the state (Lamb: count, mu, nu;
Sgd: count, trace) across a checkpoint, so a resumed run continues the same
optimizer.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple, Union)

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


@torch.no_grad()
def _load_state(own: Dict[str, Any], state: Dict[str, Any]) -> None:
    """Copy `state`'s tensors into the optimizer's own, in place (they keep
    their devices); the keys, lengths and shapes must agree."""
    if set(state) != set(own):
        raise KeyError(f"optimizer state has {sorted(state)}, expected "
                       f"{sorted(own)}")
    for key, dst in own.items():
        src = state[key]
        pairs = (list(zip(dst, src)) if isinstance(dst, list)
                 and len(dst) == len(src) else [(dst, src)])
        for d, t in pairs:
            if not isinstance(d, torch.Tensor) or d.shape != t.shape:
                raise ValueError(f"optimizer state {key!r} does not match "
                                 f"this optimizer's parameters")
            d.copy_(t)


def _value(v: ScalarOrSchedule, count: torch.Tensor):
    return v(count) if callable(v) else v


def _clip(grads: List[torch.Tensor], clip_norm: Optional[float]):
    """optax.clip_by_global_norm: g * clip / |g| where |g| >= clip."""
    if clip_norm is None:
        return grads
    g_norm = global_grad_norm(grads)
    keep = g_norm < clip_norm
    return [torch.where(keep, g, (g / g_norm) * clip_norm) for g in grads]


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

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _load_state(self.state_dict(), state)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """Apply one update in place; with `finite` False (a 0-d bool
        tensor) parameters and state stay as they were."""
        grads = _clip([g.float() for g in grads], self.clip_norm)
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


class Sgd:
    """SGD with momentum over `named_params`; wd * p is added to the
    gradient where no_decay_mask is True; the optional global-norm clip runs
    first."""

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0, *,
                 momentum: float = 0.9, clip_norm: Optional[float] = None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.decay = no_decay_mask(named)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.clip_norm = clip_norm
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.trace = [torch.zeros_like(p, dtype=torch.float32)
                      for p in self.params]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "trace": list(self.trace)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        _load_state(self.state_dict(), state)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """Apply one update in place; with `finite` False (a 0-d bool
        tensor) parameters and state stay as they were."""
        grads = _clip([g.float() for g in grads], self.clip_norm)
        lr = _value(self.learning_rate, self.count)
        wd = _value(self.weight_decay, self.count)
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=self.count.device)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            pf = p.float()
            if self.decay[i]:
                g = g + wd * pf
            t = g + self.momentum * self.trace[i]
            new_p = pf + (-lr) * t
            p.copy_(torch.where(finite, new_p, pf).to(p.dtype))
            self.trace[i].copy_(torch.where(finite, t, self.trace[i]))
        self.count.copy_(torch.where(finite, self.count + 1, self.count))


class Adam:
    """Adam over `named_params` with optax.adam's b1, b2 and eps and its
    hyperparameters held as 0-d fp32 tensors on the parameters' device (the
    harness builds one for each fit, with that fit's learning rate)."""

    def __init__(self, named_params, learning_rate: float = 1e-3):
        self.params = [p for _, p in named_params]
        dev = self.params[0].device
        # inject_hyperparams turns every hyperparameter into an fp32 array,
        # so optax computes 1 - b2 (and b ** count) in fp32: so does this
        self.b1, self.b2, self.eps, self.learning_rate = (
            torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (0.9, 0.999, 1e-8, learning_rate))
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """Apply one update in place; with `finite` False (a 0-d bool
        tensor) parameters and state stay as they were."""
        count_inc = self.count + 1
        bc1 = 1 - self.b1 ** count_inc.float()
        bc2 = 1 - self.b2 ** count_inc.float()
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=self.count.device)
        neg_lr = -self.learning_rate
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = g.float()
            mu = (1 - self.b1) * g + self.b1 * self.mu[i]
            nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            pf = p.float()
            new_p = pf + neg_lr * u
            p.copy_(torch.where(finite, new_p, pf).to(p.dtype))
            self.mu[i].copy_(torch.where(finite, mu, self.mu[i]))
            self.nu[i].copy_(torch.where(finite, nu, self.nu[i]))
        self.count.copy_(torch.where(finite, count_inc, self.count))


def make_optimizer(name: str, learning_rate: ScalarOrSchedule,
                   weight_decay: ScalarOrSchedule = 0.0, *,
                   momentum: float = 0.9, clip_norm: Optional[float] = None,
                   named_params=None, b1: float = 0.9, b2: float = 0.999):
    """The named optimizer over `named_params` (name, tensor) pairs."""
    name = name.lower()
    if name == "lamb":
        return Lamb(named_params, learning_rate, weight_decay, b1=b1, b2=b2,
                    clip_norm=clip_norm)
    if name == "sgd":
        return Sgd(named_params, learning_rate, weight_decay,
                   momentum=momentum, clip_norm=clip_norm)
    if name in ("adamw", "lars"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP: other "
            "optimizers)")
    raise ValueError(f"unknown optimizer {name!r}")
