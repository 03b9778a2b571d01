"""Optimizers (port of cmx/train/optim.py, and the fine-tune harness's Adam,
cmx/train/harness.py:102).

Each optimizer reproduces cmx's make_optimizer(name, ..., clip_norm,
params_example=...) chain (the CLI's call), with the optional
clip_by_global_norm(clip) first:

  lamb   scale_by_adam(b1, b2, eps=1e-6, eps_root=0, bias-corrected)
         -> add_decayed_weights(wd, no_decay_mask)
         -> scale_by_trust_ratio()   (every leaf, 1-D ones included; ratio 1
                                      where either norm is 0)
         -> scale by -lr
  sgd    add_decayed_weights(wd, no_decay_mask) -> optax.sgd(lr, momentum)
             = trace: t <- g + momentum * t (nesterov off) -> scale by -lr
  adamw  optax.adamw = scale_by_adam(b1, b2, eps=1e-8, eps_root=0)
         -> add_decayed_weights(wd, no_decay_mask) -> scale by -lr
  lars   optax.lars = add_decayed_weights(wd, no_decay_mask)
         -> scale_by_trust_ratio(trust_coefficient 0.001, eps 0) on every
            leaf -> scale by -lr -> trace(momentum), nesterov off

`Adam` reproduces optax.inject_hyperparams(optax.adam)(learning_rate), the
harness's optimizer, which cmx builds outside make_optimizer: every
hyperparameter a 0-d fp32 tensor, as inject_hyperparams makes them, so
1 - b2 is rounded in fp32. In make_optimizer's chains only lr and wd are
injected; b1, b2 and the momentum stay Python floats there, and here.

lr and wd may be callables of the optimizer's step count (optax's
inject_hyperparams). The update is computed out of place and committed with
torch.where(finite, new, old), so a non-finite step keeps parameters and
optimizer state (count included) without a host synchronisation.
`state_dict()` / `load_state_dict()` carry the state across a checkpoint.
`scale_by_layer_decay` multiplies each parameter's update by its layer's
decay factor, as cmx's transform chained after the optimizer does.
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


def _value(v: ScalarOrSchedule, count: torch.Tensor):
    return v(count) if callable(v) else v


def _clip(grads: List[torch.Tensor], clip_norm: Optional[float]):
    """optax.clip_by_global_norm: g * clip / |g| where |g| >= clip."""
    if clip_norm is None:
        return grads
    g_norm = global_grad_norm(grads)
    keep = g_norm < clip_norm
    return [torch.where(keep, g, (g / g_norm) * clip_norm) for g in grads]


def _trust_ratio(pf: torch.Tensor, u: torch.Tensor,
                 coefficient: float = 1.0) -> torch.Tensor:
    """optax.scale_by_trust_ratio's factor: coefficient * |p| / |u|, 1
    where either norm is 0."""
    pn = torch.linalg.vector_norm(pf)
    un = torch.linalg.vector_norm(u)
    return torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                       coefficient * pn / un)


class _Optimizer:
    """The shared part: the parameters, the decay mask, lr and wd (values or
    schedules of the step count), the clip, the count, fp32 per-parameter
    state lists named by `STATE`, the optional per-parameter update scales,
    and the NaN guard. A subclass gives `_update(i, g, pf, h)` -> (the
    update added to the fp32 parameter, {state name: its new value}); `h`
    holds the step's hyperparameters (`_hyper()`, from the count before the
    update)."""

    STATE: Tuple[str, ...] = ()

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0,
                 clip_norm: Optional[float] = None):
        named = list(named_params)
        self.params = [p for _, p in named]
        self.decay = no_decay_mask(named)
        self.learning_rate, self.weight_decay = learning_rate, weight_decay
        self.clip_norm = clip_norm
        self.scales: Optional[List[torch.Tensor]] = None
        self.count = torch.zeros((), dtype=torch.int32,
                                 device=self.params[0].device)
        for name in self.STATE:
            setattr(self, name, [torch.zeros_like(p, dtype=torch.float32)
                                 for p in self.params])

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                **{name: list(getattr(self, name)) for name in self.STATE}}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copy `state`'s tensors into the optimizer's own, in place (they
        keep their devices); the keys, lengths and shapes must agree."""
        own = self.state_dict()
        if set(state) != set(own):
            raise KeyError(f"optimizer state has {sorted(state)}, expected "
                           f"{sorted(own)}")
        for key, dst in own.items():
            src = state[key]
            pairs = (list(zip(dst, src)) if isinstance(dst, list)
                     and len(dst) == len(src) else [(dst, src)])
            for d, t in pairs:
                if not isinstance(d, torch.Tensor) or d.shape != t.shape:
                    raise ValueError(f"optimizer state {key!r} does not "
                                     f"match this optimizer's parameters")
                d.copy_(t)

    def _hyper(self) -> Dict[str, Any]:
        return {"lr": _value(self.learning_rate, self.count),
                "wd": _value(self.weight_decay, self.count)}

    def _update(self, i: int, g: torch.Tensor, pf: torch.Tensor,
                h: Dict[str, Any]):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             finite: Optional[torch.Tensor] = None) -> None:
        """Apply one update in place; with `finite` False (a 0-d bool
        tensor) parameters and state stay as they were."""
        grads = _clip([g.float() for g in grads], self.clip_norm)
        h = self._hyper()
        if finite is None:
            finite = torch.ones((), dtype=torch.bool, device=self.count.device)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            pf = p.float()
            upd, new = self._update(i, g, pf, h)
            if self.scales is not None:
                upd = upd * self.scales[i]
            p.copy_(torch.where(finite, pf + upd, pf).to(p.dtype))
            for name, v in new.items():
                old = getattr(self, name)[i]
                old.copy_(torch.where(finite, v, old))
        self.count.copy_(torch.where(finite, self.count + 1, self.count))


class AdamW(_Optimizer):
    """optax.adamw over `named_params` (an iterable of (name, tensor)): the
    bias-corrected Adam direction, the decoupled wd * p added where
    no_decay_mask is True, then the -lr scale; the optional global-norm
    clip runs first."""

    STATE = ("mu", "nu")

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 1e-4, *, b1=0.9, b2=0.999,
                 eps=1e-8, clip_norm: Optional[float] = None):
        super().__init__(named_params, learning_rate, weight_decay, clip_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _hyper(self):
        count_inc = (self.count + 1).float()
        return {**super()._hyper(), "bc1": 1 - self.b1 ** count_inc,
                "bc2": 1 - self.b2 ** count_inc}

    def _direction(self, i, g, pf, h):
        """scale_by_adam, then add_decayed_weights."""
        mu = (1 - self.b1) * g + self.b1 * self.mu[i]
        nu = (1 - self.b2) * (g * g) + self.b2 * self.nu[i]
        u = (mu / h["bc1"]) / (torch.sqrt(nu / h["bc2"]) + self.eps)
        if self.decay[i]:
            u = u + h["wd"] * pf
        return u, {"mu": mu, "nu": nu}

    def _update(self, i, g, pf, h):
        u, new = self._direction(i, g, pf, h)
        return (-h["lr"]) * u, new


class Lamb(AdamW):
    """LAMB over `named_params`: AdamW's direction (eps 1e-6) times the trust
    ratio |p| / |u| on every leaf, then the -lr scale; the optional
    global-norm clip chained before it."""

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 clip_norm: Optional[float] = None):
        super().__init__(named_params, learning_rate, weight_decay, b1=b1,
                         b2=b2, eps=eps, clip_norm=clip_norm)

    def _update(self, i, g, pf, h):
        u, new = self._direction(i, g, pf, h)
        return (-h["lr"]) * (u * _trust_ratio(pf, u)), new


class Adam(AdamW):
    """Adam over `named_params` with optax.adam's b1, b2 and eps (no weight
    decay) and its hyperparameters held as 0-d fp32 tensors on the
    parameters' device (the harness builds one for each fit, with that
    fit's learning rate)."""

    def __init__(self, named_params, learning_rate: float = 1e-3):
        named = list(named_params)
        b1, b2, eps, lr = (
            torch.tensor(v, dtype=torch.float32, device=named[0][1].device)
            for v in (0.9, 0.999, 1e-8, learning_rate))
        super().__init__(named, lr, 0.0, b1=b1, b2=b2, eps=eps)
        self.decay = [False] * len(self.params)


class Sgd(_Optimizer):
    """SGD with momentum over `named_params`; wd * p is added to the
    gradient where no_decay_mask is True; the optional global-norm clip runs
    first."""

    STATE = ("trace",)

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0, *,
                 momentum: float = 0.9, clip_norm: Optional[float] = None):
        super().__init__(named_params, learning_rate, weight_decay, clip_norm)
        self.momentum = momentum

    def _update(self, i, g, pf, h):
        if self.decay[i]:
            g = g + h["wd"] * pf
        t = g + self.momentum * self.trace[i]
        return (-h["lr"]) * t, {"trace": t}


class Lars(Sgd):
    """optax.lars as cmx's make_optimizer calls it: wd * p where
    no_decay_mask is True, the trust ratio 0.001 * |p| / |u| on every leaf
    (eps 0; 1 where either norm is 0), the -lr scale, then the momentum
    trace (no nesterov); the optional global-norm clip runs first."""

    def __init__(self, named_params, learning_rate: ScalarOrSchedule,
                 weight_decay: ScalarOrSchedule = 0.0, *,
                 momentum: float = 0.9, trust_coefficient: float = 0.001,
                 clip_norm: Optional[float] = None):
        super().__init__(named_params, learning_rate, weight_decay,
                         momentum=momentum, clip_norm=clip_norm)
        self.trust_coefficient = trust_coefficient

    def _update(self, i, g, pf, h):
        if self.decay[i]:
            g = g + h["wd"] * pf
        u = (-h["lr"]) * (g * _trust_ratio(pf, g, self.trust_coefficient))
        t = u + self.momentum * self.trace[i]
        return t, {"trace": t}


def make_optimizer(name: str, learning_rate: ScalarOrSchedule,
                   weight_decay: ScalarOrSchedule = 0.0, *,
                   momentum: float = 0.9, clip_norm: Optional[float] = None,
                   named_params=None, b1: float = 0.9, b2: float = 0.999):
    """The named optimizer over `named_params` (name, tensor) pairs."""
    name = name.lower()
    if name == "lamb":
        return Lamb(named_params, learning_rate, weight_decay, b1=b1, b2=b2,
                    clip_norm=clip_norm)
    if name == "adamw":
        return AdamW(named_params, learning_rate, weight_decay, b1=b1, b2=b2,
                     clip_norm=clip_norm)
    if name == "sgd":
        return Sgd(named_params, learning_rate, weight_decay,
                   momentum=momentum, clip_norm=clip_norm)
    if name == "lars":
        return Lars(named_params, learning_rate, weight_decay,
                    momentum=momentum, clip_norm=clip_norm)
    raise ValueError(f"unknown optimizer {name!r}")


def unet_layer_id(path_name: str, num_layers: int) -> int:
    """Depth index of a UNet parameter for layer-wise lr decay: encoder
    stages 0..4 (down1..4, bottleneck), everything else (decoder, necks,
    head) num_layers (full lr). The UNet-stage analog of the reference's
    get_layer_id_for_vit (cmae/core/optimizer/optimizer.py:119-139)."""
    for i in range(1, 5):
        if f"down{i}" in path_name:
            return i - 1
    if "bottleneck" in path_name:
        return 4
    return num_layers


def layer_lr_decay_scales(named_params, decay_rate: float, num_layers: int = 5,
                          layer_fn: Callable[[str, int], int] = unet_layer_id
                          ) -> List[torch.Tensor]:
    """Per-parameter lr multipliers decay_rate ** (num_layers - layer id),
    0-d fp32 tensors on each parameter's device
    (cmae/core/optimizer/optimizer.py:141-239)."""
    return [torch.tensor(decay_rate ** (num_layers - layer_fn(name, num_layers)),
                         dtype=torch.float32, device=p.device)
            for name, p in named_params]


def scale_by_layer_decay(tx: _Optimizer, named_params, decay_rate: float,
                         num_layers: int = 5,
                         layer_fn: Callable[[str, int], int] = unet_layer_id
                         ) -> _Optimizer:
    """`tx` with each parameter's update multiplied by its layer's scale, as
    cmx's optax.chain(make_optimizer(...), scale_by_layer_decay(...));
    `named_params` in the order `tx` holds them."""
    tx.scales = layer_lr_decay_scales(named_params, decay_rate, num_layers,
                                      layer_fn)
    return tx
