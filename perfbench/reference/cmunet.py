"""Reference CM-UNet train step (the CM-UNet repository's
configs/cmunet_config.py): masked reconstruction plus InfoNCE against an
EMA target.

Online: the UNet encoder on view 1 under the patch mask, a pixel decoder
and a feature decoder (two channels each); the feature decoder's channel
mean, flattened in (h, w) order, through the projector (view^2 -> 1536 ->
256, fc / BN / ReLU / fc) and the predictor (256 -> 1536 -> 256). Target:
a copy of every online parameter and running statistic, run in training
mode without gradient, its parameters drawn apart from the online ones
(a target that lags the online net, as after the first epochs; a copy
would move by (1 - m) times the warm-up steps, under float32's rounding),
its running statistics a copy: the encoder on view 2 unmasked, the fixed 1x1
reduce 1024 -> 256, flattened in (h, w, c) order, through its projector.
Loss: the masked squared error of the pixel decoder's channel 1 against
view 1 normalised over each row (population variance + 1e-6), plus 2T
times the cross entropy of the row-normalised scores / T against the
diagonal. AdamW; after the update every target parameter moves to
m * target + (1 - m) * online. The running statistics of both nets follow
their forwards.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import draws as D
from perfbench.reference import nn as R

WIDTHS = (64, 128, 256, 512)
BOTTLENECK = 1024
HIDDEN, OUT, REDUCED = 1536, 256, 256
BASE, SHIFT = 256, 31  # the shared crop's size; view 2's largest shift


def _neck_spec(prefix: str, cin: int):
    return (R.dense_spec(prefix + "fc0", cin, HIDDEN)
            + R.norm_spec(prefix + "bn0", HIDDEN)
            + R.dense_spec(prefix + "fc1", HIDDEN, OUT))


def param_spec(cfg: dict):
    """Online parameters and running statistics, as spark.param_spec."""
    view = cfg["settings"]["task.view_size"]
    params, stats = R.encoder_spec("encoder.", WIDTHS, BOTTLENECK)
    for name in ("pixel_decoder.", "feature_decoder."):
        p, s = R.decoder_spec(name, WIDTHS, BOTTLENECK, 2)
        params, stats = params + p, stats + s
    params += _neck_spec("projector.", view * view)
    params += _neck_spec("predictor.", OUT)
    stats += R.norm_stats("projector.bn0", HIDDEN)
    stats += R.norm_stats("predictor.bn0", HIDDEN)
    return params, stats


def extra_spec(cfg: dict):
    """The target's fixed 1x1 reduce kernel (HWIO), N(0, 2 / 1024), and
    its parameters, "target." and the online name, drawn as the online
    ones are."""
    params, _ = param_spec(cfg)
    return ([("reduce_kernel", (1, 1, BOTTLENECK, REDUCED),
              ("normal", math.sqrt(2.0 / BOTTLENECK)))]
            + [("target." + n, shape, init) for n, shape, init in params])


def image_flops(cfg: dict) -> float:
    """Model FLOPs of one image's step (perfbench.flops): the online nets
    trained, the target's encoder, reduce and projector forward only."""
    from perfbench import flops

    view = cfg["settings"]["task.view_size"]
    enc, first = flops.encoder(view, WIDTHS, BOTTLENECK)
    neck_in = view * view
    necks = (flops.dense(neck_in, HIDDEN) + flops.dense(HIDDEN, OUT)
             + flops.dense(OUT, HIDDEN) + flops.dense(HIDDEN, OUT))
    online = enc + 2 * flops.decoder(view, 2, WIDTHS, BOTTLENECK) + necks
    reduce = flops.dense(BOTTLENECK, REDUCED) * (view // 2 ** len(WIDTHS)) ** 2
    target = (enc + reduce + flops.dense(neck_in, HIDDEN)
              + flops.dense(HIDDEN, OUT))
    return flops.trained(online, first) + target


def _neck(net: R.Net, prefix: str, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(net.batch_norm_1d(net.dense(x, prefix + "fc0"),
                                     prefix + "bn0"))
    return net.dense(x, prefix + "fc1")


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class Step:
    """Online and target state, the configuration's optimizer, and the
    step on a batch."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor], extra: Dict[str, torch.Tensor],
                 precision: str):
        from perfbench.reference.optim import from_settings

        self.cfg, self.precision = cfg, precision
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.target = {k: extra["target." + k].clone() for k in params}
        self.target_stats = {k: v.clone() for k, v in stats.items()}
        self.reduce = extra["reduce_kernel"][0, 0].clone()
        self.opt = from_settings(cfg, self.params)

    def loss_and_grads(self, imgs: torch.Tensor, gen: torch.Generator):
        s = self.cfg["settings"]
        view, patch = s["task.view_size"], s["task.patch_size"]
        d = D.cmunet_draws(gen, imgs, view, BASE, SHIFT, patch,
                           s["task.mask_ratio"])
        v1, v2, active = d["view1"], d["view2"], d["active"]
        b = v1.shape[0]
        net = R.Net(self.params, self.stats, self.precision)
        latent, skips = R.unet_encoder(net, "encoder.", v1, active, len(WIDTHS))
        pixel = R.unet_decoder(net, "pixel_decoder.", latent, skips)
        feature = R.unet_decoder(net, "feature_decoder.", latent, skips)
        proj = _neck(net, "projector.", feature.mean(1).reshape(b, -1))
        pred = _neck(net, "predictor.", proj)

        tnet = R.Net(self.target, self.target_stats, self.precision)
        with torch.no_grad():
            t_latent, _ = R.unet_encoder(tnet, "encoder.", v2, None, len(WIDTHS))
            red = tnet.matmul(t_latent.permute(0, 2, 3, 1), self.reduce)
            t_proj = _neck(tnet, "projector.", red.reshape(b, -1))

        tgt = (v1 - v1.mean(-1, keepdim=True)) / torch.sqrt(
            (v1 - v1.mean(-1, keepdim=True)).square().mean(-1, keepdim=True)
            + 1e-6)
        hidden = 1.0 - active
        loss_rc = ((pixel[:, 1] - tgt).square() * hidden).sum() \
            / hidden.sum().clamp_min(1.0)
        temp = s["task.temperature"]
        score = _rows(pred) @ _rows(t_proj).t()
        loss_ct = 2.0 * temp * F.cross_entropy(
            score / temp, torch.arange(b, device=score.device))
        value = loss_ct + loss_rc
        names = list(self.params)
        grads = torch.autograd.grad(value, [self.params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        self._target_new = tnet.new_stats
        return value.detach(), grads, net.new_stats

    @torch.no_grad()
    def commit(self, new_stats: Dict[str, torch.Tensor]) -> None:
        """After the update: both nets' running statistics, then the EMA of
        the target's parameters toward the updated online ones."""
        self.stats.update(new_stats)
        self.target_stats.update(self._target_new)
        m = self.cfg["settings"]["task.ema_momentum"]
        for k, t in self.target.items():
            self.target[k] = m * t + (1.0 - m) * self.params[k].detach()

    def state(self):
        """(parameters, running statistics) by the program's names, the
        target's under "target."."""
        stats = dict(self.stats)
        stats.update({"target." + k: v for k, v in self.target_stats.items()})
        return ({k: v.detach() for k, v in self.params.items()}, stats)

    def targets(self) -> Dict[str, torch.Tensor]:
        """The EMA target's parameters by the online names."""
        return dict(self.target)
