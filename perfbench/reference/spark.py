"""Reference SparK train step (Tian et al., "Designing BERT for
Convolutional Networks: Sparse and Hierarchical Masked Modeling", ICLR
2023, with the full UNet decoder of the CM-UNet repository's Spark
pretraining): the masked UNet encoder, densify (masked batch norm, then a
learned token at every hidden cell), the UNet decoder with skips, and the
per-patch-normalised L2 loss on the hidden patches; the configuration's
optimizer (LAMB as the source trains it).

`settings` are the configuration file's program settings (dotted names)
with the model's widths beside them; see perfbench/configs.
"""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import draws as D
from perfbench.reference import nn as R


def _widths(cfg: dict):
    return list(cfg["widths"]), int(cfg["bottleneck_width"])


def param_spec(cfg: dict):
    """[(name, shape, init)] of the model's parameters and of its running
    statistics; init is "zeros", "ones", ("trunc", std): a normal cut at
    two deviations, or ("normal", std)."""
    widths, bneck = _widths(cfg)
    params, stats = R.encoder_spec("encoder.", widths, bneck)
    feats = [bneck] + list(reversed(widths))
    for i, c in enumerate(feats):
        params += [(f"mask_token{i}", (1, c, 1, 1), ("trunc", 0.02))]
        params += R.norm_spec(f"densify_norm{i}", c)
        stats += R.norm_stats(f"densify_norm{i}", c)
    dec, dec_stats = R.decoder_spec("decoder.", widths, bneck, 1)
    return params + dec, stats + dec_stats


def extra_spec(cfg: dict):
    return []


def image_flops(cfg: dict) -> float:
    """Model FLOPs of one image's step (perfbench.flops)."""
    from perfbench import flops

    size = cfg["settings"]["data.image_size"]
    widths, bneck = _widths(cfg)
    enc, first = flops.encoder(size, widths, bneck)
    return flops.trained(enc + flops.decoder(size, 1, widths, bneck), first)


def forward(net: R.Net, cfg: dict, imgs: torch.Tensor,
            active: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images and the (B, f, f) active grid -> (B, H, W)."""
    widths, _ = _widths(cfg)
    ratio = 2 ** len(widths)
    bott, skips = R.unet_encoder(net, "encoder.", imgs,
                                 R.upsample_nearest(active, ratio), len(widths))
    feats = [bott] + list(reversed(skips))
    cur = active
    dense = []
    for i, f in enumerate(feats):
        m = cur[:, None]
        f = net.batch_norm(f, f"densify_norm{i}", m)
        dense.append(torch.where(m > 0, f, net.params[f"mask_token{i}"]))
        cur = R.upsample_nearest(cur, 2)
    rec = R.unet_decoder(net, "decoder.", dense[0], list(reversed(dense[1:])))
    return rec[:, 0]


def loss(rec: torch.Tensor, imgs: torch.Tensor, active: torch.Tensor,
         patch: int) -> torch.Tensor:
    """Mean over hidden patches of the mean squared error against the
    patch normalised by its mean and sqrt(population variance + 1e-6)."""
    b, h, w = imgs.shape
    fh, fw = h // patch, w // patch

    def patches(x):
        return x.reshape(b, fh, patch, fw, patch).permute(0, 1, 3, 2, 4) \
            .reshape(b, fh * fw, patch * patch)

    x, r = patches(imgs), patches(rec)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    target = (x - mean) / torch.sqrt(var + 1e-6)
    l2 = (r - target).square().mean(-1)
    hidden = 1.0 - active.reshape(b, -1)
    return (l2 * hidden).sum() / (hidden.sum() + 1e-8)


class Step:
    """The reference's state (parameters, running statistics, the
    configuration's optimizer) and its step on a batch, with the step's
    draws made again from the seed."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor], extra: Dict[str, torch.Tensor],
                 precision: str):
        from perfbench.reference.optim import from_settings

        self.cfg, self.precision = cfg, precision
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.opt = from_settings(cfg, self.params)

    def loss_and_grads(self, imgs: torch.Tensor, gen: torch.Generator):
        s = self.cfg["settings"]
        widths, _ = _widths(self.cfg)
        patch = 2 ** len(widths)
        d = D.spark_draws(gen, imgs, s["data.image_size"] // patch,
                          s["task.mask_ratio"])
        net = R.Net(self.params, self.stats, self.precision)
        rec = forward(net, self.cfg, d["view"], d["active"])
        value = loss(rec.float(), d["view"], d["active"], patch)
        names = list(self.params)
        grads = torch.autograd.grad(value, [self.params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        return value.detach(), grads, net.new_stats

    def commit(self, new_stats: Dict[str, torch.Tensor]) -> None:
        """After the update: the running statistics the forward wrote."""
        self.stats.update(new_stats)

    def state(self):
        """(parameters, running statistics) by the program's names."""
        return ({k: v.detach() for k, v in self.params.items()},
                dict(self.stats))

    def targets(self) -> Dict[str, torch.Tensor]:
        """SparK has no EMA target."""
        return {}
