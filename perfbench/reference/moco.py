"""Reference MoCo v2 train step (Chen et al., "Improved Baselines with
Momentum Contrastive Learning", arXiv:2003.04297, after He et al.,
arXiv:1911.05722) on the CM-UNet repository's UNet encoder
(Pretraining/MoCo/pl_bolts/models/self_supervised/moco/moco2_module.py:
338-395; its views, moco_data_module.py:119-132).

Views: two of each image, q then k, each from its own draws, taken from
the step's generator in this order: the rotation's angle U(-pi, pi) and
whether it applies (p 0.5); torchvision's RandomResizedCrop window (scale
(0.2, 1), ratio (3/4, 4/3)); whether the blur applies (p 0.5) and its sigma
U(0.1, 2); the horizontal and the vertical flip (p 0.5 each); whether the
noise applies (p 0.5) and a standard normal field of the view's size.
Then, in float32: the rotation about the image's centre, each output pixel
the input pixel nearest its source (ties to even), zero outside; the
window resampled to view^2 by the scale-and-translate map with a linear
(triangle) kernel, widened by 1/scale where it shrinks, each output's
weights normalised, outputs whose centre falls outside the input zeroed;
the Gaussian blur of radius 3 with replicated edges, rows then columns;
the flips; noise of the view's max / 10.

Step: q is the online encoder (the 5-level UNet encoder in training mode)
on the q view, its bottleneck averaged over H and W; k is the key encoder
on the k view, in training mode without gradient, with running statistics
of its own. Both are normalised over each row. The logits are [<q, k>,
q . queue^T] / T and the loss is their cross entropy against label 0.
SGD with momentum as the configuration states (perfbench/reference/
optim.py). After the update the key encoder's parameters move to
m * key + (1 - m) * online (m = task.ema_momentum), then the keys are
written at rows ptr .. ptr + B - 1 of the queue and ptr advances by B
modulo its length. The running statistics of both nets follow their
forwards.

Departure from MoCo: the key encoder starts drawn apart from the online
one (a key encoder that lags the online one, as after the first epochs),
where MoCo's starts as a copy; a copy would move by (1 - m) times each
update, under float32's rounding, and the comparison could not see the
EMA. Its running statistics start as a copy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference import draws as D
from perfbench.reference import nn as R

SCALE, RATIO = (0.2, 1.0), (3 / 4, 4 / 3)
BLUR_RADIUS = 3


def _widths(cfg: dict):
    return list(cfg["widths"]), int(cfg["bottleneck_width"])


def param_spec(cfg: dict):
    """The online encoder's parameters and running statistics."""
    widths, bneck = _widths(cfg)
    return R.encoder_spec("encoder.", widths, bneck)


def extra_spec(cfg: dict):
    """The queue of keys (task.num_negatives x the bottleneck width), each
    row of norm 1, and the key encoder's parameters, "target." and the
    online name, drawn as the online ones are."""
    _, bneck = _widths(cfg)
    params, _ = param_spec(cfg)
    queue = (cfg["settings"]["task.num_negatives"], bneck)
    return ([("queue", queue, ("unit_rows",))]
            + [("target." + n, shape, init) for n, shape, init in params])


def image_flops(cfg: dict) -> float:
    """Model FLOPs of one image's step (perfbench.flops): the online
    encoder trained, the key encoder's forward, and the query's product
    with the queue forward and backward (the queue takes no gradient)."""
    from perfbench import flops

    view = cfg["settings"]["task.view_size"]
    widths, bneck = _widths(cfg)
    enc, first = flops.encoder(view, widths, bneck)
    queue = flops.dense(bneck, cfg["settings"]["task.num_negatives"])
    return flops.trained(enc, first) + enc + 2 * queue


# ------------------------------------------------------------------ views

def rotate_nearest(imgs: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Each (H, W) image turned by angle[i] radians about its centre: the
    output pixel (y, x) takes the input pixel nearest to its source, zero
    where that lies outside the image."""
    b, h, w = imgs.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y = torch.arange(h, dtype=torch.float32, device=imgs.device)[:, None] - cy
    x = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :] - cx
    c = torch.cos(angle)[:, None, None]
    s = torch.sin(angle)[:, None, None]
    sy = torch.round(c * y - s * x + cy).long()
    sx = torch.round(s * y + c * x + cx).long()
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    rows = torch.arange(b, device=imgs.device)[:, None, None]
    got = imgs[rows, sy.clamp(0, h - 1), sx.clamp(0, w - 1)]
    return torch.where(inside, got, 0.0)


def linear_weights(n_in: int, n_out: int, start: torch.Tensor,
                   length: torch.Tensor) -> torch.Tensor:
    """(B, n_in, n_out) triangle-kernel weights that resample the span
    [start, start + length) of each row of n_in samples to n_out samples."""
    inv = length / n_out
    widen = torch.clamp(inv, min=1.0)
    centre = ((torch.arange(n_out, dtype=torch.float32, device=start.device)
               + 0.5)[None] * inv[:, None] + start[:, None] - 0.5)
    src = torch.arange(n_in, dtype=torch.float32, device=start.device)
    dist = (centre[:, None, :] - src[None, :, None]).abs() / widen[:, None, None]
    wts = torch.clamp(1.0 - dist, min=0.0)
    total = wts.sum(1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    wts = torch.where(total.abs() > eps,
                      wts / torch.where(total != 0, total, 1.0), 0.0)
    inside = (centre >= -0.5) & (centre <= n_in - 0.5)
    return torch.where(inside[:, None, :], wts, 0.0)


def crop_linear(imgs: torch.Tensor, boxes: torch.Tensor,
                out: int) -> torch.Tensor:
    """Each image's window (height, top, width, left) resampled to
    (out, out), rows then columns."""
    _, h, w = imgs.shape
    wy = linear_weights(h, out, boxes[:, 1], boxes[:, 0])
    wx = linear_weights(w, out, boxes[:, 3], boxes[:, 2])
    return torch.bmm(torch.bmm(wy.transpose(1, 2), imgs), wx)


def blur(imgs: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Each image blurred by its own Gaussian of radius 3 (taps normalised
    to sum 1), edges replicated: one grouped convolution down the rows,
    one along the columns."""
    b = imgs.shape[0]
    r = BLUR_RADIUS
    taps = torch.arange(-r, r + 1, dtype=torch.float32, device=imgs.device)
    k = torch.exp(-0.5 * (taps[None] / sigma[:, None]).square())
    k = k / k.sum(1, keepdim=True)
    x = F.pad(imgs[None], (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k[:, None, :, None], groups=b)
    return F.conv2d(x, k[:, None, None, :], groups=b)[0]


def moco_view(gen: torch.Generator, imgs: torch.Tensor,
              view: int) -> torch.Tensor:
    """One view of each (H, W) image, its draws from `gen` in the module's
    order."""
    b, h, w = imgs.shape
    dev = gen.device

    def uniform():
        return torch.rand((b,), generator=gen, device=dev)

    angle = (uniform() * 2.0 - 1.0) * math.pi
    rotate = uniform() < 0.5
    boxes = D.crop_boxes(gen, b, h, w, SCALE, RATIO)
    blurred = uniform() < 0.5
    sigma = 0.1 + 1.9 * uniform()
    hflip = uniform() < 0.5
    vflip = uniform() < 0.5
    noisy = uniform() < 0.5
    noise = torch.randn((b, view, view), generator=gen, device=dev)

    def where(pick, picked, other):
        return torch.where(pick[:, None, None], picked, other)

    x = imgs.float()
    x = where(rotate, rotate_nearest(x, angle), x)
    x = crop_linear(x, boxes, view)
    x = where(blurred, blur(x, sigma), x)
    x = where(hflip, x.flip(-1), x)
    x = where(vflip, x.flip(-2), x)
    top = x.amax(dim=(1, 2)) / 10.0
    return where(noisy, x + top[:, None, None] * noise, x)


# ------------------------------------------------------------------- step

def _rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _embed(net: R.Net, imgs: torch.Tensor, levels: int) -> torch.Tensor:
    latent, _ = R.unet_encoder(net, "encoder.", imgs, None, levels)
    return _rows(latent.mean((2, 3)))


class Step:
    """The online encoder, the key encoder, the queue and its pointer, the
    configuration's optimizer, and the step on a batch."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor], extra: Dict[str, torch.Tensor],
                 precision: str):
        from perfbench.reference.optim import from_settings

        self.cfg, self.precision = cfg, precision
        self.levels = len(_widths(cfg)[0])
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in stats.items()}
        self.target = {k: extra["target." + k].clone() for k in params}
        self.target_stats = {k: v.clone() for k, v in stats.items()}
        self.queue = extra["queue"].clone()
        self.ptr = 0
        self.opt = from_settings(cfg, self.params)

    def loss_and_grads(self, imgs: torch.Tensor, gen: torch.Generator):
        s = self.cfg["settings"]
        view = s["task.view_size"]
        vq = moco_view(gen, imgs, view)
        vk = moco_view(gen, imgs, view)
        net = R.Net(self.params, self.stats, self.precision)
        q = _embed(net, vq, self.levels)
        knet = R.Net(self.target, self.target_stats, self.precision)
        with torch.no_grad():
            k = _embed(knet, vk, self.levels)
        logits = torch.cat([(q * k).sum(1, keepdim=True),
                            net.matmul(q, self.queue.t())], 1)
        loss = F.cross_entropy(logits / s["task.temperature"],
                               torch.zeros(q.shape[0], dtype=torch.long,
                                           device=q.device))
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(self.params[n]) if g is None else g
                 for n, g in zip(names, grads)}
        self._keys, self._target_new = k, knet.new_stats
        return loss.detach(), grads, net.new_stats

    @torch.no_grad()
    def commit(self, new_stats: Dict[str, torch.Tensor]) -> None:
        """After the update: both nets' running statistics, the key
        encoder's EMA toward the updated online parameters, then the keys
        into the queue."""
        self.stats.update(new_stats)
        self.target_stats.update(self._target_new)
        m = self.cfg["settings"]["task.ema_momentum"]
        for k, t in self.target.items():
            self.target[k] = m * t + (1.0 - m) * self.params[k].detach()
        b = self._keys.shape[0]
        self.queue[self.ptr:self.ptr + b] = self._keys
        self.ptr = (self.ptr + b) % self.queue.shape[0]

    def state(self):
        """(parameters, running statistics) by the program's names, the key
        encoder's under "target."."""
        stats = dict(self.stats)
        stats.update({"target." + k: v for k, v in self.target_stats.items()})
        return ({k: v.detach() for k, v in self.params.items()}, stats)

    def targets(self) -> Dict[str, torch.Tensor]:
        """The key encoder's parameters by the online names."""
        return dict(self.target)
