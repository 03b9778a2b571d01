"""Device-side losses and metrics (port of cmx/eval/metrics.py).

Every function of cmx's module, in torch, with the class axis at 1:
predictions are NCHW logits (B, C, H, W) and targets one-hot float NCHW,
where cmx has both class-last. Host-only metrics (Hausdorff, artery radius)
live in cmx_torch.eval.host_metrics.

As in cmx (and the reference, Finetuning/train.py:455):
  * `dice_loss(..., threshold=0.5)` binarizes the softmax with a hard
    threshold, so its gradient is zero and the fine-tune loss trains through
    its cross entropy alone; `threshold=None` gives a soft Dice.
  * f-score and IoU reduce over the whole batch (one tp/fp/fn sum), not per
    image.
Under data parallel (cmx_torch.parallel.mesh) the f-score's and IoU's sums,
and the cross entropy's and MSE's means, are over the global batch, as in
cmx's global-view step: every rank gets the global value, and its backward
gives the rank's own part of the gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from cmx_torch.parallel import mesh

# ---------------------------------------------------------------- helpers


def softmax_channels(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the class axis (1)."""
    return torch.softmax(x, dim=1)


def _apply_activation(x: torch.Tensor, activation: Optional[str]) -> torch.Tensor:
    if activation is None or activation == "identity":
        return x
    if activation in ("softmax", "softmax2d"):
        return softmax_channels(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "logsoftmax":
        return torch.log_softmax(x, dim=1)
    if activation == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {activation!r}")


def _threshold(x: torch.Tensor, threshold: Optional[float]) -> torch.Tensor:
    """Hard binarization; no gradient flows through it."""
    if threshold is None:
        return x
    return (x > threshold).to(x.dtype)


def _take_channels(*xs: torch.Tensor,
                   ignore_channels: Optional[Sequence[int]]):
    """Drop the listed class channels (axis 1)."""
    if ignore_channels is None:
        return xs
    keep = [c for c in range(xs[0].shape[1]) if c not in ignore_channels]
    return tuple(x[:, keep] for x in xs)


# ---------------------------------------------------------------- f-score / dice


def f_score(pr: torch.Tensor, gt: torch.Tensor, beta: float = 1.0,
            eps: float = 1e-5, threshold: Optional[float] = None,
            ignore_channels: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Soft F-beta over the whole batch."""
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, gt, ignore_channels=ignore_channels)
    sums = mesh.all_reduce_shared(
        torch.stack([torch.sum(gt * pr), torch.sum(pr), torch.sum(gt)]))
    tp = sums[0]
    fp = sums[1] - tp
    fn = sums[2] - tp
    b2 = beta * beta
    return ((1 + b2) * tp + eps) / ((1 + b2) * tp + b2 * fn + fp + eps)


def dice_loss(logits: torch.Tensor, target: torch.Tensor, *,
              activation: Optional[str] = "softmax",
              threshold: Optional[float] = 0.5,
              ignore_channels: Optional[Sequence[int]] = (0,),
              eps: float = 1e-5, beta: float = 1.0) -> torch.Tensor:
    """1 - f_score, with the reference's defaults."""
    pr = _apply_activation(logits, activation)
    return 1.0 - f_score(pr, target, beta=beta, eps=eps, threshold=threshold,
                         ignore_channels=ignore_channels)


def iou_loss(logits: torch.Tensor, target: torch.Tensor, *,
             activation: Optional[str] = "softmax",
             threshold: Optional[float] = 0.5,
             ignore_channels: Optional[Sequence[int]] = (0,),
             eps: float = 1e-7) -> torch.Tensor:
    """1 - IoU."""
    pr = _apply_activation(logits, activation)
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, target, ignore_channels=ignore_channels)
    sums = mesh.all_reduce_shared(
        torch.stack([torch.sum(gt * pr), torch.sum(gt), torch.sum(pr)]))
    inter = sums[0]
    union = sums[1] + sums[2] - inter + eps
    return 1.0 - (inter + eps) / union


# ---------------------------------------------------------------- cross entropy


def cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pixelwise CE with probabilistic (one-hot float) targets, the mean over
    the batch and the pixels: -sum_c target_c * log_softmax(logits)_c."""
    logp = torch.log_softmax(logits.float(), dim=1)
    return mesh.global_mean(-torch.mean(torch.sum(target * logp, dim=1)))


def nll_loss(log_probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """NLL given log-probabilities and one-hot targets."""
    return -torch.mean(torch.sum(target * log_probs, dim=1))


def bce_with_logits_loss(logits: torch.Tensor,
                         target: torch.Tensor) -> torch.Tensor:
    z = logits.float()
    return torch.mean(torch.clamp(z, min=0) - z * target
                      + torch.log1p(torch.exp(-torch.abs(z))))


def label_smooth_loss(logits: torch.Tensor, target: torch.Tensor,
                      smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed CE with one-hot targets."""
    n = logits.shape[1]
    smoothed = target * (1.0 - smoothing) + smoothing / n
    return cross_entropy_loss(logits, smoothed)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return mesh.global_mean(
        torch.mean(torch.square(pred.float() - target.float())))


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


# ---------------------------------------------------------------- soft skeleton


def _soft_erode(img: torch.Tensor) -> torch.Tensor:
    """min over 3x1 and 1x3 windows, -maxpool(-x). max_pool2d pads with
    -inf, as flax's max_pool does, so a border pixel takes the min of the
    pixels inside the image."""
    p1 = -F.max_pool2d(-img, (3, 1), stride=1, padding=(1, 0))
    p2 = -F.max_pool2d(-img, (1, 3), stride=1, padding=(0, 1))
    return torch.minimum(p1, p2)


def _soft_dilate(img: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(img, 3, stride=1, padding=1)


def _soft_open(img: torch.Tensor) -> torch.Tensor:
    return _soft_dilate(_soft_erode(img))


def soft_skeletonize(img: torch.Tensor, num_iter: int = 10) -> torch.Tensor:
    """Iterative morphological soft skeleton of an NCHW map."""
    skel = torch.relu(img - _soft_open(img))
    for _ in range(num_iter):
        img = _soft_erode(img)
        delta = torch.relu(img - _soft_open(img))
        skel = skel + torch.relu(delta - skel * delta)
    return skel


def soft_cldice_loss(logits: torch.Tensor, target: torch.Tensor, *,
                     activation: Optional[str] = "softmax",
                     threshold: Optional[float] = 0.5,
                     ignore_channels: Optional[Sequence[int]] = (0,),
                     num_iter: int = 10, smooth: float = 1.0) -> torch.Tensor:
    """Soft clDice, with the reference's defaults."""
    pr = _apply_activation(logits, activation)
    pr = _threshold(pr, threshold)
    pr, gt = _take_channels(pr, target, ignore_channels=ignore_channels)
    skel_pr = soft_skeletonize(pr, num_iter=num_iter)
    skel_gt = soft_skeletonize(gt, num_iter=num_iter)
    tprec = (torch.sum(skel_pr * gt) + smooth) / (torch.sum(skel_pr) + smooth)
    tsens = (torch.sum(skel_gt * pr) + smooth) / (torch.sum(skel_gt) + smooth)
    return 1.0 - 2.0 * (tprec * tsens) / (tprec + tsens)


def soft_dice(y_true: torch.Tensor, y_pred: torch.Tensor,
              smooth: float = 1.0) -> torch.Tensor:
    """Plain soft dice loss."""
    inter = torch.sum(y_true * y_pred)
    coeff = (2.0 * inter + smooth) / (torch.sum(y_true) + torch.sum(y_pred)
                                      + smooth)
    return 1.0 - coeff


# ---------------------------------------------------------------- named metric set


def segmentation_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The fine-tune training loss: thresholded Dice + CE."""
    return dice_loss(logits, target) + cross_entropy_loss(logits, target)


def segmentation_metrics(logits: torch.Tensor, target: torch.Tensor,
                         cheap: bool = False) -> dict:
    """dice_loss, cross_entropy_loss, iou_loss and, unless `cheap`,
    soft_clDice (its 10-iteration skeleton is ~40 full-resolution max-pool
    passes: the train step leaves it to validation, as cmx's does)."""
    out = {
        "dice_loss": dice_loss(logits, target),
        "cross_entropy_loss": cross_entropy_loss(logits, target),
        "iou_loss": iou_loss(logits, target),
    }
    if not cheap:
        out["soft_clDice"] = soft_cldice_loss(logits, target)
    return out
