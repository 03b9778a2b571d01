"""Linear / MLP probe evaluation of pretrained encoders (port of
cmx/ssl/linear_probe.py).

A small head trained full-batch on FROZEN GAP features measures
representation quality (pl_bolts' SSLEvaluator MLP probe and SSLFineTuner's
linear eval). The labels are segmentation-derived (quantile buckets of the
foreground fraction): the FAME2 task has no image-level classes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from cmx_torch.train.optim import AdamW


def fg_fraction_labels(masks: np.ndarray, n_buckets: int = 4) -> np.ndarray:
    """Image-level labels = quantile bucket of the foreground fraction.
    `masks`: the port's one-hot (N, C, H, W) (the foreground is class 1) or
    (N, H, W)."""
    masks = np.asarray(masks)
    frac = (masks[:, 1].mean(axis=(1, 2)) if masks.ndim == 4
            else masks.mean(axis=(1, 2)))
    qs = np.quantile(frac, np.linspace(0, 1, n_buckets + 1)[1:-1])
    return np.digitize(frac, qs).astype(np.int32)


def extract_features(model: torch.nn.Module, imgs: np.ndarray,
                     batch: int = 32) -> torch.Tensor:
    """Frozen GAP embeddings (N, D) of (N, H, W) images, on the model's
    device: `model` (a UNetEncoderGAP) in eval mode, in batches of `batch`,
    the last padded with copies of its first image, as cmx pads it."""
    dev = next(model.parameters()).device
    model.eval()
    feats = []
    with torch.no_grad():
        for i in range(0, imgs.shape[0], batch):
            xb = imgs[i: i + batch]
            real = xb.shape[0]
            if real < batch:
                xb = np.concatenate([xb, xb[:1].repeat(batch - real, 0)])
            x = torch.from_numpy(np.ascontiguousarray(xb, np.float32))
            feats.append(model(x.to(dev))[:real])
    return torch.cat(feats)


def _probe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 keep=(None, None), p: float = 0.0) -> torch.Tensor:
    """SSLEvaluator forward (evaluator.py:10-26), cmx's _probe_apply.

    Linear head:  Dropout -> Linear(in, classes)
    MLP head:     Dropout -> Linear(in, hidden, no bias) -> BatchNorm1d ->
                  ReLU -> Dropout -> Linear(hidden, classes)
    The BatchNorm normalizes with the batch's own statistics (biased
    variance, eps 1e-5) in training and at evaluation alike. `keep`: the
    two dropouts' keep masks, None for no dropout."""
    scale = torch.tensor(1.0 - p, dtype=torch.float32, device=x.device)

    def drop(h, k):
        return h if k is None else torch.where(k, h / scale,
                                               torch.zeros_like(h))

    if "w_hidden" in params:
        h = drop(x, keep[0]) @ params["w_hidden"]
        mean = h.mean(0)
        var = h.var(0, unbiased=False)
        h = (h - mean) * torch.rsqrt(var + 1e-5)
        h = torch.relu(h * params["bn_scale"] + params["bn_bias"])
        h = drop(h, keep[1])
        return h @ params["w_out"] + params["b_out"]
    return drop(x, keep[0]) @ params["w_out"] + params["b_out"]


def probe(feats, labels: np.ndarray, *, n_classes: Optional[int] = None,
          hidden_dim: Optional[int] = None, dropout: float = 0.1,
          lr: float = 1e-2, steps: int = 500, seed: int = 0,
          test_fraction: float = 0.25,
          draws: Optional[Dict[str, torch.Tensor]] = None
          ) -> Dict[str, float]:
    """Train an SSLEvaluator-style probe on frozen features (N, D) (a
    tensor, or an array) on their device; returns train/test accuracy and
    the last step's loss.

    `hidden_dim=None` is the linear classifier, 512 the reference's MLP
    probe. The split is cmx's (numpy's default_rng(seed) permutation, the
    first max(1, int(N * test_fraction)) for test); `steps` full-batch
    steps of Adam (optax.adam(lr): Python-float hyperparameters, the port's
    AdamW without decay). `draws` may inject the random draws, as tests do
    with cmx's: "w_hidden" (D, hidden) and "w_out" (hidden, classes)
    standard normals, "keep0" (steps, N_train, D) and "keep1" (steps,
    N_train, hidden) dropout keep masks; whatever is missing is drawn from
    a torch.Generator(seed) on the features' device."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    dev = feats.device
    draws = draws or {}
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_classes = n_classes or int(labels.max()) + 1
    order = np.random.default_rng(seed).permutation(len(feats))
    n_test = max(1, int(len(feats) * test_fraction))
    te, tr = (torch.from_numpy(order[:n_test]).to(dev),
              torch.from_numpy(order[n_test:]).to(dev))
    y = torch.from_numpy(np.asarray(labels, np.int64)).to(dev)
    x_tr, y_tr, x_te, y_te = feats[tr], y[tr], feats[te], y[te]

    def normal(name, shape):
        z = draws.get(name)
        if z is None:
            return torch.randn(shape, generator=gen, device=dev)
        return torch.as_tensor(z, dtype=torch.float32).to(dev)

    def fan_in_scale(n):  # cmx's fp32 1 / np.sqrt(n)
        return torch.tensor(np.float32(1.0 / np.sqrt(n)), device=dev)

    d = feats.shape[1]
    if hidden_dim:
        params = {
            "w_hidden": normal("w_hidden", (d, hidden_dim)) * fan_in_scale(d),
            "bn_scale": torch.ones(hidden_dim, device=dev),
            "bn_bias": torch.zeros(hidden_dim, device=dev),
            "w_out": normal("w_out", (hidden_dim, n_classes))
            * fan_in_scale(hidden_dim),
            "b_out": torch.zeros(n_classes, device=dev)}
    else:
        params = {"w_out": torch.zeros((d, n_classes), device=dev),
                  "b_out": torch.zeros(n_classes, device=dev)}
    for t in params.values():
        t.requires_grad_(True)
    tx = AdamW(list(params.items()), lr, 0.0)
    tx.decay = [False] * len(tx.params)

    def keep(name, i, width):
        if dropout <= 0.0:
            return None
        k = draws.get(name)
        if k is None:
            return torch.rand((x_tr.shape[0], width), generator=gen,
                              device=dev) < 1.0 - dropout
        return torch.as_tensor(k[i]).to(dev)

    losses = []
    for i in range(steps):
        masks = (keep("keep0", i, d),
                 keep("keep1", i, hidden_dim) if hidden_dim else None)
        logits = _probe_apply(params, x_tr, masks, dropout)
        # optax.softmax_cross_entropy_with_integer_labels, then the mean
        loss = (torch.logsumexp(logits, -1)
                - logits.gather(1, y_tr[:, None])[:, 0]).mean()
        grads = torch.autograd.grad(loss, tx.params)
        tx.step(grads)
        losses.append(loss.detach())

    with torch.no_grad():
        def acc(x, y):
            return (_probe_apply(params, x).argmax(-1) == y).float().mean()

        out = torch.stack([acc(x_tr, y_tr), acc(x_te, y_te),
                           losses[-1]]).tolist()
    return dict(zip(("train_acc", "test_acc", "final_loss"), out))


def linear_probe(feats, labels: np.ndarray, **kw) -> Dict[str, float]:
    """Linear-only probe (cmx's back-compat wrapper around `probe`)."""
    kw.setdefault("hidden_dim", None)
    kw.setdefault("dropout", 0.0)
    return probe(feats, labels, **kw)
