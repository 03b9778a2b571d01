"""Patch masks for SparK, MAE and CM-UNet, and patchify (port of
cmx/ops/masking.py).

An active mask has 1 = visible/kept, 0 = masked, as in cmx. Draws come from
an explicit torch.Generator; its numbers differ from jax.random's, so tests
inject cmx's draws (`u`) instead of re-drawing them.
"""

from __future__ import annotations

from typing import Optional

import torch


def _rank_below(u: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, True at the k smallest of `u` (the rank threshold)."""
    ranks = torch.argsort(torch.argsort(u, dim=-1, stable=True), dim=-1,
                          stable=True)
    return ranks < k


def random_patch_mask(gen: Optional[torch.Generator], batch: int,
                      img_size: int = 256, patch_size: int = 16,
                      mask_ratio: float = 0.5, shared: bool = False,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Active mask (B, H, W) on gen's (or u's) device: in each sample the
    k = int(ratio * H^2) // p^2 patches with the smallest of per-patch
    uniforms `u` (one row, or one per sample; drawn from `gen` unless given)
    are zeroed (MAE's create_random_patch_mask, Transformation_based/
    utils.py:169-194, as a rank threshold). `shared` gives every sample the
    first row's mask (the reference's mask[0] broadcast)."""
    f = img_size // patch_size
    n = f * f
    k = min(int(mask_ratio * img_size * img_size) // (patch_size * patch_size),
            n)
    if u is None:
        u = torch.rand((1 if shared else batch, n), generator=gen,
                       device=gen.device)
    active = ~_rank_below(u, k)
    active = upsample_mask(active.reshape(-1, f, f).float(), patch_size)
    return active.expand(batch, img_size, img_size) if shared else active


def spark_active_mask(gen: torch.Generator, batch: int, fmap_size: int,
                      mask_ratio: float = 0.6) -> torch.Tensor:
    """SparK active grid (B, f, f) on gen's device: per sample, keep
    max(1, round((1-ratio) * f^2)) random cells (Spark/spark.py:82-86)."""
    n = fmap_size * fmap_size
    len_keep = max(1, round(n * (1 - mask_ratio)))
    u = torch.rand((batch, n), generator=gen, device=gen.device)
    keep = _rank_below(u, len_keep)
    return keep.reshape(batch, fmap_size, fmap_size).float()


def upsample_mask(mask_grid: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-upsample a (B, f, f) grid to (B, f*factor, f*factor)."""
    return mask_grid.repeat_interleave(factor, dim=1).repeat_interleave(
        factor, dim=2)


def patchify(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W[, C]) -> (B, n_patches, patch_size^2 * C), channels last as
    cmx's."""
    if x.dim() == 3:
        x = x[..., None]
    b, h, w, c = x.shape
    fh, fw = h // patch_size, w // patch_size
    x = x.reshape(b, fh, patch_size, fw, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, fh * fw, patch_size * patch_size * c)


def unpatchify(p: torch.Tensor, patch_size: int, h: int, w: int,
               c: int = 1) -> torch.Tensor:
    """Inverse of patchify -> (B, H, W, C)."""
    b = p.shape[0]
    fh, fw = h // patch_size, w // patch_size
    x = p.reshape(b, fh, fw, patch_size, patch_size, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)
