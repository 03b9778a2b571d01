"""SparK patch masks (port of cmx/ops/masking.py:56-79).

An active mask has 1 = visible/kept, 0 = masked, as in cmx. Draws come from
an explicit torch.Generator; its numbers differ from jax.random's, so tests
inject cmx's draws instead of re-drawing them.
"""

from __future__ import annotations

import torch


def spark_active_mask(gen: torch.Generator, batch: int, fmap_size: int,
                      mask_ratio: float = 0.6) -> torch.Tensor:
    """SparK active grid (B, f, f) on gen's device: per sample, keep
    max(1, round((1-ratio) * f^2)) random cells (Spark/spark.py:82-86)."""
    n = fmap_size * fmap_size
    len_keep = max(1, round(n * (1 - mask_ratio)))
    u = torch.rand((batch, n), generator=gen, device=gen.device)
    ranks = torch.argsort(torch.argsort(u, dim=-1), dim=-1)
    keep = ranks < len_keep
    return keep.reshape(batch, fmap_size, fmap_size).float()


def upsample_mask(mask_grid: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-upsample a (B, f, f) grid to (B, f*factor, f*factor)."""
    return mask_grid.repeat_interleave(factor, dim=1).repeat_interleave(
        factor, dim=2)
