"""MLP necks: CM-UNet's projector and predictor (port of
cmx/models/necks.py), and the row normalisation of the contrastive heads.

NonLinearNeck is fc0 -> BN -> ReLU -> fc1 (with_bias, no last BN, no
avg-pool: configs/cmunet_config.py:21-41), always in fp32 and returning
fp32, as cmx's, which CMUNetOnline builds with no dtype. Its BN is flax's
nn.BatchNorm over the batch axis: batch mean and the biased variance
E[x^2] - E[x]^2 (clamped at 0), running stats 0.9 * old + 0.1 * batch,
eps 1e-6. Not torch's BatchNorm1d, whose running variance is unbiased.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cmx_torch.models.blocks import Dense, MaskedBatchNorm
from cmx_torch.parallel import mesh
from cmx_torch.utils.profiling import span


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """Each row of (B, D) over its L2 norm, with no epsilon (CM-UNet's
    InfoNCE and MoCo's queries and keys, as cmx's)."""
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


class FeatureBatchNorm(MaskedBatchNorm):
    """flax nn.BatchNorm(momentum 0.9, epsilon 1e-6) over axis 0 of a
    (B, C) fp32 input (the same parameters, buffers and running update as
    MaskedBatchNorm; flax's moments and normalisation)."""

    def __init__(self, features: int):
        super().__init__(features, torch.float32, momentum=0.9, epsilon=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm", x) as sp:
            x = sp.inputs(x)
            if self.training:
                c = x.shape[1]
                # over the global batch (SyncBN under data parallel)
                sums = mesh.all_reduce_sync(torch.cat(
                    [x.sum(0), (x * x).sum(0), x.new_full((1,), x.shape[0])]))
                mean = sums[:c] / sums[2 * c:]
                var = torch.clamp(sums[c:2 * c] / sums[2 * c:] - mean * mean,
                                  min=0.0)
                self.update_running(mean.detach(), var.detach())
            else:
                mean, var = self.mean, self.var
            return sp.outputs(
                (x - mean) * (torch.rsqrt(var + self.epsilon) * self.scale)
                + self.bias)


class NonLinearNeck(nn.Module):
    """(B, in_features) -> (B, out_channels) fp32, cmx's parameter names
    (fc0, bn0, fc1)."""

    def __init__(self, in_features: int, hid_channels: int = 1536,
                 out_channels: int = 256):
        super().__init__()
        self.fc0 = Dense(in_features, hid_channels)
        self.bn0 = FeatureBatchNorm(hid_channels)
        self.fc1 = Dense(hid_channels, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc0(x.float())
        return self.fc1(torch.relu(self.bn0(x)))
