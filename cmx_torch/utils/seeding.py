"""Determinism control (port of cmx/utils/seeding.py).

cmx seeds the host RNGs and returns the root jax key; the port seeds the
host RNGs (python, numpy) and returns a torch.Generator. The port's device
draws are keyed by (seed, step) in `TrainState.step_generator`, so a
resumed run draws what an uninterrupted one does.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int = 42) -> torch.Generator:
    """Seed host RNGs and return a CPU generator seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
