"""Process layout and host-sharded sampling (port of cmx/parallel/dist.py).

The port runs one process on one card. `initialize_distributed` raises when
the environment asks for more (ROADMAP: Data parallel), `process_info` is
(0, 1), and `InfiniteBatchSampler` is a copy of cmx's: the same seeded
per-epoch permutations, so the CLI draws the same batch indices as cmx's.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

def initialize_distributed() -> None:
    """One process: nothing to initialize. Raises NotImplementedError when
    the environment asks for more than one process (torch.distributed's
    launchers set WORLD_SIZE)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world} asks for a multi-process run; the port runs "
            f"one process on one card (ROADMAP: Data parallel)")


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of the one process: (0, 1)."""
    return 0, 1


class InfiniteBatchSampler:
    """Host-sharded, epoch-filling, seeded infinite batch sampler.

    Semantics of DistInfiniteBatchSampler (Spark/sampler.py:21-67): each epoch
    draws a fresh permutation from a deterministic per-epoch seed, pads it to
    fill `world * batch * iters_per_epoch`, and each host consumes its
    rank-strided slice. Yields index arrays of length `batch_size`
    (the per-host batch).
    """

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        rank: int = 0,
        world_size: int = 1,
        seed: int = 0,
        shuffle: bool = True,
        fill_last: bool = True,
    ):
        if dataset_len <= 0:
            raise ValueError("dataset_len must be positive")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.seed = seed
        self.shuffle = shuffle
        global_batch = batch_size * world_size
        self.iters_per_epoch = (
            (dataset_len + global_batch - 1) // global_batch
            if fill_last
            else max(dataset_len // global_batch, 1)
        )
        self.epoch = 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        g = np.random.default_rng(self.seed + epoch)
        idx = (
            g.permutation(self.dataset_len)
            if self.shuffle
            else np.arange(self.dataset_len)
        )
        need = self.iters_per_epoch * self.batch_size * self.world_size
        reps = (need + self.dataset_len - 1) // self.dataset_len
        idx = np.tile(idx, reps)[:need]
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            idx = self._epoch_indices(self.epoch)
            # rank-sliced: contiguous per-rank block, like sampler.py's
            # rank*per_rank slice of the filled permutation
            per_rank = self.iters_per_epoch * self.batch_size
            mine = idx[self.rank * per_rank : (self.rank + 1) * per_rank]
            for i in range(self.iters_per_epoch):
                yield mine[i * self.batch_size : (i + 1) * self.batch_size]
            self.epoch += 1
