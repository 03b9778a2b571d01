"""Process layout and host-sharded sampling (port of cmx/parallel/dist.py).

cmx wires its processes with `jax.distributed.initialize()`; the port runs
one process per card over torch.distributed, from the environment that
torch's launchers (torchrun) set: `initialize_distributed` makes the process
group (NCCL for CUDA, gloo for the CPU) when WORLD_SIZE is set, and nothing
when it is absent (one process, as before). `process_info` is (rank, world
size), `shutdown` ends the group, and `InfiniteBatchSampler` is a copy of
cmx's: the same seeded per-epoch permutations, each rank its contiguous
block, so the CLI draws the same batch indices as cmx's. The collectives
are cmx_torch.parallel.mesh's.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from cmx_torch.parallel import mesh

# What a run of more than one process needs from its launcher.
_LAUNCH_VARS = ("RANK", "MASTER_ADDR", "MASTER_PORT")


def local_rank() -> int:
    """The process's card on its host (torchrun's LOCAL_RANK, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize_distributed(device="cuda", backend: Optional[str] = None
                           ) -> bool:
    """Make the process group from torch's launcher environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL when `device` is
    CUDA (each process on cuda:LOCAL_RANK), gloo on the CPU, or `backend`.
    Without WORLD_SIZE, or with a group already made, it makes nothing.
    Returns whether it made the group (its maker calls `shutdown`)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    world = int(os.environ["WORLD_SIZE"])
    missing = [k for k in _LAUNCH_VARS if k not in os.environ]
    if world > 1 and missing:
        raise RuntimeError(
            f"WORLD_SIZE={world} asks for a run of {world} processes but "
            f"{', '.join(missing)} is not set: launch it with torchrun "
            "(torchrun --nproc_per_node N -m cmx_torch.cli.pretrain ...)")
    os.environ.setdefault("RANK", "0")
    os.environ.setdefault("MASTER_ADDR", "localhost")
    if "MASTER_PORT" not in os.environ:  # one process: any free port
        with socket.socket() as s:
            s.bind(("localhost", 0))
            os.environ["MASTER_PORT"] = str(s.getsockname()[1])
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    kw = {}
    if cuda:
        torch.cuda.set_device(local_rank())
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local_rank())
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(minutes=10), **kw)
    return True


def shutdown() -> None:
    """End the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """(process_index, process_count): the group's (rank, world size), or
    (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return process_info()[0] == 0


def on_main(write: Callable[..., Any], *args, **kwargs) -> Any:
    """`write(*args, **kwargs)` on rank 0 alone (None elsewhere), then a
    barrier, so no rank reads or writes the run's files before rank 0 has
    written them. Without a process group, `write` runs."""
    out = write(*args, **kwargs) if is_main() else None
    mesh.barrier()
    return out


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
