"""The collectives of data parallel over torch.distributed (port of
cmx/parallel/mesh.py).

cmx runs one global-view jitted program over a batch-sharded mesh: XLA
inserts the cross-device sums that make BN moments, gradients, loss
denominators and contrastive negatives global. The port runs W processes,
one per card (NCCL) or CPU (gloo), each with B/W of the global batch in
rank order, and calls those sums itself through this module:

  * `all_reduce_sum`: in place, no autograd (statistics the kernels
    produce, gradients, metrics);
  * `all_reduce_shared`: differentiable, backward the identity on each
    rank's share. For sums the loss is computed from: every rank holds the
    same global loss, and rank r's gradient is the part of the global
    gradient that its own samples make, which the gradient all-reduce then
    adds up. `global_mean` is a batch mean through it;
  * `all_reduce_sync`: differentiable, backward an all-reduce of the
    cotangents (BN moments, as SyncBatchNorm: the moments feed every rank's
    activations, so their cotangent is the sum of every rank's part);
  * `all_gather_batch` (rank order, no autograd), `replicate` (broadcast
    from rank 0), `rank_slice` (a rank's rows of a global-batch tensor) and
    `barrier`.

Each is a no-op when no process group exists, so a run without one is
unchanged. Under a group of one process every collective is the identity
(the values keep their bits). `counts` holds the calls and bytes of each
collective ("all_reduce", "grad_all_reduce", "all_gather", "broadcast",
"barrier", each also as "<op>_bytes"); tests and chip_smoke.py read it, as
they read the kernels' `.launches`. Shards are equal: every rank holds B/W
rows.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, List, Sequence

import torch
import torch.distributed as dist

counts: collections.Counter = collections.Counter()


def active() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def info() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if not active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return info()[1]


def backend() -> str:
    """The group's backend ("nccl", "gloo"), or "none"."""
    return dist.get_backend() if active() else "none"


def reset_counts() -> None:
    counts.clear()


def _count(op: str, tensors: Iterable[torch.Tensor]) -> None:
    counts[op] += 1
    counts[op + "_bytes"] += sum(t.numel() * t.element_size()
                                 for t in tensors)


def all_reduce_sum(t: torch.Tensor, op: str = "all_reduce") -> torch.Tensor:
    """Sum `t` over the ranks, in place (no autograd); returns `t`."""
    if active():
        _count(op, [t])
        dist.all_reduce(t)
    return t


def all_reduce_sum_many(*ts: torch.Tensor) -> tuple:
    """The sums over the ranks of several tensors, packed into one fp32
    all-reduce; the inputs are left as they are (no autograd)."""
    if not active():
        return ts
    flat = torch.cat([t.detach().float().reshape(-1) for t in ts])
    all_reduce_sum(flat)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return tuple(out)


def all_reduce_tensors(ts: Sequence[torch.Tensor],
                       op: str = "grad_all_reduce") -> List[torch.Tensor]:
    """The sums over the ranks of `ts`, one all-reduce of a flat buffer per
    dtype (the gradients: 4 bytes a parameter in fp32). Each sum keeps its
    tensor's strides (a strided one is written back into it), so what reads
    them reduces in the same order as without a group."""
    if not active():
        return list(ts)
    out: List[Any] = [None] * len(ts)
    by_dtype = collections.defaultdict(list)
    for i, t in enumerate(ts):
        by_dtype[t.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([ts[i].reshape(-1) for i in idx])
        all_reduce_sum(flat, op)
        j = 0
        for i in idx:
            n = ts[i].numel()
            v = flat[j:j + n].view_as(ts[i])
            out[i] = v if ts[i].is_contiguous() else ts[i].copy_(v)
            j += n
    return out


class _SharedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return g


class _SyncSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone())


def all_reduce_shared(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, the backward the identity on each
    rank's share: for the sums a loss is computed from (Dice's tp/fp/fn, a
    loss's numerator and denominator)."""
    return _SharedSum.apply(x) if active() else x


def all_reduce_sync(x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks of `x`, the backward an all-reduce of the
    cotangents: for batch moments that feed every rank's activations."""
    return _SyncSum.apply(x) if active() else x


def global_mean(local_mean: torch.Tensor) -> torch.Tensor:
    """The global batch mean from each rank's mean over its equal shard,
    through `all_reduce_shared` (the division by a world size of 1 is
    exact, so one process keeps its bits)."""
    if not active():
        return local_mean
    return all_reduce_shared(local_mean / world_size())


def all_gather_batch(x: torch.Tensor) -> torch.Tensor:
    """(W*b, ...) from each rank's (b, ...), in rank order; no autograd.
    One all-reduce of a zero-padded buffer (gloo takes all-reduces of CUDA
    tensors, not gathers)."""
    rank, world = info()
    if world == 1:
        if active():
            _count("all_gather", [x])
        return x
    b = x.shape[0]
    buf = torch.zeros((world * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    buf[rank * b:(rank + 1) * b] = x.detach()
    _count("all_gather", [buf])
    dist.all_reduce(buf)
    return buf


def _tensors_of(obj: Any) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, torch.nn.Module):
        return list(obj.state_dict().values())
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors_of(v)]
    return []


@torch.no_grad()
def replicate(*objs: Any) -> None:
    """Broadcast from rank 0, in place, every tensor of `objs` (modules'
    parameters and buffers, tensors, dicts and lists of them)."""
    if not active():
        return
    for t in _tensors_of(objs):
        _count("broadcast", [t])
        dist.broadcast(t, 0)


def barrier() -> None:
    if active():
        _count("barrier", [])
        dist.barrier()


def global_batch(b: int) -> int:
    """The global batch of a rank's batch of `b`."""
    return b * world_size()


def rank_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor (the rows r*B/W ..
    (r+1)*B/W - 1): the rank's own samples, as cmx's batch sharding lays
    them out."""
    rank, world = info()
    if world == 1:
        return x
    b, rem = divmod(x.shape[0], world)
    if rem:
        raise ValueError(f"a global batch of {x.shape[0]} does not split "
                         f"over {world} ranks")
    return x[rank * b:(rank + 1) * b]


def rank_slice_draws(draws: dict) -> dict:
    """`rank_slice` of every tensor of a dict of global-batch draws."""
    return {k: rank_slice(v) if isinstance(v, torch.Tensor) else v
            for k, v in draws.items()}
