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
  * `all_reduce_max`: in place, no autograd (the shift of the BN
    variant "shift_max": a max over the global batch, with no gradient);
  * `all_gather_batch` (rank order, no autograd), `replicate` (broadcast
    from rank 0), `rank_slice` (a rank's rows of a global-batch tensor) and
    `barrier`.

Each is a no-op when no process group exists, so a run without one is
unchanged. Under a group of one process every collective is the identity
(the values keep their bits). `counts` holds the calls and bytes of each
collective ("all_reduce", "all_reduce_max", "grad_all_reduce",
"all_gather", "broadcast", "barrier", each also as "<op>_bytes"); tests
and chip_smoke.py read it, as they read the kernels' `.launches`. Shards
are equal: every rank holds B/W rows.

Scopes. Every collective, `info()`, `world_size()`, `global_batch()` and
`rank_slice()` read the current scope, the world group unless one of two
`with` blocks says otherwise:
  * `sub_group(k)`: the first k ranks (cmx's `make_mesh(jax.devices()[:k])`,
    the fine-tune's gcd submesh). Every rank of the world enters it: the
    group is made once per k by `dist.new_group`, a call every rank makes
    in the same order. It yields whether this rank is a member; inside it a
    rank that is not one may run no collective (they raise);
  * `local()`: every collective a no-op, this process alone (work that cmx
    replicates, as the fine-tune's validation).
Without a group both change nothing. A differentiable sum's backward runs
in the scope its forward ran in (`scope()` / `in_scope()`): autograd may
call it after the `with` block has exited.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Iterable, Iterator, List, Sequence

import torch
import torch.distributed as dist

counts: collections.Counter = collections.Counter()

# The scope stack (module state: autograd's device threads must see it).
# An entry is a sub group's ProcessGroup, _LOCAL or _OUTSIDE; empty is
# the world group.
_LOCAL = "local"      # every collective a no-op
_OUTSIDE = "outside"  # a rank outside the sub group: collectives raise
_scopes: List[Any] = []
_groups: dict = {}    # k -> the group of the first k ranks, of _groups_of
_groups_of: List[Any] = [None]  # the world group those groups came from


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def scope() -> Any:
    """The current scope (None: the world group); `in_scope` re-enters it."""
    return _scopes[-1] if _scopes else None


@contextlib.contextmanager
def in_scope(s: Any) -> Iterator[None]:
    """Run the block in scope `s` (a value `scope()` returned)."""
    _scopes.append(s)
    try:
        yield
    finally:
        _scopes.pop()


def _group() -> Any:
    """The current scope's group (None: the world); raises on a rank
    outside the current sub group."""
    s = scope()
    if s is _OUTSIDE:
        raise RuntimeError(f"rank {dist.get_rank()} is outside the current "
                           "sub group and may run no collective in it")
    return s


@contextlib.contextmanager
def local() -> Iterator[None]:
    """This process alone: every collective in the block is a no-op."""
    with in_scope(_LOCAL):
        yield


@contextlib.contextmanager
def sub_group(k: int) -> Iterator[bool]:
    """The first `k` ranks of the world as the block's group; yields
    whether this rank is one of them. Every rank of the world must enter
    it (making the group is a collective call). k equal to the world size
    is the world group; without a process group it changes nothing."""
    if not _initialized():
        yield True
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    if not 1 <= k <= world:
        raise ValueError(f"a sub group of {k} ranks in a world of {world}")
    if k == world:
        group = None
    else:
        if _groups_of[0] is not dist.group.WORLD:  # a new world: new groups
            _groups.clear()
            _groups_of[0] = dist.group.WORLD
        if k not in _groups:
            _groups[k] = dist.new_group(ranks=list(range(k)))
        group = _groups[k]
    with in_scope(group if rank < k else _OUTSIDE):
        yield rank < k


def active() -> bool:
    """Whether collectives run: a process group exists and the scope is not
    `local()`."""
    return _initialized() and _group() is not _LOCAL


def info() -> tuple:
    """(rank, world size) in the current scope: (0, 1) without a process
    group or under `local()`."""
    if not active():
        return 0, 1
    g = _group()
    return dist.get_rank(g), dist.get_world_size(g)


def world_size() -> int:
    return info()[1]


def backend() -> str:
    """The current scope's backend ("nccl", "gloo"), or "none"."""
    return dist.get_backend(_group()) if active() else "none"


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
        dist.all_reduce(t, group=_group())
    return t


def all_reduce_max(t: torch.Tensor) -> torch.Tensor:
    """The max over the ranks of `t`, in place (no autograd); returns `t`."""
    if active():
        _count("all_reduce_max", [t])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_group())
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
        ctx.scope = scope()
        return all_reduce_sum(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        with in_scope(ctx.scope):  # the forward's group, not the caller's
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
    dist.all_reduce(buf, group=_group())
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
    g = _group()
    for t in _tensors_of(objs):
        _count("broadcast", [t])
        dist.broadcast(t, 0, group=g)  # world rank 0 is in every scope's


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` (picklable: logs, counters) on every rank."""
    if not active():
        return obj
    box = [obj]
    _count("broadcast", [])
    dist.broadcast_object_list(box, 0, group=_group())
    return box[0]


def barrier() -> None:
    if active():
        _count("barrier", [])
        dist.barrier(group=_group())


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


def pad_to_multiple(n: int, m: int) -> int:
    """n rounded up to a multiple of m (cmx's pad_to_multiple)."""
    return ((n + m - 1) // m) * m
