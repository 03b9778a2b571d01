"""The fine-tune harness: epoch loop, grid search, K-fold, final test (port
of cmx/train/harness.py).

Counterpart of Finetuning/train.py's L3 layer:
  * `fit`: one supervised fine-tune run with Adam(lr) and per-epoch
    validation, the best state kept by validation dice_loss (train.py:193-214);
  * `grid_search`: the lr x epochs x batch grid with 3-fold KFold
    (main_finetuning, train.py:311-378);
  * `evaluate`: the full-set evaluation, device metrics plus the host ones
    (Hausdorff, artery radius);
  * `find_best_epochs`: the epoch minimizing dice + CE, inf/NaN backfilled
    (Finetuning/utils.py:4-61).

Arrays come in as cmx takes them, numpy images (N, H, W) and one-hot masks
(N, H, W, C) from load_corpus; `fit` uploads each set once, the masks
transposed to the port's (N, C, H, W). `fit` trains a copy of the model it is
given, so every fit of a grid starts from the same weights; cmx rebuilds its
step per model (and caches it by a key that ignores `fused`): nothing here
compiles, so there is no runner cache.

`fit` runs cmx's two paths as one epoch loop; they differ in where an
epoch's batches come from and how it is validated:
  * the host loop (host_metrics_every > 0): batches from
    np.random.default_rng(seed) exactly as cmx draws them (`_batches`),
    `evaluate` every epoch, the host metrics every host_metrics_every
    epochs;
  * the counterpart of cmx's `_fit_scan` (the default): each epoch a
    permutation of the n training samples, wrap-tiled to steps x batch, its
    steps run by one `StepGraph` for the fit (cmx_torch.train.graph: on a
    card the first step eager, the second captured as a CUDA graph -- the
    gather xtr[c], ytr[c] from a static chunk buffer and the supervised
    step -- and every later step replayed; the capture seconds are
    printed), and one frozen-BN forward of the whole validation set with
    its full device metric set (soft-clDice included), eager. Deviation: cmx draws the permutation
    with jax.random.permutation(fold_in(key(seed ^ 0x5EED), epoch)), which
    torch cannot reproduce; here it comes from a torch generator keyed on
    (seed ^ 0x5EED, epoch). Tests inject cmx's permutations.
In both the best parameters and BN statistics are kept on the device where
validation dice_loss improves (strict <), and the step metrics reach the
host once, at the end. Where no epoch's dice_loss is below inf (all NaN),
each path ends where cmx's does: the scan path at the state it started
from (cmx's _fit_scan), the host loop at the last epoch's (cmx's host loop
restores a best state only when it has one).

Data parallel: cmx's fit is data parallel inside one process, over its
devices; the port maps a device to a rank (a process, one per card,
cmx_torch.parallel.mesh). The scan path trains on the ranks of cmx's gcd
submesh, `mesh.sub_group(gcd(batch, W))`, the host loop on all W ranks
(chunks padded to W rows as cmx's); the collectives of the step (BN and
K1/K2 sums, the loss's sums, the gradients) run in that group, and
validation and `evaluate` in `mesh.local()`. The pickle of `grid_search` is
rank 0's to write.
"""

from __future__ import annotations

import copy
import itertools
import math
import pickle
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cmx_torch import resolve_device
from cmx_torch.eval import host_metrics
from cmx_torch.eval.metrics import segmentation_metrics
from cmx_torch.models.unet import UNet
from cmx_torch.parallel import mesh
from cmx_torch.parallel.dist import on_main
from cmx_torch.train.optim import Adam
from cmx_torch.train.state import TrainState
from cmx_torch.train.graph import StepGraph
from cmx_torch.train.supervised import make_eval_fn, make_supervised_task
from cmx_torch.train.trainer import make_train_body, make_train_step
from cmx_torch.utils.logging import AverageMeter


def find_best_epochs(valid_logs: Dict[str, List[float]]) -> int:
    """Epoch minimizing dice_loss + cross_entropy_loss, back-filling inf/NaN
    hausdorff from the previous epoch (Finetuning/utils.py:4-61)."""
    dice = np.asarray(valid_logs["dice_loss"], dtype=np.float64)
    ce = np.asarray(valid_logs["cross_entropy_loss"], dtype=np.float64)
    if "hausdorff" in valid_logs:
        h = np.asarray(valid_logs["hausdorff"], dtype=np.float64)
        for i in range(1, len(h)):
            if not np.isfinite(h[i]):
                h[i] = h[i - 1]
        valid_logs = dict(valid_logs)
        valid_logs["hausdorff"] = h.tolist()
    total = dice + ce
    total = np.where(np.isfinite(total), total, np.inf)
    return int(np.argmin(total))


def _batches(n: int, batch: int, rng: np.random.Generator,
             pad_multiple: int = 1):
    """cmx's host-loop batches: a permutation of n in chunks of `batch`,
    each padded to max(batch, pad_multiple) rows by wrapping (tiled, as the
    set may be smaller than the batch; cmx pads to its device count)."""
    idx = rng.permutation(n)
    need = max(batch, pad_multiple)
    for i in range(0, n, batch):
        chunk = idx[i: i + batch]
        if len(chunk) < need:
            reps = (need - len(chunk) + n - 1) // n + 1
            chunk = np.concatenate([chunk, np.tile(idx, reps)])[:need]
        yield chunk


@dataclass
class FitResult:
    train_logs: Dict[str, List[float]]
    valid_logs: Dict[str, List[float]]
    best_epoch: int
    runtime: float
    state: Any


def upload_set(imgs: np.ndarray, masks: np.ndarray,
               dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images (N,H,W) fp32, masks (N,C,H,W)) on `dev` from cmx's arrays
    (masks (N,H,W,C)): the one transpose, at upload."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(
        np.asarray(masks, dtype=np.float32).transpose(0, 3, 1, 2))).to(dev)
    return x, y


def _to_host(rows: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Dicts of 0-d device tensors as dicts of floats, in one transfer."""
    if not rows:
        return []
    names = list(rows[0])
    vals = torch.stack([torch.stack([r[k].float() for k in names])
                        for r in rows]).cpu().tolist()
    return [dict(zip(names, v)) for v in vals]


def evaluate(eval_fn, imgs: torch.Tensor, masks: torch.Tensor,
             batch: int = 8, host: bool = True) -> Dict[str, float]:
    """Full-set evaluation of (N,H,W) images and (N,C,H,W) one-hot masks on
    the model's device, in batches of `batch` (the last padded with copies
    of its first image, as cmx pads it, and scored on its real rows only):
    the device metrics (soft-clDice included) and, with `host`, hausdorff
    and radius_arteries on the host. Means weighted by the real rows; the
    device metrics reach the host in one transfer. Under data parallel each
    rank evaluates the whole set by itself (`mesh.local()`), as cmx
    evaluates replicated arrays: the metrics' sums are not all-reduced."""
    with mesh.local():
        return _evaluate(eval_fn, imgs, masks, batch, host)


def _evaluate(eval_fn, imgs, masks, batch, host):
    n = imgs.shape[0]
    pending = []  # (real rows, device metrics, host metrics)
    for i in range(0, n, batch):
        xb, yb = imgs[i: i + batch], masks[i: i + batch]
        real = xb.shape[0]
        if real < batch:
            xb = torch.cat([xb, xb[:1].expand(batch - real, *xb.shape[1:])])
        logits = eval_fn(xb)[:real]
        m = segmentation_metrics(logits, yb)
        hm = {}
        if host:
            probs = torch.softmax(logits, dim=1).cpu().numpy()
            yb_host = yb.cpu().numpy()
            hm["hausdorff"] = host_metrics.hausdorff_metric(
                probs[:, 1], yb_host[:, 1])
            # cmx's host metrics take class-last arrays
            hm["radius_arteries"] = host_metrics.radius_arteries_metric(
                logits.cpu().numpy().transpose(0, 2, 3, 1),
                yb_host.transpose(0, 2, 3, 1))
        pending.append((real, m, hm))
    meters: Dict[str, AverageMeter] = {}
    for (real, _, hm), m in zip(pending, _to_host([p[1] for p in pending])):
        for k, v in {**m, **hm}.items():
            meters.setdefault(k, AverageMeter()).add(float(v), n=int(real))
    return {k: mt.mean for k, mt in meters.items()}


def _epoch_chunks(n: int, batch: int, seed: int, epoch: int,
                  dev: torch.device, perm=None) -> torch.Tensor:
    """The `_fit_scan` counterpart's (steps, batch) indices of an epoch: its
    permutation of n (`perm` when injected, else from a torch generator
    keyed on (seed ^ 0x5EED, epoch); cmx: jax.random, see the module
    docstring), wrap-tiled to steps x batch."""
    if perm is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(((seed ^ 0x5EED) * 1_000_003 + epoch) % (2 ** 63))
        perm = torch.randperm(n, generator=gen, device=dev)
    else:
        perm = torch.tensor(np.asarray(perm), dtype=torch.long, device=dev)
    spe = -(-n // batch)  # steps per epoch, the last chunk wrap-padded
    reps = (spe * batch + n - 1) // n
    return perm.tile(reps)[: spe * batch].reshape(spe, batch)


def _columns(rows: List[Dict[str, float]]) -> Dict[str, List[float]]:
    return {k: [r[k] for r in rows] for k in (rows[0] if rows else {})}


def fit(imgs_train: np.ndarray, masks_train: np.ndarray,
        imgs_valid: np.ndarray, masks_valid: np.ndarray, *,
        lr: float = 1e-3, epochs: int = 10, batch: int = 8, seed: int = 42,
        model: Optional[UNet] = None, augment: bool = True,
        host_metrics_every: int = 0, init_variables: Optional[dict] = None,
        verbose: bool = False, device="cuda",
        perms: Optional[Sequence[Any]] = None) -> FitResult:
    """One supervised fine-tune run (the reference's `train`,
    train.py:193-214): a copy of `model` (UNet(out_classes=2) by default;
    cmx's {"params", "batch_stats"} tree `init_variables` loaded into it
    when given, else the model's own weights), Adam(lr), per-epoch
    validation metrics, the best state by validation dice_loss. The host
    loop's batches and evaluation when host_metrics_every > 0 (or there is
    no validation set), else those of cmx's _fit_scan, whose epoch
    permutations `perms` injects (tests inject cmx's). Runs on `device`.

    Under data parallel (W ranks, cmx's devices) `batch` is the global
    batch and every rank draws the same chunks. The scan path trains on
    the first k = gcd(batch, W) ranks (cmx's gcd submesh), each on its
    batch/k rows of every chunk; the host loop on all W, its chunks padded
    to max(batch, W) rows as cmx pads them. Validation runs on each
    training rank by itself; the best epoch is rank 0's decision. At the
    end every rank takes rank 0's state and logs: all return the same."""
    t0 = time.time()
    dev = resolve_device(device)
    if model is None:
        model = UNet(out_classes=2)
        model.reset_parameters(torch.Generator().manual_seed(seed))
    net = copy.deepcopy(model).to(dev)
    if init_variables is not None:
        from cmx_torch.ckpt.checkpoint import from_flax

        from_flax(net, init_variables)
    task, _ = make_supervised_task(net, augment=augment)
    tx = Adam(net.named_parameters(), lr)
    state = TrainState.create(model=net, tx=tx, seed=seed)
    eval_fn = make_eval_fn(net)
    xtr, ytr = upload_set(imgs_train, masks_train, dev)
    xva, yva = upload_set(imgs_valid, masks_valid, dev)
    n = xtr.shape[0]
    scan = not host_metrics_every and xva.shape[0] > 0
    world = mesh.world_size()
    if not scan and max(batch, world) % world:
        raise ValueError(f"the host loop's batch of {batch} does not split "
                         f"over {world} ranks")
    k = math.gcd(batch, world) if scan else world

    live = list(net.state_dict().values())
    tms, vms = [], []
    with mesh.sub_group(k) as member:
        if member:
            _train_epochs(state, task, tx, eval_fn, (xtr, ytr), (xva, yva),
                          live, tms, vms, scan=scan, epochs=epochs,
                          batch=batch, seed=seed, perms=perms,
                          host_metrics_every=host_metrics_every)
    train_logs = _columns(_to_host(tms))
    valid_logs = _columns(_to_host(vms) if scan else vms)
    # rank 0's state and logs on every rank (the ranks outside the
    # sub group trained nothing)
    mesh.replicate(net, tx.state_dict())
    train_logs, valid_logs, state.step, runtime = mesh.broadcast_object(
        (train_logs, valid_logs, state.step, time.time() - t0))
    best_ep = find_best_epochs(valid_logs)
    if verbose:
        print(f"fit {epochs} epochs: train {train_logs['loss'][-1]:.4f} "
              f"best valid dice_loss {min(valid_logs['dice_loss']):.4f}")
    return FitResult(train_logs, valid_logs, best_ep, runtime, state)


def _train_epochs(state, task, tx, eval_fn, train, valid, live, tms, vms, *,
                  scan, epochs, batch, seed, perms, host_metrics_every):
    """`fit`'s epochs on a rank of the current group: each epoch's step
    metrics appended to `tms` and validation metrics to `vms`; the live
    tensors `live` end as the best epoch's (with none, as the module
    docstring says)."""
    (xtr, ytr), (xva, yva) = train, valid
    dev, n = xtr.device, xtr.shape[0]
    rank, ranks = mesh.info()
    rows = slice(rank * batch // ranks, (rank + 1) * batch // ranks)
    host_rng = np.random.default_rng(seed)
    if scan:  # one graph for the fit: every chunk has batch / k rows
        graph = StepGraph(
            make_train_body(task, tx),
            lambda c: (xtr.index_select(0, c), ytr.index_select(0, c)),
            dev, label="fit")
    else:
        step = make_train_step(task, tx)
    best = [t.detach().clone() for t in live]
    best_metric = torch.tensor(float("inf"), device=dev)
    for ep in range(epochs):
        if scan:
            chunks = _epoch_chunks(n, batch, seed, ep, dev,
                                   None if perms is None else perms[ep])
            tms.append({k: v.mean() for k, v in
                        graph.run(state, chunks[:, rows]).items()})
            with mesh.local():  # every rank the whole set, as cmx's xva
                vm = segmentation_metrics(eval_fn(xva), yva)
        else:
            ms = [step(state, (xtr[c], ytr[c])) for c in (
                mesh.rank_slice(torch.from_numpy(c)).to(dev)
                for c in _batches(n, batch, host_rng, pad_multiple=ranks))]
            tms.append({k: torch.stack([m[k].float() for m in ms]).mean()
                        for k in ms[0]})
            vm = evaluate(eval_fn, xva, yva, batch=batch,
                          host=bool(host_metrics_every)
                          and (ep + 1) % host_metrics_every == 0)
        vms.append(vm)
        with torch.no_grad():
            dice = torch.as_tensor(vm["dice_loss"], device=dev)
            # rank 0's value decides on every rank: two cards' cuDNN picks
            # may differ in the last bit
            mesh.replicate(dice)
            better = dice < best_metric
            best_metric = torch.where(better, dice, best_metric)
            for b, t in zip(best, live):
                b.copy_(torch.where(better, t, b))
    with torch.no_grad():
        # the host loop keeps the last epoch's state where no epoch
        # improved; best_metric comes from rank 0's values alone, so every
        # rank decides alike
        found = best_metric < float("inf")
        for b, t in zip(best, live):
            t.copy_(b if scan else torch.where(found, b, t))
    if scan and graph.report["capture_s"] is not None:
        print(f"fit: {graph.report['replays']} steps replayed from one CUDA "
              f"graph captured in {graph.report['capture_s']:.3f} s")
    elif scan and mesh.backend() == "gloo":
        print(f"fit: {graph.report['eager_steps']} steps run eagerly on "
              f"{dev} (gloo stages every collective through the host: no "
              "CUDA graph)")


def grid_search(imgs: np.ndarray, masks: np.ndarray, *,
                lrs: Sequence[float] = (1e-2, 1e-3, 1e-4, 1e-5),
                epochs_grid: Sequence[int] = (128,),
                batches: Sequence[int] = (32,), n_folds: int = 3,
                seed: int = 42, results_path: Optional[str] = None,
                init_variables: Optional[dict] = None, **fit_kw
                ) -> Tuple[float, int, int, List[dict]]:
    """The lr x epochs x batch grid with KFold cross-validation
    (main_finetuning, train.py:311-378): each point's score is the mean over
    the folds of validation dice_loss + CE at the fold's best epoch.
    Returns (best_lr, best_batch, best_epochs, all_results); the results
    are pickled to `results_path` when given, by rank 0 alone under data
    parallel (every rank returns the same)."""
    from cmx_torch.data.splits import KFold

    results = []
    best = (np.inf, None)
    for lr, eps, bs in itertools.product(lrs, epochs_grid, batches):
        fold_scores = []
        fold_logs = []
        kf = KFold(n_splits=n_folds, random_state=seed)
        for tr_idx, va_idx in kf.split(imgs):
            res = fit(imgs[tr_idx], masks[tr_idx], imgs[va_idx],
                      masks[va_idx], lr=lr, epochs=eps, batch=bs, seed=seed,
                      init_variables=init_variables, **fit_kw)
            be = res.best_epoch
            fold_scores.append(res.valid_logs["dice_loss"][be]
                               + res.valid_logs["cross_entropy_loss"][be])
            fold_logs.append({"train_logs": res.train_logs,
                              "valid_logs": res.valid_logs,
                              "best_epoch": be, "runtime": res.runtime})
        score = float(np.mean(fold_scores))
        results.append({"lr": lr, "epochs": eps, "batch": bs,
                        "score": score, "folds": fold_logs})
        if score < best[0]:
            best = (score, (lr, bs, eps))
    if results_path:
        on_main(_dump, results, results_path)
    lr, bs, eps = best[1]
    return lr, bs, eps, results


def _dump(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
