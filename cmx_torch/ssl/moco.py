"""MoCo v2 momentum-contrast pretraining on the UNet GAP encoder (port of
cmx/ssl/moco.py:43-224).

  * the online encoder (the step's model) and a key encoder (a copy, held
    in `extra["key_model"]`, no gradient);
  * a ring-buffer queue of K normalized keys and its pointer in `extra`;
    K % batch == 0 is required (cmx raises the same ValueError);
  * logits l_pos = <q, k>, l_neg = q . queue^T, / T, cross-entropy with
    label 0; acc1 / acc5 from the top 5 logits;
  * the key encoder runs in train mode: its BN running stats update in
    place from this step's key batch (they are not EMA'd);
  * post_update, after the optimizer update: EMA of the key parameters
    toward the updated online parameters, then the keys enqueued at the
    pointer and ptr = (ptr + B) mod K. The trainer's NaN guard covers all of
    it, and the key BN stats.
Under data parallel (cmx_torch.parallel.mesh) B is the global batch, as in
cmx's global-view step: the views' draws are made for it and each rank
takes its rows; a rank's queries meet its own keys as positives and the
queue as negatives; the loss and acc1 / acc5 are the global batch's means;
the keys of every rank enter the queue in rank order and ptr advances by
B; the key encoder's BN moments are global.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from cmx_torch.models.unet import UNetEncoderGAP
from cmx_torch.ops.augment import moco_view_aug_batch, moco_view_draws
from cmx_torch.parallel import mesh
from cmx_torch.train.trainer import Task, TaskAux

EMB_DIM = 1024


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def init_moco_extra(gen: torch.Generator, model: UNetEncoderGAP,
                    num_negatives: int = 65536) -> Dict[str, Any]:
    """extra = a key-encoder copy of `model`, a queue of normalized random
    keys (normal draws from `gen`) and queue_ptr 0, on the model's device."""
    dev = next(model.parameters()).device
    key_model = copy.deepcopy(model)
    for p in key_model.parameters():
        p.requires_grad_(False)
    queue = torch.randn((num_negatives, model.emb_dim), generator=gen,
                        device=gen.device).to(dev)
    return {"key_model": key_model, "queue": _normalize_rows(queue),
            "queue_ptr": torch.zeros((), dtype=torch.int32, device=dev)}


def init_val_queue(gen: torch.Generator, num_negatives: int = 65536,
                   emb_dim: int = EMB_DIM) -> Dict[str, torch.Tensor]:
    """The separate validation queue (moco2_module.py:137-142)."""
    q = torch.randn((num_negatives, emb_dim), generator=gen, device=gen.device)
    return {"queue": _normalize_rows(q),
            "queue_ptr": torch.zeros((), dtype=torch.int32, device=gen.device)}


def _contrast(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
              temperature: float) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Cross-entropy of [l_pos, l_neg] / T with label 0, and acc1 / acc5."""
    l_pos = (q * k).sum(dim=1, keepdim=True)
    l_neg = torch.matmul(q, queue.t())
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    labels = torch.zeros((q.shape[0],), dtype=torch.long, device=q.device)
    loss = mesh.global_mean(F.cross_entropy(logits, labels))
    top5 = torch.topk(logits.detach(), 5, dim=1).indices
    acc = torch.stack([(top5[:, 0] == 0).float().mean(),
                       (top5 == 0).any(dim=1).float().mean()])
    acc = mesh.all_reduce_sum(acc / mesh.world_size())
    return loss, {"acc1": acc[0], "acc5": acc[1]}


def _enqueue(queue: torch.Tensor, ptr: torch.Tensor, keys: torch.Tensor):
    """(new queue, new ptr): every rank's keys, in rank order, written at
    rows ptr..ptr+B-1, ptr advanced by the global B mod K; the pointer stays
    on the device (no host synchronisation)."""
    keys = mesh.all_gather_batch(keys)
    bs, num = keys.shape[0], queue.shape[0]
    idx = ptr.long() + torch.arange(bs, device=queue.device)
    new_queue = queue.index_copy(0, idx, keys.to(queue.dtype))
    return new_queue, torch.remainder(ptr + bs, num).to(torch.int32)


def _views(imgs, gen, draws, augment, view_size, rotation_method,
           crop_method, crop_impl):
    """The (q, k) views of a batch; draws["q"] / draws["k"] may inject
    each view's random draws, for the global batch (each rank takes its
    rows)."""
    if not augment:
        return imgs, imgs
    draws = draws or {}
    b, h, w = imgs.shape
    views = []
    for v in ("q", "k"):
        d = mesh.rank_slice_draws(moco_view_draws(
            gen, mesh.global_batch(b), h, w, view_size, draws.get(v)))
        views.append(moco_view_aug_batch(imgs, view_size, rotation_method,
                                         crop_method, crop_impl, gen, d))
    return tuple(views)


def _check_divisible(num_negatives: int, bs: int, what: str) -> None:
    if num_negatives % bs != 0:
        raise ValueError(
            f"MoCo {what} size ({num_negatives}) must be divisible by the "
            f"global batch ({bs}); the ring-buffer enqueue would wrap inside "
            "a batch and corrupt the queue (moco2_module.py:169).")


def make_moco_task(model: Optional[UNetEncoderGAP] = None, *,
                   temperature: float = 0.07, ema_momentum: float = 0.999,
                   num_negatives: int = 65536, view_size: int = 224,
                   augment: bool = True,
                   rotation_method: Optional[str] = None,
                   crop_method: Optional[str] = None,
                   crop_impl: Optional[str] = None
                   ) -> Tuple[Task, UNetEncoderGAP]:
    """The MoCo task: loss_fn(model, imgs, gen, draws, extra) -> (loss,
    TaskAux). `draws` may inject the two views' random draws, as
    {"q": {...}, "k": {...}} with the keys of augment.moco_view_draws;
    whatever is missing is drawn from `gen`. `task.init_extra(gen)` makes
    the task's `extra`."""
    model = model or UNetEncoderGAP()
    view_args = (augment, view_size, rotation_method, crop_method, crop_impl)

    def loss_fn(model: UNetEncoderGAP, imgs: torch.Tensor,
                gen: torch.Generator, draws: Optional[dict] = None,
                extra: Optional[Dict[str, Any]] = None):
        _check_divisible(num_negatives, mesh.global_batch(imgs.shape[0]),
                         "queue")
        img_q, img_k = _views(imgs, gen, draws, *view_args)
        q = _normalize_rows(model(img_q))
        key_model = extra["key_model"]
        key_model.train()
        with torch.no_grad():
            k = _normalize_rows(key_model(img_k))
        loss, metrics = _contrast(q, k, extra["queue"], temperature)
        return loss, TaskAux(metrics=metrics, updates={"keys": k})

    def post_update(state, aux: TaskAux):
        extra = state.extra
        m = ema_momentum
        pairs = [(pk, m * pk + (1.0 - m) * p) for pk, p in
                 zip(extra["key_model"].parameters(),
                     state.model.parameters())]
        queue, ptr = _enqueue(extra["queue"], extra["queue_ptr"],
                              aux.updates["keys"])
        return pairs + [(extra["queue"], queue), (extra["queue_ptr"], ptr)]

    def init_extra(gen: torch.Generator) -> Dict[str, Any]:
        return init_moco_extra(gen, model, num_negatives)

    return Task(name="moco", loss_fn=loss_fn, post_update=post_update,
                init_extra=init_extra), model


def make_moco_validate(model: UNetEncoderGAP, *, temperature: float = 0.07,
                       view_size: int = 224, augment: bool = True,
                       rotation_method: Optional[str] = None,
                       crop_method: Optional[str] = None,
                       crop_impl: Optional[str] = None):
    """Validation against the val queue with precision@1/5
    (moco2_module.py:311-336): `model` (the online encoder, the train
    state's model) and the state's key encoder, both in eval mode (running
    BN stats). Returns validate(state, val_queue, imgs, gen=None,
    draws=None) -> (metrics, new val queue); val_queue is not modified."""

    @torch.no_grad()
    def validate(state, val_queue: Dict[str, torch.Tensor],
                 imgs: torch.Tensor, gen: Optional[torch.Generator] = None,
                 draws: Optional[dict] = None):
        queue = val_queue["queue"]
        _check_divisible(queue.shape[0], mesh.global_batch(imgs.shape[0]),
                         "val queue")
        img_q, img_k = _views(imgs, gen, draws, augment, view_size,
                              rotation_method, crop_method, crop_impl)
        key_model = state.extra["key_model"]
        modes = (model.training, key_model.training)
        model.eval()
        key_model.eval()
        try:
            q = _normalize_rows(model(img_q))
            k = _normalize_rows(key_model(img_k))
        finally:
            model.train(modes[0])
            key_model.train(modes[1])
        loss, acc = _contrast(q, k, queue, temperature)
        new_queue, new_ptr = _enqueue(queue, val_queue["queue_ptr"], k)
        metrics = {"val_loss": loss, "val_acc1": acc["acc1"],
                   "val_acc5": acc["acc5"]}
        return metrics, {"queue": new_queue, "queue_ptr": new_ptr}

    return validate
