"""Pretraining entry point (port of cmx/cli/pretrain.py).

    python -m cmx_torch.cli.pretrain --task spark [--preset] [a.b=c ...]
    python -m cmx_torch.cli.pretrain --device cpu --task spark \
        data.synthetic=True train.epochs=2 ...
    torchrun --nproc_per_node N -m cmx_torch.cli.pretrain --task spark ...

`build_task` for task.name "spark", "moco", "genesis", "mae" and "cmunet"
(`model.remat` names the blocks recomputed in the backward for spark,
genesis and mae, and is ignored for moco and cmunet, as in cmx), then
`main`: the config printed, the corpus loaded (the native loader, else
numpy/PIL, as in cmx), the seeded sampler, the schedules, the optimizer,
resume from the newest checkpoint, the epoch loop with the device-resident
feed, validation with patience, `log.jsonl` (with `train.tensorboard` the
same scalars under `<ckpt_dir>/tb` too, when a TensorBoard writer can be
made), the checkpoints, and the `encoder.npz` /
`model.npz` exports with their stamp. Everything runs on the card unless
`--device cpu` is given.

Data parallel, as cmx's multi-process run: under torch's launcher
(WORLD_SIZE set) each of the W processes takes cuda:LOCAL_RANK (NCCL; gloo
with --device cpu) and B/W of every global batch of train.batch_size (the
sampler's rank slice), and the step is cmx's global-view step at B
(cmx_torch.parallel.mesh). The initial state is broadcast from rank 0, every
rank restores the same checkpoint, and rank 0 alone writes checkpoints,
log.jsonl, TensorBoard, encoder.npz, model.npz and the stamp. Validation
takes global batches of train.batch_size, each rank its rows (cmx feeds
every process the same rows), and its losses are global. The device feed
stays single-process, as in cmx.

Differences from cmx's CLI, each for a reason:
  * `train.scan`: cmx compiles segments of steps into one `lax.scan`
    program; the port reads the key and runs its per-step loop over the
    same index stream, the indices of a segment uploaded at once (a CUDA
    graph of the step is the counterpart: ROADMAP).
  * Resume: the sampler starts at the resumed epoch, so a resumed run draws
    the batches an uninterrupted one does (cmx's restarts its permutation
    stream at epoch 0); step draws are keyed by (seed, step) in both. With
    the same config, a run cut after a checkpoint and started again ends
    where an uninterrupted one does, bit for bit on the CPU.
  * `train.profile_dir` traces one epoch with torch.profiler (a Chrome
    trace) in place of jax.profiler.
  * `main` returns a summary of the run (the state, the loader used,
    whether the device feed ran, the steps and validation batches an epoch,
    the exported paths) besides printing it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cmx_torch import resolve_device
from cmx_torch.config.config import Config, apply_overrides, display, to_dict
from cmx_torch.parallel import mesh
from cmx_torch.parallel.dist import (InfiniteBatchSampler,
                                     initialize_distributed, is_main,
                                     local_rank, on_main, process_info,
                                     shutdown)
from cmx_torch.train.trainer import Task, extra_buffers

def build_task(cfg: Config, dtype: torch.dtype, device="cuda"
               ) -> Tuple[Task, torch.nn.Module]:
    """(task, model) for cfg.task.name; the model's random weights come
    from cfg.train.seed and live on `device`. A task with state of its own
    (MoCo, CM-UNet) makes it with `task.init_extra(gen)`."""
    t = cfg.task
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.train.seed)
    if t.name == "cmunet":
        from cmx_torch.ssl.cmunet import CMUNetOnline, make_cmunet_task

        # As in cmx: never fused, model.remat not read; ema_momentum passed.
        model = CMUNetOnline(dtype=dtype, view_size=t.view_size)
        model.reset_parameters(gen)
        task, _ = make_cmunet_task(model.to(dev), mask_ratio=t.mask_ratio,
                                   patch_size=t.patch_size,
                                   temperature=t.temperature,
                                   base_momentum=t.ema_momentum,
                                   view_size=t.view_size, augment=t.augment,
                                   crop_impl=t.crop_impl)
        return task, model
    if t.name == "moco":
        from cmx_torch.models.unet import UNetEncoderGAP
        from cmx_torch.ssl.moco import make_moco_task

        # As in cmx: never fused, no remat, and no ema_momentum passed, so
        # the key encoder's EMA runs at make_moco_task's 0.999 whatever
        # task.ema_momentum says.
        model = UNetEncoderGAP(dtype=dtype)
        model.reset_parameters(gen)
        task, _ = make_moco_task(model.to(dev), temperature=t.temperature,
                                 num_negatives=t.num_negatives,
                                 view_size=t.view_size, augment=t.augment,
                                 rotation_method=t.rotation_method,
                                 crop_method=t.crop_method,
                                 crop_impl=t.crop_impl)
        return task, model
    if t.name not in ("spark", "genesis", "mae"):
        raise ValueError(f"unknown pretrain task {t.name!r}")
    remat = tuple(s for s in cfg.model.remat.split(",") if s)
    if t.name == "genesis":
        from cmx_torch.models.unet import UNet
        from cmx_torch.ssl.reconstruction import make_genesis_task

        model = UNet(out_classes=1, dtype=dtype, fused=cfg.model.fused_conv,
                     remat_levels=remat)
        model.reset_parameters(gen)
        task, _ = make_genesis_task(
            model.to(dev), flip_rate=t.genesis_flip_rate,
            local_rate=t.genesis_local_rate,
            nonlinear_rate=t.genesis_nonlinear_rate,
            paint_rate=t.genesis_paint_rate,
            inpaint_rate=t.genesis_inpaint_rate)
        return task, model
    if t.name == "mae":
        from cmx_torch.models.unet import UNet
        from cmx_torch.ssl.reconstruction import make_mae_task

        model = UNet(out_classes=1, dtype=dtype, fused=cfg.model.fused_conv,
                     remat_levels=remat)
        model.reset_parameters(gen)
        task, _ = make_mae_task(model.to(dev), mask_ratio=t.mask_ratio,
                                patch_size=t.patch_size,
                                shared_mask=t.shared_mask,
                                masked_loss_only=t.masked_loss_only)
        return task, model
    from cmx_torch.ssl.spark import SparKModel, make_spark_task

    model = SparKModel(mask_ratio=t.mask_ratio, full_unet=t.full_unet,
                       dtype=dtype, fused=cfg.model.fused_conv,
                       remat_levels=remat)
    model.reset_parameters(gen)
    model = model.to(dev)
    task, _ = make_spark_task(model, augment=t.augment,
                              input_size=cfg.data.image_size,
                              pallas_loss=t.pallas_loss)
    return task, model


def load_pretrain_images(cfg: Config) -> Tuple[np.ndarray, str]:
    """(the pretrain split's images (N, S, S) fp32, the loader that read
    them: "native" or "python")."""
    from cmx_torch.data.corpus import load_corpus
    from cmx_torch.data.splits import list_corpus, make_splits
    from cmx_torch.data.synthetic import resolve_corpus

    data_dir = resolve_corpus(cfg.data)
    xs, ys = list_corpus(data_dir)
    splits = make_splits(xs, ys, ratio=cfg.data.ratio)
    imgs, loader = None, "python"
    if cfg.data.native_loader:
        from cmx_torch.native.loader import load_corpus_native

        imgs = load_corpus_native(splits.pretrain_x, cfg.data.image_size)
        loader = "native" if imgs is not None else "python"
    if imgs is None:
        imgs, _ = load_corpus(splits.pretrain_x, None, size=cfg.data.image_size)
    if cfg.data.extra_data_dir:
        # --arcade analog: extra unlabeled images appended to the pool
        extra_paths = [
            os.path.join(cfg.data.extra_data_dir, f)
            for f in sorted(os.listdir(cfg.data.extra_data_dir))
            if f.endswith(".npy")
        ]
        extra, _ = load_corpus(extra_paths, None, size=cfg.data.image_size)
        imgs = np.concatenate([imgs, extra], axis=0)
    return imgs, loader


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed % (2 ** 63))


def replay_val_loss(task: Task, state, batch: torch.Tensor,
                    gen: torch.Generator) -> torch.Tensor:
    """The validation loss of every task but MoCo, as cmx's jitted
    val_loss_fn computes it: the train-mode loss (batch statistics), whose
    updated BN running statistics cmx discards, the model's and those of
    the modules in `extra` (CM-UNet's target) -- so they are put back here
    afterwards."""
    model = state.model
    buffers = list(model.buffers()) + extra_buffers(state.extra)
    saved = [b.detach().clone() for b in buffers]
    model.train()
    try:
        with torch.no_grad():
            loss, _ = task.loss_fn(model, batch, gen, None, state.extra)
    finally:
        with torch.no_grad():
            for b, s in zip(buffers, saved):
                b.copy_(s)
    return loss


def _to_host(metrics: list, names) -> list:
    """Rows of python floats, one a dict of 0-d device tensors, in one
    device-to-host transfer."""
    return torch.stack([torch.stack([m[k].float() for k in names])
                        for m in metrics]).cpu().tolist()


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _corpus_stamp_info(cfg: Config):
    """(corpus dir, its meta.json or None) for the stamp; never raises."""
    corpus_meta = None
    try:
        from cmx_torch.data.synthetic import resolve_corpus

        corpus_dir = resolve_corpus(cfg.data)
        meta_path = os.path.join(corpus_dir, "meta.json")
        if os.path.isfile(meta_path):
            with open(meta_path) as f:
                corpus_meta = json.load(f)
    except (OSError, RuntimeError, ValueError) as e:
        corpus_dir = cfg.data.data_dir
        print(f"stamp: corpus meta unavailable ({e})")
    return corpus_dir, corpus_meta


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--task", default=None,
                   help="genesis|genesis_tuned|mae|mae_tuned|moco|spark|"
                        "cmunet (the *_tuned names require --preset: each "
                        "is a preset key that resolves task.name back to "
                        "genesis or mae)")
    p.add_argument("--preset", action="store_true",
                   help="start from the reference recipe for --task "
                        "(cmx_torch.config.presets) before applying overrides")
    p.add_argument("--corpus-seed", type=int, default=None,
                   help="corpus-seed axis: sugar for data.corpus_seed=N "
                        "(resolves data_dir -> data_dir_sN, seeds synthetic "
                        "generation)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("overrides", nargs="*", help="dotted config overrides a.b=c")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    made_group = initialize_distributed(dev)
    try:
        return _run(args, dev)
    finally:
        if made_group:
            shutdown()


def _run(args: argparse.Namespace, dev: torch.device) -> Dict[str, Any]:
    if mesh.active():
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank())
        rank, world = process_info()
        print(f"process group: {mesh.backend()} rank {rank} "
              f"of {world} on {dev}")
    cfg = Config()
    cfg.task.name = args.task or cfg.task.name
    if args.preset:
        from cmx_torch.config.presets import PRESETS

        cfg = PRESETS[cfg.task.name](cfg)
    apply_overrides(cfg, args.overrides)
    if args.corpus_seed is not None:
        cfg.data.corpus_seed = args.corpus_seed
    print(display(cfg))

    from cmx_torch.utils.seeding import seed_everything

    seed_everything(cfg.train.seed)
    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32

    if mesh.active():  # rank 0 writes a synthetic corpus before any reads
        from cmx_torch.data.synthetic import resolve_corpus

        on_main(resolve_corpus, cfg.data)
    imgs, loader = load_pretrain_images(cfg)
    n_pretrain_imgs = int(imgs.shape[0])
    print(f"corpus: {n_pretrain_imgs} images of {imgs.shape[1]}x"
          f"{imgs.shape[2]} by the {loader} loader")
    rank, world = process_info()
    if cfg.train.batch_size % world:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} does not "
                         f"split over {world} processes")
    per_host_batch = cfg.train.batch_size // world
    sampler = InfiniteBatchSampler(
        imgs.shape[0], per_host_batch, rank=rank, world_size=world,
        seed=cfg.train.seed,
    )

    task, model = build_task(cfg, dtype, dev)
    extra = (task.init_extra(_generator(dev, cfg.train.seed + 1))
             if task.init_extra else None)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[{cfg.task.name}] params: {n_params / 1e6:.1f}M")

    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import (cosine_anneal, scaled_base_lr,
                                           warmup_cosine)
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    # As in cmx, the schedules span the steps of the whole pretrain pool,
    # counted before a validation slice is carved out of it.
    steps_per_epoch = sampler.iters_per_epoch
    total_steps = cfg.train.epochs * steps_per_epoch
    lr_peak = (
        scaled_base_lr(cfg.optim.lr, cfg.train.batch_size)
        if cfg.optim.base_lr_scaled
        else cfg.optim.lr
    )
    lr_sched = warmup_cosine(lr_peak, total_steps,
                             cfg.optim.warmup_epochs * steps_per_epoch)
    wd = (
        cosine_anneal(cfg.optim.weight_decay, cfg.optim.wd_end, total_steps)
        if cfg.optim.wd_end is not None
        else cfg.optim.weight_decay
    )
    tx = make_optimizer(
        cfg.optim.name, lr_sched, wd, momentum=cfg.optim.momentum,
        clip_norm=cfg.optim.clip_norm, named_params=model.named_parameters(),
    )
    state = TrainState.create(model=model, tx=tx, seed=cfg.train.seed,
                              extra=extra)

    from cmx_torch.ckpt.checkpoint import (CheckpointManager, export_encoder,
                                           export_model, write_stamp)
    from cmx_torch.utils.logging import JsonlLogger, MetricLogger

    ckpt_dir = os.path.join(cfg.train.ckpt_dir, cfg.task.name)
    mgr = CheckpointManager(ckpt_dir)
    if cfg.train.resume and mgr.latest_step() is not None:
        mgr.restore(state)
        print(f"resumed from step {state.step}")
    mesh.replicate(state.model, state.extra)  # replicas start equal

    if cfg.train.tee and is_main():
        # mirror stdout/stderr into the run dir (Spark/utils/misc.py:72-86)
        from cmx_torch.utils.logging import tee_output

        tee_output(ckpt_dir)
    step_fn = make_train_step(task, tx)
    logger = MetricLogger()
    jsonl = JsonlLogger(os.path.join(ckpt_dir, "log.jsonl"))
    tb = None
    if cfg.train.tensorboard:
        from cmx_torch.utils.tensorboard import TensorboardLogger

        tb = TensorboardLogger(os.path.join(ckpt_dir, "tb"))
        if is_main():
            print("tensorboard: " + (
                f"writing to {os.path.join(ckpt_dir, 'tb')}" if tb.writer
                else "no writer (no tensorboard package): not logging"))

    # Genesis-style validation slice + early stopping (patience 50 in the
    # reference config; off by default here).
    val_imgs = None
    moco_validate = None
    val_queue = None
    if cfg.train.patience > 0 and imgs.shape[0] > 4:
        n_val = max(cfg.train.batch_size,
                    int(imgs.shape[0] * cfg.train.val_fraction))
        n_val = min(n_val, imgs.shape[0] // 2)
        val_imgs, imgs = imgs[:n_val], imgs[n_val:]
        sampler = InfiniteBatchSampler(
            imgs.shape[0], per_host_batch, rank=rank, world_size=world,
            seed=cfg.train.seed,
        )
        steps_per_epoch = sampler.iters_per_epoch
        if cfg.task.name == "moco":
            # MoCo validates against a SEPARATE negatives queue with
            # precision@1/5, like the reference's validation_step
            # (moco2_module.py:311-336) — not a generic train-loss replay.
            from cmx_torch.ssl.moco import init_val_queue, make_moco_validate

            moco_validate = make_moco_validate(
                model, temperature=cfg.task.temperature,
                view_size=cfg.task.view_size, augment=cfg.task.augment,
                rotation_method=cfg.task.rotation_method,
                crop_method=cfg.task.crop_method,
                crop_impl=cfg.task.crop_impl,
            )
            val_queue = init_val_queue(
                _generator(dev, cfg.train.seed * 1_000_003 + 97),
                cfg.task.num_negatives, model.emb_dim)

    # Device-resident corpus feed (DataConfig.device_feed): one upload, then
    # an on-device row gather (index_select) per step.
    corpus_dev = None
    if (cfg.data.device_feed and world == 1
            and imgs.nbytes <= cfg.data.device_feed_max_bytes):
        corpus_dev = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
        print(f"device feed: corpus resident ({imgs.nbytes / 1e6:.0f} MB)")
    # train.scan: the indices of a segment (scan_budget samples) are drawn
    # from the sampler and uploaded at once; the steps run one by one.
    seg = (max(1, cfg.train.scan_budget // per_host_batch)
           if cfg.train.scan and corpus_dev is not None else 1)

    best_val = float("inf")
    bad_epochs = 0
    last_best_save_ep = -(10**9)
    start_ep = state.step // steps_per_epoch
    sampler.epoch = start_ep
    it = iter(sampler)
    ep = start_ep - 1  # loop may be empty on a fully-trained resume
    for ep in range(start_ep, cfg.train.epochs):
        profile_this = bool(cfg.train.profile_dir) and ep == start_ep + 1
        t0 = time.time()
        with _profiler(dev) if profile_this else contextlib.nullcontext() \
                as prof:
            step_metrics = []
            # per-iteration progress for long epochs; metric VALUES still
            # reach the host once per epoch below.
            freq = (cfg.train.log_every
                    if steps_per_epoch > cfg.train.log_every else 0)
            steps = (logger.log_every(range(steps_per_epoch), freq,
                                      header=f"ep{ep}")
                     if freq else range(steps_per_epoch))
            idxs = None
            for i in steps:
                if i % seg == 0:
                    n = min(seg, steps_per_epoch - i)
                    idxs = torch.from_numpy(np.stack(
                        [next(it) for _ in range(n)]).astype(np.int64))
                    if corpus_dev is not None:
                        idxs = idxs.to(dev)
                idx = idxs[i % seg]
                if corpus_dev is not None:
                    batch = corpus_dev.index_select(0, idx)
                else:
                    batch = torch.from_numpy(imgs[idx.numpy()]).to(dev)
                step_metrics.append(step_fn(state, batch))  # no sync
            # One host transfer per epoch.
            names = list(step_metrics[0])
            vals = _to_host(step_metrics, names)
        for row in vals:
            logger.update(**dict(zip(names, row)))
        dt = time.time() - t0
        if prof is not None:
            os.makedirs(cfg.train.profile_dir, exist_ok=True)
            trace = os.path.join(cfg.train.profile_dir, f"trace_ep{ep}.json")
            prof.export_chrome_trace(trace)
            print(f"profile of epoch {ep} written to {trace}")
        epoch_metrics = {k: m.avg for k, m in logger.meters.items()}
        print(f"epoch {ep}: {logger}  ({dt:.1f}s, "
              f"{steps_per_epoch * cfg.train.batch_size / dt:.1f} img/s)")

        if val_imgs is not None:
            # global batches of train.batch_size; this rank's rows of each
            gb = cfg.train.batch_size
            vb = val_imgs[: (len(val_imgs) // gb) * gb]
            starts = range(0, len(vb), gb)
            batches = [torch.from_numpy(
                vb[i + rank * per_host_batch: i + (rank + 1) * per_host_batch]
            ).to(dev) for i in starts]
            if moco_validate is not None:
                vms = []
                for i, vbatch in zip(starts, batches):
                    gen = _generator(dev, cfg.train.seed * 1_000_003
                                     + ep * 10_000 + i)
                    m, val_queue = moco_validate(state, val_queue, vbatch, gen)
                    vms.append(m)
                keys = ("val_loss", "val_acc1", "val_acc5")
                for k, col in zip(keys, zip(*_to_host(vms, keys))):
                    epoch_metrics[k] = float(np.mean(col))
                vloss = epoch_metrics["val_loss"]
            else:
                # one generator seed for the epoch's batches, as cmx's one
                # fold_in(key(seed), ep)
                vlosses = [{"val_loss": replay_val_loss(
                    task, state, vbatch,
                    _generator(dev, cfg.train.seed * 1_000_003 + 7919 * ep))}
                    for vbatch in batches]
                vloss = float(np.mean([r[0] for r in _to_host(
                    vlosses, ["val_loss"])]))
                epoch_metrics["val_loss"] = vloss
            if vloss < best_val:
                best_val = vloss
                bad_epochs = 0
                # Throttled best-val saves: the saved checkpoint only feeds
                # resume (the exported encoder is the FINAL state, below).
                if ep - last_best_save_ep >= cfg.train.best_save_every:
                    mgr.save(state.step, state, config=to_dict(cfg),
                             metrics={"val_loss": vloss}, force=True)
                    last_best_save_ep = ep
            else:
                bad_epochs += 1
            print(f"  val_loss {vloss:.4f} (best {best_val:.4f}, "
                  f"bad {bad_epochs}/{cfg.train.patience})")
            if bad_epochs >= cfg.train.patience:
                print("early stop")
                break

        jsonl.write(epoch=ep, **epoch_metrics)
        if tb is not None:
            tb.log_dict(epoch_metrics, ep)
        if cfg.train.save_every_epoch or ep == cfg.train.epochs - 1:
            mgr.save(state.step, state, config=to_dict(cfg))
    encoder_path = os.path.join(ckpt_dir, "encoder.npz")
    export_encoder(state, encoder_path)
    export_model(state, os.path.join(ckpt_dir, "model.npz"))
    corpus_dir, corpus_meta = _corpus_stamp_info(cfg)
    stamp_path = write_stamp(
        encoder_path, to_dict(cfg),
        task=cfg.task.name, corpus_dir=corpus_dir, corpus_meta=corpus_meta,
        n_pretrain_images=n_pretrain_imgs,
        epochs_run=int(ep) + 1,
        final_step=state.step,
        best_val_loss=None if best_val == float("inf") else float(best_val),
    )
    if tb is not None:
        tb.close()
    mgr.close()
    print("done; encoder exported to", encoder_path)
    print("stamp written to", stamp_path)
    n_val_batches = (0 if val_imgs is None
                     else len(val_imgs) // cfg.train.batch_size)
    return {"state": state, "ckpt_dir": ckpt_dir, "loader": loader,
            "device_feed": corpus_dev is not None, "epochs_run": int(ep) + 1,
            "steps_per_epoch": steps_per_epoch, "val_batches": n_val_batches,
            "best_val_loss": None if best_val == float("inf") else best_val,
            "encoder": encoder_path, "stamp": stamp_path,
            "tensorboard": tb is not None and tb.writer is not None}


if __name__ == "__main__":
    main()
