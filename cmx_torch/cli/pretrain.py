"""Pretraining task construction (port of cmx/cli/pretrain.py:31-124).

`build_task` for task.name "spark" and "moco" is ported; the CLI loop,
orbax checkpoints, the `encoder.npz` export and the device-resident feed
wait (ROADMAP: pretrain CLI loop).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmx_torch import resolve_device
from cmx_torch.config.config import Config
from cmx_torch.train.trainer import Task

_WAITING = {"genesis": "Genesis/MAE", "mae": "Genesis/MAE",
            "cmunet": "CM-UNet"}


def build_task(cfg: Config, dtype: torch.dtype, device="cuda"
               ) -> Tuple[Task, torch.nn.Module]:
    """(task, model) for cfg.task.name; the model's random weights come
    from cfg.train.seed and live on `device`. A task with state of its own
    (MoCo) makes it with `task.init_extra(gen)`."""
    t = cfg.task
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.train.seed)
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
    if t.name != "spark":
        item = _WAITING.get(t.name)
        if item is None:
            raise ValueError(f"unknown pretrain task {t.name!r}")
        raise NotImplementedError(
            f"pretrain task {t.name!r} is not ported yet (ROADMAP: {item})")
    if cfg.model.remat:
        raise NotImplementedError("model.remat is not ported yet "
                                  "(ROADMAP: remat)")
    from cmx_torch.ssl.spark import SparKModel, make_spark_task

    model = SparKModel(mask_ratio=t.mask_ratio, full_unet=t.full_unet,
                       dtype=dtype, fused=cfg.model.fused_conv)
    model.reset_parameters(gen)
    model = model.to(dev)
    task, _ = make_spark_task(model, augment=t.augment,
                              input_size=cfg.data.image_size,
                              pallas_loss=t.pallas_loss)
    return task, model
