"""Pretraining task construction (port of cmx/cli/pretrain.py:31-124).

Only `build_task` for task.name == "spark" is ported; the CLI loop, orbax
checkpoints, the `encoder.npz` export and the device-resident feed wait
(ROADMAP: pretrain CLI loop).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cmx_torch import resolve_device
from cmx_torch.config.config import Config
from cmx_torch.train.trainer import Task

_WAITING = {
    "genesis": "Genesis/MAE", "mae": "Genesis/MAE", "moco": "MoCo",
    "cmunet": "CM-UNet",
}


def build_task(cfg: Config, dtype: torch.dtype, device="cuda"
               ) -> Tuple[Task, torch.nn.Module]:
    """(task, model) for cfg.task.name; the model's random weights come
    from cfg.train.seed and live on `device`."""
    t = cfg.task
    dev = resolve_device(device)
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
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(dev)
    task, _ = make_spark_task(model, augment=t.augment,
                              input_size=cfg.data.image_size,
                              pallas_loss=t.pallas_loss)
    return task, model
