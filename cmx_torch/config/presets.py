"""Reference training recipes as config presets.

A copy of cmx/config/presets.py (the port imports nothing of `cmx`),
kept preset for preset so `PRESETS[name](Config())` configures the port
exactly as the cmx CLI's `--preset` does.

Each preset reproduces the hyperparameters the corresponding reference silo
trained with, so `python -m cmx.cli.pretrain --task spark` + preset gives the
reference regime on TPU. Citations per field.
"""

from __future__ import annotations

from cmx_torch.config.config import Config


def genesis_preset(cfg: Config | None = None) -> Config:
    """Model Genesis (Transformation_based/config.py:5-56 +
    Genesis_Chest_CT.py:85-92): SGD lr 1e-2 momentum .9, batch 64, up to 256
    epochs, early-stop patience 50, distortion rates in cmx.ops.genesis."""
    cfg = cfg or Config()
    cfg.task.name = "genesis"
    cfg.optim.name = "sgd"
    cfg.optim.lr = 1e-2
    cfg.optim.momentum = 0.9
    cfg.optim.weight_decay = 0.0
    cfg.optim.clip_norm = None
    cfg.train.batch_size = 64
    cfg.train.epochs = 256
    cfg.train.patience = 50
    return cfg


def mae_preset(cfg: Config | None = None) -> Config:
    """MAE regime (same script, model='MAE'): mask ratio 0.5 at the call site
    (Transformation_based/utils.py:205), patch 16, same optimizer."""
    cfg = genesis_preset(cfg)
    cfg.task.name = "mae"
    cfg.task.mask_ratio = 0.5
    cfg.task.patch_size = 16
    return cfg


def mae_tuned_preset(cfg: Config | None = None) -> Config:
    """cmx-tuned MAE — a deliberate deviation from the reference recipe
    (RESULTS.md round 5, "MAE transfer made positive"): mask ratio 0.75
    instead of 0.5. On the hard-synthetic 79/1-analog the reference recipe
    transfers negatively (test Dice 0.4297 vs scratch 0.4752) because at
    ratio 0.5 the vessels are locally inpaintable; 0.75 forces longer-range
    structure and transferred best of every measured variant on seed 0
    (0.5192). The round-5 n=3 replication narrows the claim: across corpus
    seeds the means are mae_tuned 0.5206 vs default mae 0.5149 vs scratch
    0.5097 (79/1), but the per-seed wins are seed-0-specific (+8.8 pts vs
    default; seeds 1/2: -6.5/-0.6) — within seed noise overall
    (RESULTS round 5). Select with `--task mae_tuned --preset`; the plain
    `mae` preset stays reference-faithful
    (Transformation_based/utils.py:205, ratio 0.5)."""
    cfg = mae_preset(cfg)
    cfg.task.mask_ratio = 0.75
    return cfg


def genesis_tuned_preset(cfg: Config | None = None) -> Config:
    """cmx-tuned Model Genesis — a deliberate deviation from the reference
    rates (Transformation_based/config.py:35-40), measured in RESULTS.md
    round 3 ("Genesis anomaly grounded"): the default chain's MSE mass is
    ~77% the global Bezier intensity remap, which is solvable as per-image
    tone-curve inversion with zero shape knowledge, and the full recipe
    transfers NEGATIVELY on the hard-synthetic corpus (2-seed mean 0.4447
    vs scratch 0.4546 at the 79/1-analog). Zeroing the nonlinear remap
    (task.genesis_nonlinear_rate=0, every other knob reference-faithful)
    flips the transfer positive on both seeds (2-seed mean 0.4937,
    +3.9 pts over scratch). Round-5 n=3 scope: the fix is a low-label
    effect — at 79/1 it beats the default on every corpus seed (n=3 mean
    +3.6 pts), at 50/30 the two recipes tie (0.7449 vs 0.7455, both
    ~+0.6 over scratch; RESULTS round 5). Select with
    `--task genesis_tuned --preset`; the plain `genesis` preset stays
    reference-faithful."""
    cfg = genesis_preset(cfg)
    cfg.task.genesis_nonlinear_rate = 0.0
    return cfg


def moco_preset(cfg: Config | None = None) -> Config:
    """MoCo v2 (moco2_module.py:338-395): SGD lr .03 momentum .9 wd 1e-4,
    queue 65536, T=.07, m=.999, 224 views, 500 epochs."""
    cfg = cfg or Config()
    cfg.task.name = "moco"
    cfg.optim.name = "sgd"
    cfg.optim.lr = 0.03
    cfg.optim.momentum = 0.9
    cfg.optim.weight_decay = 1e-4
    cfg.optim.clip_norm = None
    cfg.task.num_negatives = 65536
    cfg.task.temperature = 0.07
    cfg.task.ema_momentum = 0.999
    cfg.task.view_size = 224
    cfg.train.epochs = 500
    cfg.train.batch_size = 256
    return cfg


def moco_fast_preset(cfg: Config | None = None) -> Config:
    """MoCo v2 with cmx's fast view options, a deliberate deviation set
    that cmx tested for transfer equivalence:

    * rotation_method="shear3": rot90 and three integer row shears in place
      of the nearest gather (per-pixel rounding deviation only); in the
      port each shear is one gather.
    * crop_impl="bank_fused": integer crop windows (torchvision's own
      get_params quantization) with weights fetched by index from a bank,
      and crop + blur + flips composed into two fp32 batched matmuls.

    The plain `moco` preset stays reference-faithful. chip_smoke.py's MF
    phase runs this preset's step beside `moco`'s with K4 on the card, and
    its VIEWS phase times each view option (PERF.md section 5)."""
    cfg = moco_preset(cfg)
    cfg.task.rotation_method = "shear3"
    cfg.task.crop_impl = "bank_fused"
    return cfg


def spark_preset(cfg: Config | None = None) -> Config:
    """SparK (Spark/utils/arg_util.py:16-93): LAMB, base lr 2e-4 x bs/256,
    wd .04 -> .2 cosine, mask .6, bs 128, 1600 ep, warmup 40, clip 5,
    full-UNet decoder."""
    cfg = cfg or Config()
    cfg.task.name = "spark"
    cfg.optim.name = "lamb"
    cfg.optim.lr = 2e-4
    cfg.optim.base_lr_scaled = True
    cfg.optim.weight_decay = 0.04
    cfg.optim.wd_end = 0.2
    cfg.optim.clip_norm = 5.0
    cfg.optim.warmup_epochs = 40
    cfg.task.mask_ratio = 0.6
    cfg.task.full_unet = True
    cfg.train.batch_size = 128
    cfg.train.epochs = 1600
    return cfg


def cmunet_preset(cfg: Config | None = None) -> Config:
    """CM-UNet (configs/cmunet_config.py:70-114): AdamW lr 1.5e-4-scaled,
    bs 256, 300 epochs, warmup 40, mask .65 patch 16, T=.07, EMA .996."""
    cfg = cfg or Config()
    cfg.task.name = "cmunet"
    cfg.optim.name = "adamw"
    cfg.optim.lr = 1.5e-4
    cfg.optim.base_lr_scaled = True
    cfg.optim.weight_decay = 0.05
    cfg.optim.warmup_epochs = 40
    cfg.task.mask_ratio = 0.65
    cfg.task.patch_size = 16
    cfg.task.temperature = 0.07
    cfg.task.ema_momentum = 0.996
    cfg.task.view_size = 224
    cfg.train.batch_size = 256
    cfg.train.epochs = 300
    return cfg


PRESETS = {
    "genesis": genesis_preset,
    "genesis_tuned": genesis_tuned_preset,
    "mae": mae_preset,
    "mae_tuned": mae_tuned_preset,
    "moco": moco_preset,
    "moco_fast": moco_fast_preset,
    "spark": spark_preset,
    "cmunet": cmunet_preset,
}
