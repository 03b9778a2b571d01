"""Evaluation entry point (port of cmx/cli/evaluate.py): metrics for a
pretrained encoder on the test split.

    python -m cmx_torch.cli.evaluate --encoder ckpt/spark/encoder.npz \
        [--probe [HIDDEN]] [--vis CKPT_DIR] [data.ratio=0.01 ...]
    python -m cmx_torch.cli.evaluate --device cpu data.synthetic=True ...

Extras:
  --probe [HIDDEN]  SSLEvaluator-style probe on frozen GAP features of the
                    same encoder.npz (0 = linear; the reference MLP's
                    default 512, pl_bolts evaluator.py:10-26)
  --vis CKPT_DIR    SparK reconstruction triplet from a pretrain
                    checkpoint dir's model.npz (spark.py:125-129 vis mode):
                    reconstruction.png, or reconstruction.npz without
                    matplotlib

As in cmx: a synthetic corpus is written when data.synthetic is set or the
data dir has no images, the test split of the seed-42 splits is scored by
`harness.evaluate` with an eval-mode UNet (random weights from
train.seed, the encoder loaded over them), and the metrics print as JSON
rounded to 4 decimals. Everything runs on the card unless `--device cpu`
is given; `main` returns the unrounded metrics. cmx's JAX compile cache
has no counterpart.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from cmx_torch import resolve_device
from cmx_torch.config.config import Config, apply_overrides


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--encoder", default=None, help="encoder.npz to load")
    p.add_argument("--probe", nargs="?", const=512, default=None, type=int,
                   metavar="HIDDEN",
                   help="probe frozen GAP features (0=linear, default 512=MLP)")
    p.add_argument("--vis", default=None, metavar="CKPT_DIR",
                   help="save a SparK reconstruction triplet from this "
                        "pretrain checkpoint dir")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = Config()
    apply_overrides(cfg, args.overrides)

    from cmx_torch.utils.seeding import seed_everything

    seed_everything(cfg.train.seed)

    from cmx_torch.ckpt.checkpoint import load_encoder
    from cmx_torch.data.corpus import load_corpus
    from cmx_torch.data.splits import list_corpus, make_splits
    from cmx_torch.data.synthetic import write_corpus
    from cmx_torch.models.unet import UNet
    from cmx_torch.train.harness import evaluate, upload_set
    from cmx_torch.train.supervised import make_eval_fn

    if cfg.data.synthetic or not os.path.isdir(
            os.path.join(cfg.data.data_dir, "imgs")):
        write_corpus(cfg.data.data_dir, n=cfg.data.synthetic_n,
                     size=cfg.data.image_size)
    xs, ys = list_corpus(cfg.data.data_dir)
    splits = make_splits(xs, ys, ratio=cfg.data.ratio)
    te_imgs, te_masks = load_corpus(splits.test_x, splits.test_y,
                                    size=cfg.data.image_size)
    xte, yte = upload_set(te_imgs, te_masks, dev)

    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
    model = UNet(out_classes=cfg.model.out_classes, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(dev)
    if args.encoder:
        load_encoder(args.encoder, model)
    metrics: Dict[str, Any] = evaluate(make_eval_fn(model), xte, yte)

    if args.probe is not None:
        # Probe on FROZEN encoder features (pl_bolts SSLEvaluator analog).
        from cmx_torch.models.unet import UNetEncoderGAP
        from cmx_torch.ssl.linear_probe import (extract_features,
                                                fg_fraction_labels, probe)

        gap = UNetEncoderGAP(dtype=dtype)
        gap.reset_parameters(torch.Generator().manual_seed(0))
        gap = gap.to(dev).eval()
        if args.encoder:
            load_encoder(args.encoder, gap)
        feats = extract_features(gap, te_imgs)
        labels = fg_fraction_labels(yte.cpu().numpy())
        hidden = args.probe if args.probe > 0 else None
        res = probe(feats, labels, hidden_dim=hidden)
        metrics.update({f"probe_{k}": v for k, v in res.items()})

    if args.vis:
        from cmx_torch.ckpt.checkpoint import load_model_npz
        from cmx_torch.eval.visualize import save_reconstruction_triplet
        from cmx_torch.ops.masking import spark_active_mask
        from cmx_torch.ssl.spark import SparKModel, spark_reconstruct

        smodel = SparKModel(dtype=dtype)
        smodel.reset_parameters(torch.Generator().manual_seed(0))
        smodel = load_model_npz(os.path.join(args.vis, "model.npz"),
                                smodel.to(dev))
        n_vis = min(4, te_imgs.shape[0])
        f = cfg.data.image_size // 16
        active = spark_active_mask(
            torch.Generator(device=dev).manual_seed(cfg.train.seed), n_vis,
            f, smodel.mask_ratio)
        inp, masked, rec = (t.cpu().numpy() for t in spark_reconstruct(
            smodel, xte[:n_vis], active))
        out_png = os.path.join(args.vis, "reconstruction.png")
        try:
            save_reconstruction_triplet(inp, masked, rec, out_png)
            metrics["vis_path"] = out_png
        except ImportError:
            out_npz = os.path.join(args.vis, "reconstruction.npz")
            np.savez(out_npz, input=inp, masked=masked, reconstruction=rec)
            metrics["vis_path"] = out_npz

    print(json.dumps({k: (round(float(v), 4) if not isinstance(v, str) else v)
                      for k, v in metrics.items()}, indent=2))
    return metrics


if __name__ == "__main__":
    main()
