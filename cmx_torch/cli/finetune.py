"""Supervised fine-tuning entry point (port of cmx/cli/finetune.py, the
reference's Finetuning/train.py surface).

    python -m cmx_torch.cli.finetune [--pretrained ckpt/spark/encoder.npz]
        [--lrs ...] [--epochs ...] [--batches ...] [data.ratio=0.01] ...
    python -m cmx_torch.cli.finetune --device cpu data.synthetic=True ...

The reference flow (train.py:429-471): seed-42 splits, the fine-tune and
test sets loaded, an optional pretrained encoder (`encoder.npz`, written by
either package) loaded into the UNet's encoder, the lr x epochs x batch grid
with 3-fold KFold, the final fit on the whole fine-tune set with the test
set as validation, and its evaluation with the host metrics. It writes
cmx's files: `<out>/result_finetuning_unet_<tag>.pkl` (the grid's results)
and `<out>/test_<tag>.json` (hypers, test metrics, dice = 1 - dice_loss),
where <tag> is the encoder file's name, or its directory's for the generic
names encoder / model, or "None". Everything runs on the card unless
`--device cpu` is given; `main` returns a summary dict besides printing it.
cmx's JAX compile cache has no counterpart.

On N cards (cmx's devices), one process a card:

    torchrun --standalone --nproc_per_node N -m cmx_torch.cli.finetune ...

makes an NCCL group from the launcher's variables (gloo with `--device
cpu`), each rank on cuda:LOCAL_RANK. Rank 0 writes the synthetic corpus
before any rank reads it, the initial weights are rank 0's, each fit trains
on k = gcd(batch, N) ranks (`harness.fit`), and rank 0 alone writes the
pickle and the json. Without WORLD_SIZE nothing of this runs.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional

import torch

from cmx_torch import resolve_device
from cmx_torch.config.config import Config, apply_overrides, display


def result_tag(pretrained: Optional[str]) -> str:
    """cmx's tag for a run's result files (cmx/cli/finetune.py:79-84)."""
    if not pretrained:
        return "None"
    tag = os.path.basename(pretrained).split(".")[0]
    if tag in ("encoder", "model"):  # a generic export name: the
        # checkpoint's directory (the task) keeps results apart
        tag = os.path.basename(os.path.dirname(os.path.abspath(pretrained))) \
            or tag
    return tag


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pretrained", "-p", default=None,
                   help="encoder.npz exported by a pretraining run")
    p.add_argument("--lrs", type=float, nargs="*",
                   default=[1e-2, 1e-3, 1e-4, 1e-5])
    p.add_argument("--epochs", type=int, nargs="*", default=[128])
    p.add_argument("--batches", type=int, nargs="*", default=[32])
    p.add_argument("--out", default="results")
    p.add_argument("--corpus-seed", type=int, default=None,
                   help="corpus-seed axis: sugar for data.corpus_seed=N "
                        "(resolves data_dir -> data_dir_sN, seeds synthetic "
                        "generation)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu "
                        "(the kernels' plain versions)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)

    from cmx_torch.parallel.dist import initialize_distributed, shutdown

    dev = resolve_device(args.device)
    made_group = initialize_distributed(dev)
    try:
        return _run(args, dev)
    finally:
        if made_group:
            shutdown()


def _run(args: argparse.Namespace, dev: torch.device) -> Dict[str, Any]:
    from cmx_torch.parallel import mesh
    from cmx_torch.parallel.dist import local_rank, on_main, process_info

    if mesh.active():
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank())
        rank, world = process_info()
        print(f"process group: {mesh.backend()} rank {rank} "
              f"of {world} on {dev}")
    cfg = Config()
    apply_overrides(cfg, args.overrides)
    if args.corpus_seed is not None:
        cfg.data.corpus_seed = args.corpus_seed
    print(display(cfg))

    from cmx_torch.utils.seeding import seed_everything

    seed_everything(cfg.train.seed)

    from cmx_torch.data.corpus import load_corpus
    from cmx_torch.data.splits import list_corpus, make_splits
    from cmx_torch.data.synthetic import resolve_corpus
    from cmx_torch.models.unet import UNet
    from cmx_torch.train.harness import evaluate, fit, grid_search, upload_set
    from cmx_torch.train.supervised import make_eval_fn

    if mesh.active():  # rank 0 writes a synthetic corpus before any reads
        on_main(resolve_corpus, cfg.data)
    xs, ys = list_corpus(resolve_corpus(cfg.data))
    splits = make_splits(xs, ys, ratio=cfg.data.ratio)
    ft_imgs, ft_masks = load_corpus(splits.finetune_x, splits.finetune_y,
                                    size=cfg.data.image_size)
    te_imgs, te_masks = load_corpus(splits.test_x, splits.test_y,
                                    size=cfg.data.image_size)
    print(f"fine-tune set {len(ft_imgs)} images, test set {len(te_imgs)}")

    dtype = torch.bfloat16 if cfg.model.dtype == "bfloat16" else torch.float32
    model = UNet(out_classes=cfg.model.out_classes, dtype=dtype,
                 fused=cfg.model.fused_conv,
                 up_sample_mode=cfg.model.up_sample_mode)
    model.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    model = model.to(dev)
    if args.pretrained:
        from cmx_torch.ckpt.checkpoint import load_encoder

        load_encoder(args.pretrained, model)
        print(f"loaded pretrained encoder from {args.pretrained}")
    mesh.replicate(model)  # every rank starts from rank 0's weights

    os.makedirs(args.out, exist_ok=True)
    tag = result_tag(args.pretrained)
    results_path = os.path.join(args.out, f"result_finetuning_unet_{tag}.pkl")
    lr, bs_, eps, results = grid_search(
        ft_imgs, ft_masks, lrs=args.lrs, epochs_grid=args.epochs,
        batches=args.batches, seed=cfg.train.seed, model=model,
        results_path=results_path, device=dev)
    print(f"best hypers: lr={lr} batch={bs_} epochs={eps}")

    # Final: retrain on the whole fine-tune set, evaluate on the held-out
    # test set (the reference's test(), train.py:380-426).
    res = fit(ft_imgs, ft_masks, te_imgs, te_masks, lr=lr, epochs=eps,
              batch=bs_, seed=cfg.train.seed, model=model, verbose=True,
              device=dev)
    xte, yte = upload_set(te_imgs, te_masks, dev)
    test_metrics = evaluate(make_eval_fn(res.state.model), xte, yte,
                            batch=bs_)
    print("test:", {k: round(v, 4) for k, v in test_metrics.items()})
    test_path = os.path.join(args.out, f"test_{tag}.json")
    dice = 1.0 - test_metrics["dice_loss"]
    on_main(_write_json, test_path, {
        "hypers": {"lr": lr, "batch": bs_, "epochs": eps},
        "test_metrics": test_metrics, "dice": dice})
    return {"state": res.state, "model": model, "tag": tag,
            "hypers": {"lr": lr, "batch": bs_, "epochs": eps},
            "grid": results, "final": res, "test_metrics": test_metrics,
            "dice": dice, "n_finetune": int(len(ft_imgs)),
            "n_test": int(len(te_imgs)), "results_path": results_path,
            "test_path": test_path}


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


if __name__ == "__main__":
    main()
