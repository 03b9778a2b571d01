"""Synthetic angiography-like corpus (a copy of cmx/data/synthetic.py).

The port imports nothing of `cmx`, so it keeps this copy: the same
generator, the same `write_corpus` layout and meta.json, and the same
`resolve_corpus` rules, so a corpus written by either package is byte-equal
and serves both.

The FAME2 dataset is private; tests and throughput benchmarks need data with
the same contract (float32 intensity-normalized 2-D images + binary vessel
masks, SURVEY §1 L0->L1). This generator draws random smooth "vessel" paths
(random-walk polylines with varying radius) on a noisy background — enough
structure for Dice/clDice/Hausdorff metrics and for SSL objectives to have
learnable signal.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np


def _vessel_mask(rng: np.random.Generator, size: int, n_vessels: int = 3) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((size, size), dtype=bool)
    for _ in range(n_vessels):
        # random-walk centerline
        pos = np.array([rng.uniform(0, size), rng.uniform(0, size)])
        vel = rng.normal(size=2)
        vel /= np.linalg.norm(vel) + 1e-9
        radius = rng.uniform(1.5, 4.0)
        for _ in range(size * 2):
            pos = pos + vel * 2.0
            vel = vel + rng.normal(size=2) * 0.3
            vel /= np.linalg.norm(vel) + 1e-9
            if not (0 <= pos[0] < size and 0 <= pos[1] < size):
                break
            d2 = (yy - pos[0]) ** 2 + (xx - pos[1]) ** 2
            mask |= d2 <= radius**2
    return mask


def _smooth(img: np.ndarray, iters: int = 2) -> np.ndarray:
    for _ in range(iters):
        img = (
            img
            + np.roll(img, 1, 0)
            + np.roll(img, -1, 0)
            + np.roll(img, 1, 1)
            + np.roll(img, -1, 1)
        ) / 5.0
    return img


def make_sample(rng: np.random.Generator, size: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """One (image, mask) pair: dark vessels on smooth bright background,
    z-scored like the reference's Intensity_normalizer
    (data_processing/pre_processing.py:95-129)."""
    mask = _vessel_mask(rng, size)
    bg = _smooth(rng.normal(0.6, 0.15, (size, size)), 3)
    img = bg - 0.35 * _smooth(mask.astype(np.float64), 2)
    img = img + rng.normal(0, 0.03, (size, size))
    img = (img - img.mean()) / (img.std() + 1e-8)
    return img.astype(np.float32), mask.astype(np.uint8)


def _vessel_tree(rng: np.random.Generator, size: int, n_roots: int) -> np.ndarray:
    """Branching vessel tree with tapering radius (the hard corpus's
    analog of a coronary tree)."""
    yy, xx = np.mgrid[0:size, 0:size]
    mask = np.zeros((size, size), dtype=bool)

    def walk(pos, vel, radius, steps, depth):
        nonlocal mask
        for _ in range(steps):
            pos = pos + vel * 2.0
            vel = vel + rng.normal(size=2) * 0.25
            vel /= np.linalg.norm(vel) + 1e-9
            radius = max(0.8, radius * rng.uniform(0.985, 1.001))  # taper
            if not (0 <= pos[0] < size and 0 <= pos[1] < size):
                return
            d2 = (yy - pos[0]) ** 2 + (xx - pos[1]) ** 2
            mask |= d2 <= radius**2
            if depth < 2 and rng.random() < 0.015:  # branch
                bvel = vel + rng.normal(size=2) * 0.8
                bvel /= np.linalg.norm(bvel) + 1e-9
                walk(pos.copy(), bvel, radius * rng.uniform(0.5, 0.8),
                     steps // 2, depth + 1)

    for _ in range(n_roots):
        edge = rng.integers(0, 4)
        pos = {
            0: np.array([0.0, rng.uniform(0, size)]),
            1: np.array([float(size - 1), rng.uniform(0, size)]),
            2: np.array([rng.uniform(0, size), 0.0]),
            3: np.array([rng.uniform(0, size), float(size - 1)]),
        }[edge]
        vel = np.array([size / 2, size / 2]) - pos
        vel = vel / (np.linalg.norm(vel) + 1e-9) + rng.normal(size=2) * 0.3
        vel /= np.linalg.norm(vel) + 1e-9
        walk(pos, vel, rng.uniform(1.5, 4.0), int(size * 1.5), 0)
    return mask


def make_sample_hard(
    rng: np.random.Generator, size: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """Harder angiography-like sample for transfer experiments: branching,
    tapering vessels with per-vessel contrast, occluding blobs over the
    vessels (the label stays the full tree, forcing shape priors),
    rib/diaphragm-like background structure, per-"site" gamma/intensity
    shift, and mixed noise. Designed so a 4-image fine-tune from scratch
    underfits while pretrained encoders transfer (VERDICT round 1, item 4)."""
    mask = _vessel_tree(rng, size, n_roots=int(rng.integers(2, 5)))

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    # background: smooth anatomy + soft periodic "ribs" + corner vignette
    bg = _smooth(rng.normal(0.6, 0.18, (size, size)), 3)
    angle = rng.uniform(0, np.pi)
    period = rng.uniform(28, 60)
    ribs = 0.05 * np.sin((np.cos(angle) * yy + np.sin(angle) * xx)
                         * 2 * np.pi / period + rng.uniform(0, 6.28))
    cy, cx = rng.uniform(0.3, 0.7, 2) * size
    vignette = -0.12 * (((yy - cy) ** 2 + (xx - cx) ** 2)
                        / (size * size * 0.5))
    contrast = rng.uniform(0.18, 0.45)
    img = bg + ribs + vignette - contrast * _smooth(mask.astype(np.float64), 2)

    # occluding blobs: bright/dark patches OVER the vessels
    for _ in range(int(rng.integers(2, 5))):
        oy, ox = rng.uniform(0, size, 2)
        r = rng.uniform(size * 0.04, size * 0.12)
        blob = np.exp(-(((yy - oy) ** 2 + (xx - ox) ** 2) / (2 * r * r)))
        img += rng.choice([-1.0, 1.0]) * rng.uniform(0.15, 0.3) * blob

    img += rng.normal(0, rng.uniform(0.02, 0.06), (size, size))
    # per-site intensity shift: gamma on a [0,1]-squashed copy
    lo, hi = img.min(), img.max()
    img01 = (img - lo) / (hi - lo + 1e-8)
    img01 = img01 ** rng.uniform(0.6, 1.6)
    img = (img01 - img01.mean()) / (img01.std() + 1e-8)  # z-score contract
    return img.astype(np.float32), mask.astype(np.uint8)


def write_corpus(
    data_dir: str, n: int = 32, size: int = 256, seed: int = 0,
    hard: bool = False,
) -> None:
    """Write a synthetic corpus in the reference's dataset/ layout.

    hard=True uses the transfer-experiment generator (make_sample_hard).
    Generation is ATOMIC and CONCURRENT-SAFE (round-3 advisor): samples
    are written into a per-process <data_dir>/.gen-<pid> (two concurrent
    writers never rmtree each other's in-flight tmp), a meta.json records
    the generation parameters, and the publish order is masks, meta, imgs
    LAST — so the imgs/ directory existing (the resolve_corpus commit
    check) implies the whole corpus is complete."""
    import shutil

    rng = np.random.default_rng(seed)
    tmp = os.path.join(data_dir, f".gen-{os.getpid()}")
    img_tmp = os.path.join(tmp, "imgs")
    msk_tmp = os.path.join(tmp, "masks")
    if os.path.isdir(tmp):  # leftover from a previous run of THIS pid
        shutil.rmtree(tmp)
    os.makedirs(img_tmp)
    os.makedirs(msk_tmp)
    gen = make_sample_hard if hard else make_sample
    for i in range(n):
        img, msk = gen(rng, size)
        np.save(os.path.join(img_tmp, f"sample_{i:04d}.npy"), img)
        np.save(os.path.join(msk_tmp, f"sample_{i:04d}.npy"), msk)
    meta_tmp = os.path.join(tmp, "meta.json")
    with open(meta_tmp, "w") as f:
        json.dump({"n": n, "size": size, "seed": seed, "hard": hard}, f)
    # publish: imgs/ LAST (it is the existence check other processes use)
    for sub, tmp_sub in (("masks", msk_tmp), ("meta.json", meta_tmp),
                         ("imgs", img_tmp)):
        final = os.path.join(data_dir, sub)
        if os.path.isdir(final):  # explicit regeneration: replace wholesale
            shutil.rmtree(final)
        elif os.path.isfile(final):
            os.remove(final)
        os.rename(tmp_sub, final)
    os.rmdir(tmp)


def corpus_meta_mismatch(data_dir: str, data_cfg) -> str:
    """Compare an existing corpus's meta.json against the resolved config.

    Returns "" when compatible. A corpus without meta.json (pre-round-4
    legacy, or hand-placed real data) is accepted as-is. A corpus whose
    recorded (n, size, hard, seed) disagree with what the config would
    generate is a silent-wrong-data hazard (round-3 advisor: a seed-0 easy
    corpus left at the same path would silently serve a later hard-corpus
    experiment) — the mismatch string names every differing field."""
    path = os.path.join(data_dir, "meta.json")
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        meta = json.load(f)
    want = {"n": data_cfg.synthetic_n, "size": data_cfg.image_size,
            "seed": data_cfg.corpus_seed, "hard": data_cfg.synthetic_hard}
    diffs = [f"{k}: corpus={meta.get(k)!r} config={v!r}"
             for k, v in want.items() if k in meta and meta[k] != v]
    return "; ".join(diffs)


def resolve_corpus(data_cfg) -> str:
    """Resolve (and lazily generate) the corpus directory for a DataConfig.

    The corpus-seed axis (round-2 VERDICT item 8): corpus_seed s>0 maps
    data_dir -> f"{data_dir}_s{s}" — the naming convention the round-2
    seed-replication experiments established by hand (runs/hard400_s1).
    When the resolved directory has no complete corpus (imgs/ AND masks/),
    the synthetic corpus is generated with that seed. Generation is
    idempotent-by-absence: an existing corpus is never overwritten, but a
    meta.json recording different generation parameters fails loudly
    instead of silently serving wrong data (round-3 advisor). Returns the
    resolved directory path."""
    d = data_cfg.data_dir
    if data_cfg.corpus_seed:
        d = f"{d}_s{data_cfg.corpus_seed}"
    if not (os.path.isdir(os.path.join(d, "imgs"))
            and os.path.isdir(os.path.join(d, "masks"))):
        write_corpus(d, n=data_cfg.synthetic_n, size=data_cfg.image_size,
                     seed=data_cfg.corpus_seed, hard=data_cfg.synthetic_hard)
    else:
        mismatch = corpus_meta_mismatch(d, data_cfg)
        if mismatch:
            raise RuntimeError(
                f"corpus at {d} was generated with different parameters "
                f"({mismatch}); point data.data_dir elsewhere or delete "
                f"the stale corpus to regenerate")
    return d


def make_batch(
    rng: np.random.Generator, batch: int, size: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """In-memory batch: images (B,H,W) float32, one-hot masks (B,H,W,2)."""
    imgs, masks = zip(*(make_sample(rng, size) for _ in range(batch)))
    imgs = np.stack(imgs)
    m = np.stack(masks).astype(np.float32)
    onehot = np.stack([1 - m, m], axis=-1)
    return imgs, onehot
