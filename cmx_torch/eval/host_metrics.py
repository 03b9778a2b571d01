"""Host-side (numpy/scipy/cv2) metrics: modified Hausdorff, artery radius.
A copy of cmx/eval/host_metrics.py (the port imports nothing of cmx), its
functions unchanged: class-last (B, H, W, C) arrays, as there; the
harness converts the port's NCHW tensors at the call.

Counterparts of the reference's Finetuning/metrics.py:224-395. They are
eval-only, irregular-shape algorithms (KD-trees over contour point sets,
skeletonization) that run on the host, only where the harness asks for them.

Implementation notes (no skimage):
  * contours: cv2.findContours on the binary mask (integer-pixel boundary).
    The reference uses skimage.measure.find_contours (subpixel marching
    squares); differences are sub-pixel and do not change model ranking.
  * skeleton: Zhang-Suen thinning (classic 2-subiteration algorithm), standing
    in for skimage.morphology.skeletonize.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree


def _mask_contour_points(mask: np.ndarray) -> np.ndarray:
    """Boundary points of a binary mask as (row, col) float array."""
    import cv2

    m = (np.asarray(mask) > 0).astype(np.uint8)
    contours, _ = cv2.findContours(m, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    if not contours:
        return np.empty((0, 2), dtype=np.float64)
    pts = np.concatenate([c.reshape(-1, 2) for c in contours], axis=0)
    # cv2 returns (x, y) = (col, row); flip to (row, col) like find_contours.
    return pts[:, ::-1].astype(np.float64)


def hausdorff_distance_mask(
    image0: np.ndarray, image1: np.ndarray, method: str = "modified"
) -> float:
    """(Modified) Hausdorff distance between mask contours (metrics.py:224-292).

    Empty-vs-empty -> 0; one-empty -> inf, exactly as the reference.
    """
    if method not in ("standard", "modified"):
        raise ValueError(f"unrecognized method {method}")
    a = _mask_contour_points(image0)
    b = _mask_contour_points(image1)
    if len(a) == 0:
        return 0.0 if len(b) == 0 else float("inf")
    if len(b) == 0:
        return float("inf")
    fwd = cKDTree(a).query(b, k=1)[0]
    bwd = cKDTree(b).query(a, k=1)[0]
    if method == "standard":
        return float(max(fwd.max(), bwd.max()))
    return float(max(fwd.mean(), bwd.mean()))


def hausdorff_metric(probs_fg: np.ndarray, target_fg: np.ndarray) -> float:
    """Batch-mean modified Hausdorff on thresholded foreground probabilities.

    Matches the `hausdorff` Metric (metrics.py:295-331): inputs are the
    foreground channel after softmax; threshold at 0.5.
    """
    pr = np.asarray(probs_fg) > 0.5
    gt = np.asarray(target_fg) > 0.5
    ds = [hausdorff_distance_mask(pr[i], gt[i]) for i in range(pr.shape[0])]
    return float(np.mean(ds))


# ---------------------------------------------------------------- skeleton


_ZS_NEIGHBOR_IDX = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def _zhang_suen_pass(img: np.ndarray, step: int) -> np.ndarray:
    """One sub-iteration of Zhang-Suen thinning, vectorized over the image."""
    p = [np.roll(np.roll(img, -dr, axis=0), -dc, axis=1) for dr, dc in _ZS_NEIGHBOR_IDX]
    p2, p3, p4, p5, p6, p7, p8, p9 = p
    b = p2 + p3 + p4 + p5 + p6 + p7 + p8 + p9
    seq = [p2, p3, p4, p5, p6, p7, p8, p9, p2]
    a = sum(((seq[i] == 0) & (seq[i + 1] == 1)).astype(np.int32) for i in range(8))
    if step == 0:
        c1 = (p2 * p4 * p6) == 0
        c2 = (p4 * p6 * p8) == 0
    else:
        c1 = (p2 * p4 * p8) == 0
        c2 = (p2 * p6 * p8) == 0
    remove = (img == 1) & (b >= 2) & (b <= 6) & (a == 1) & c1 & c2
    out = img.copy()
    out[remove] = 0
    return out


def skeletonize(mask: np.ndarray, max_iter: int = 200) -> np.ndarray:
    """Binary skeleton via Zhang-Suen thinning (stand-in for skimage)."""
    img = (np.asarray(mask) > 0).astype(np.int32)
    # Border cleared so rolls never wrap content.
    img[0, :] = img[-1, :] = 0
    img[:, 0] = img[:, -1] = 0
    for _ in range(max_iter):
        nxt = _zhang_suen_pass(_zhang_suen_pass(img, 0), 1)
        if np.array_equal(nxt, img):
            break
        img = nxt
    return img.astype(bool)


def compute_radius_arteries(mask: np.ndarray) -> Tuple[float, float, float]:
    """(2*min, 2*mean, 2*max) skeleton-to-contour radius (metrics.py:379-395)."""
    m = np.asarray(mask).astype(bool).copy()
    m[0, :] = m[:, 0] = m[:, -1] = m[-1, :] = False
    skel = skeletonize(m)
    contours = _mask_contour_points(m)
    skel_pts = np.argwhere(skel)
    if len(contours) == 0 or len(skel_pts) == 0:
        return 0.0, 0.0, 0.0
    radii, _ = cKDTree(contours).query(skel_pts, k=1)
    # Half-pixel boundary correction: cv2 contour points are centers of the
    # outermost FOREGROUND pixels, while the reference's
    # skimage.find_contours vertices lie on the 0/1 edge midpoints ~0.5 px
    # further out. Exact for axis-aligned boundaries (golden-tested against
    # the reference formulation in cmx's tests).
    radii = radii + 0.5
    return float(2 * radii.min()), float(2 * radii.mean()), float(2 * radii.max())


def radius_arteries_metric(logits: np.ndarray, target: np.ndarray) -> float:
    """Batch-mean |mean-radius(pred) - mean-radius(gt)| (metrics.py:333-347).

    Inputs are class-last (B, H, W, C) logits/one-hot; argmax over class.
    """
    pr = np.argmax(np.asarray(logits), axis=-1)
    gt = np.argmax(np.asarray(target), axis=-1)
    vals = [
        abs(
            compute_radius_arteries(pr[i].astype(bool))[1]
            - compute_radius_arteries(gt[i].astype(bool))[1]
        )
        for i in range(pr.shape[0])
    ]
    return float(np.mean(vals))
