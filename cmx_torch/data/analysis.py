"""Corpus analysis utilities, a copy of cmx/data/analysis.py
(data_processing/utils.py:34-116).

Per-group intensity histograms and Bhattacharyya similarity between
hospital/site distributions — the reference uses these to study FAME2 site
shift; host-side numpy, matplotlib imported only by `ridgeline` (the machine
with the card may have none).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def intensity_histogram(
    images: Sequence[np.ndarray], bins: int = 64, value_range=(-4.0, 4.0)
) -> np.ndarray:
    """Normalized intensity histogram over a set of images."""
    h = np.zeros(bins, dtype=np.float64)
    for im in images:
        hist, _ = np.histogram(np.asarray(im).ravel(), bins=bins, range=value_range)
        h += hist
    s = h.sum()
    return h / s if s > 0 else h


def bhattacharyya_coefficient(p: np.ndarray, q: np.ndarray) -> float:
    """BC(p, q) = sum sqrt(p_i q_i) in [0, 1]; 1 = identical distributions
    (data_processing/utils.py Bhattacharyya similarity)."""
    return float(np.sum(np.sqrt(np.asarray(p) * np.asarray(q))))


def group_similarity_matrix(
    groups: Dict[str, Sequence[np.ndarray]], bins: int = 64
) -> Dict[str, Dict[str, float]]:
    """Pairwise Bhattacharyya similarity between named groups of images."""
    hists = {k: intensity_histogram(v, bins=bins) for k, v in groups.items()}
    return {
        a: {b: bhattacharyya_coefficient(hists[a], hists[b]) for b in hists}
        for a in hists
    }


def group_by_center(
    keyed_images: Dict[str, np.ndarray], sep: str = "-"
) -> Dict[str, list]:
    """Group images by hospital/center prefix of the patient key
    (data_processing/utils.py:34-50: '01-xxx' -> center '01')."""
    groups: Dict[str, list] = {}
    for key, img in keyed_images.items():
        center = str(key).split(sep)[0]
        groups.setdefault(center, []).append(np.asarray(img))
    return dict(sorted(groups.items()))


def center_mean_histograms(
    keyed_images: Dict[str, np.ndarray], bins: int = 256,
    value_range=(-4.0, 4.0),
) -> Dict[str, np.ndarray]:
    """Per-center MEAN intensity histogram (distribution_per_center,
    data_processing/utils.py:34-61): histogram each patient, average within
    the center."""
    out = {}
    for center, imgs in group_by_center(keyed_images).items():
        hists = [
            np.histogram(im.ravel(), bins=bins, range=value_range)[0].astype(
                np.float64
            )
            for im in imgs
        ]
        out[center] = np.mean(hists, axis=0)
    return out


def ridgeline(
    data: Dict[str, np.ndarray],
    overlap: float = 0.0,
    fill: bool = True,
    value_range=(-4.0, 4.0),
    save_path=None,
    ax=None,
):
    """Ridgeline plot of per-center histograms (data_processing/
    utils.py:86-116): one stacked filled curve per center. Matplotlib
    optional — raises ImportError cleanly when unavailable."""
    if not 0.0 <= overlap <= 1.0:
        raise ValueError("overlap must be in [0, 1]")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    names = list(data.keys())
    n_points = len(next(iter(data.values())))
    xx = np.linspace(value_range[0], value_range[1], n_points)
    step = max(float(np.max([np.max(v) for v in data.values()])), 1e-9)
    step *= 1.0 - overlap

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(8, 1.2 * len(names) + 2))
    ys = []
    try:
        cmap = plt.get_cmap("magma")
        colors = [cmap(i / max(len(names) - 1, 1)) for i in range(len(names))]
    except Exception:
        colors = ["C0"] * len(names)
    for i, name in enumerate(names):
        pdf = np.asarray(data[name], dtype=np.float64)
        y = i * step
        ys.append(y)
        if fill:
            ax.fill_between(xx, np.full(n_points, y), pdf + y,
                            zorder=len(names) - i + 1, color=colors[i])
        ax.plot(xx, pdf + y, c="k", lw=0.8, zorder=len(names) - i + 1)
    ax.set_yticks(ys)
    ax.set_yticklabels(names)
    ax.set_xlabel("intensity")
    if save_path and own_fig:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return ax
