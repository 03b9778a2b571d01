"""Visualization helpers (port of cmx/eval/visualize.py: the reference's
`visualize`, Finetuning/dataset.py:57-77, and SparK's vis triplet).
Matplotlib is optional: the functions raise ImportError without it."""

from __future__ import annotations

from typing import Optional

import numpy as np


def visualize(save_path: Optional[str] = None, **images) -> None:
    """Plot named grayscale images in one row (dataset.py:57-77)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    fig = plt.figure(figsize=(4 * n, 4))
    for i, (name, img) in enumerate(images.items()):
        ax = fig.add_subplot(1, n, i + 1)
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_title(name.replace("_", " ").title())
        ax.imshow(np.asarray(img), cmap="gray")
    if save_path:
        fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    else:
        plt.show()


def save_reconstruction_triplet(
    inp: np.ndarray, masked: np.ndarray, rec: np.ndarray, path: str
) -> None:
    """SparK vis-mode triplet (spark.py:125-129) for the first sample."""
    visualize(
        save_path=path,
        input=np.asarray(inp)[0],
        masked_input=np.asarray(masked)[0],
        reconstruction=np.asarray(rec)[0],
    )
