"""npy corpus IO: load, resize-256 cache, one-hot masks (a copy of
cmx/data/corpus.py; PIL is imported inside the functions, as there).

Host-side counterpart of the reference datasets (Finetuning/dataset.py:12-55,
Spark/utils/dataset.py:24-27, Genesis_Chest_CT.py:43-58): np.load each
float32 image / uint8 mask, PIL-resize to 256x256 (bicubic for images,
nearest for masks), one-hot the mask.

Unlike the reference (per-item PIL work inside DataLoader workers, repeated
every epoch), the whole corpus is resized ONCE into a contiguous ndarray
cache — the datasets are tiny (hundreds of 256x256 images) and the cache is
then fed to the device in large batches; all random augmentation happens
on-device (cmx_torch.ops.augment).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def load_and_resize_image(path: str, size: int = 256) -> np.ndarray:
    """np.load + PIL bicubic resize to (size, size) float32
    (Finetuning/dataset.py:39-46)."""
    from PIL import Image

    arr = np.load(path)
    img = Image.fromarray(arr)
    img = img.resize((size, size), resample=Image.BICUBIC)
    return np.asarray(img, dtype=np.float32)


def load_and_resize_mask(path: str, size: int = 256) -> np.ndarray:
    """np.load + PIL nearest resize (Finetuning/dataset.py:47)."""
    from PIL import Image

    arr = np.load(path)
    msk = Image.fromarray(arr)
    msk = msk.resize((size, size), resample=Image.NEAREST)
    return np.asarray(msk)


def one_hot_encode(mask: np.ndarray, class_values: Sequence[Sequence[int]]) -> np.ndarray:
    """One-hot a label mask by class values, channel-LAST.

    Reference (Finetuning/dataset.py:79-97) builds channel maps by equality
    against each class value; default class_values [[0],[1]] -> 2 channels.
    """
    maps = [np.isin(mask, np.asarray(v)).astype(np.float32) for v in class_values]
    return np.stack(maps, axis=-1)


def load_corpus(
    image_paths: Sequence[str],
    mask_paths: Optional[Sequence[str]] = None,
    size: int = 256,
    class_values: Sequence[Sequence[int]] = ((0,), (1,)),
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load + resize a whole corpus into (N, size, size) images [+ one-hot masks].

    Returns images float32 and masks float32 (N, size, size, C) or None.
    """
    imgs = np.stack([load_and_resize_image(p, size) for p in image_paths])
    if mask_paths is None:
        return imgs, None
    masks = np.stack(
        [one_hot_encode(load_and_resize_mask(p, size), class_values) for p in mask_paths]
    )
    return imgs, masks
