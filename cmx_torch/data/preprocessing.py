"""Offline preprocessing pipeline (the reference's data_processing/ silo), a
copy of cmx/data/preprocessing.py: host numpy, cv2 imported only inside
the steps that use it (the machine with the card may have none).

Counterpart of data_processing/pre_processing.py + utils.py (SURVEY §2.2):
a composable PreProcessor/Pipeline framework whose steps take parallel lists
of (images, masks) and return transformed lists, ending in the
dataset/imgs + dataset/masks npy layout every training silo consumes.

Steps reproduced (with file:line citations to the reference):
  * load_images        — walk FAME2labelling/<patient>/<view>/raw.tif +
                         labelled.tif (utils.py:9-32)
  * UnlabelledRemover  — drop images with no labelled mask (pre_processing.py:48-69)
  * MaskIntegrater     — merge per-vessel masks to one binary (187-216)
  * MaskContourFiller  — fill mask contours (218-251)
  * Cropper            — center-crop + dark-border inpaint + pad (253-295, 330-368)
  * Unsharper          — unsharp mask radius 60 amount 3 (163-185)
  * IntensityNormalizer— per-image z-score (95-129)
  * MinMaxNormalizer   — per-image [0,1] scaling (131-161, unused by notebook
                         but part of the surface)
"""

from __future__ import annotations

import abc
import os
from typing import List, Sequence, Tuple

import numpy as np


class PreProcessor(abc.ABC):
    """Abstract step: transform(images, masks) -> (images, masks)
    (pre_processing.py:11-46)."""

    @abc.abstractmethod
    def transform(self, images: List[np.ndarray], masks: List[np.ndarray]):
        """(images, masks) -> the transformed (images, masks)."""

    def fit_transform(self, images, masks):
        return self.transform(images, masks)


class Pipeline(PreProcessor):
    """Sequential composition (pre_processing.py:370-423)."""

    def __init__(self, steps: Sequence[PreProcessor]):
        self.steps = list(steps)

    def transform(self, images, masks):
        for step in self.steps:
            images, masks = step.transform(images, masks)
        return images, masks


class UnlabelledRemover(PreProcessor):
    """Drop samples whose mask is empty/None (pre_processing.py:48-69)."""

    def transform(self, images, masks):
        keep = [
            i for i, m in enumerate(masks)
            if m is not None and np.asarray(m).sum() > 0
        ]
        return [images[i] for i in keep], [masks[i] for i in keep]


class MaskIntegrater(PreProcessor):
    """Merge a list of per-vessel masks into one binary mask
    (pre_processing.py:187-216)."""

    def transform(self, images, masks):
        out = []
        for m in masks:
            if isinstance(m, (list, tuple)):
                merged = np.zeros_like(np.asarray(m[0]))
                for part in m:
                    merged = np.maximum(merged, np.asarray(part))
            else:
                merged = np.asarray(m)
            out.append((merged > 0).astype(np.uint8) * 255)
        return images, out


class MaskContourFiller(PreProcessor):
    """Close + fill mask contours via cv2 findContours/drawContours
    (pre_processing.py:218-251)."""

    def transform(self, images, masks):
        import cv2

        out = []
        for m in masks:
            m8 = (np.asarray(m) > 0).astype(np.uint8)
            contours, _ = cv2.findContours(
                m8, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE
            )
            filled = np.zeros_like(m8)
            cv2.drawContours(filled, contours, -1, 1, thickness=-1)
            out.append(filled * 255)
        return images, out


class Cropper(PreProcessor):
    """Center-crop to `size`, inpaint dark corner borders (Telea), pad
    (pre_processing.py:253-295 ReplaceWithBorderPixel + 330-368 Cropper)."""

    def __init__(self, size: int = 475, border_ratio: float = 0.3, thresh: int = 30):
        self.size = size
        self.border_ratio = border_ratio
        self.thresh = thresh

    def _center_crop_or_pad(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[:2]
        s = self.size
        y0 = max((h - s) // 2, 0)
        x0 = max((w - s) // 2, 0)
        img = img[y0 : y0 + s, x0 : x0 + s]
        ph, pw = s - img.shape[0], s - img.shape[1]
        if ph > 0 or pw > 0:
            img = np.pad(
                img,
                ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)),
                mode="edge",
            )
        return img

    def _inpaint_dark_borders(self, img: np.ndarray) -> np.ndarray:
        import cv2

        h, w = img.shape[:2]
        b = int(min(h, w) * self.border_ratio)
        border = np.zeros((h, w), np.uint8)
        border[:b, :] = border[-b:, :] = 1
        border[:, :b] = border[:, -b:] = 1
        img8 = img.astype(np.uint8) if img.dtype != np.uint8 else img
        dark = (img8 < self.thresh).astype(np.uint8)
        mask = dark & border
        if mask.sum() == 0:
            return img
        return cv2.inpaint(img8, mask, 3, cv2.INPAINT_TELEA)

    def transform(self, images, masks):
        imgs = [
            self._center_crop_or_pad(self._inpaint_dark_borders(np.asarray(im)))
            for im in images
        ]
        msks = [self._center_crop_or_pad(np.asarray(m)) for m in masks]
        return imgs, msks


class Unsharper(PreProcessor):
    """Unsharp mask, radius 60, amount 3 (pre_processing.py:163-185)."""

    def __init__(self, radius: int = 60, amount: float = 3.0):
        self.radius = radius
        self.amount = amount

    def transform(self, images, masks):
        import cv2

        out = []
        k = self.radius * 2 + 1
        for im in images:
            f = np.asarray(im, dtype=np.float32)
            blur = cv2.GaussianBlur(f, (0, 0), sigmaX=self.radius / 3.0)
            sharp = f + self.amount * (f - blur)
            out.append(sharp)
        return out, masks


class IntensityNormalizer(PreProcessor):
    """Per-image z-score (pre_processing.py:95-129)."""

    def transform(self, images, masks):
        out = []
        for im in images:
            f = np.asarray(im, dtype=np.float32)
            out.append((f - f.mean()) / (f.std() + 1e-8))
        return out, masks


class MinMaxNormalizer(PreProcessor):
    """Per-image [0,1] scaling (pre_processing.py:131-161)."""

    def transform(self, images, masks):
        out = []
        for im in images:
            f = np.asarray(im, dtype=np.float32)
            lo, hi = f.min(), f.max()
            out.append((f - lo) / (hi - lo + 1e-8))
        return out, masks


def load_images(root: str) -> Tuple[List[np.ndarray], List[List[np.ndarray]], List[str]]:
    """Walk <root>/<patient>/<view>/raw.tif + *labelled*.tif, grayscale
    (data_processing/utils.py:9-32). Returns (images, per-vessel-mask lists,
    keys)."""
    import cv2

    images, masks, keys = [], [], []
    for patient in sorted(os.listdir(root)):
        pdir = os.path.join(root, patient)
        if not os.path.isdir(pdir):
            continue
        for view in sorted(os.listdir(pdir)):
            vdir = os.path.join(pdir, view)
            raw = os.path.join(vdir, "raw.tif")
            if not os.path.isfile(raw):
                continue
            img = cv2.imread(raw, cv2.IMREAD_GRAYSCALE)
            vessel_masks = []
            for f in sorted(os.listdir(vdir)):
                if "labelled" in f and f.endswith((".tif", ".png")):
                    m = cv2.imread(os.path.join(vdir, f), cv2.IMREAD_GRAYSCALE)
                    if m is not None:
                        vessel_masks.append(m)
            images.append(img)
            masks.append(vessel_masks)
            keys.append(f"{patient}_{view}")
    return images, masks, keys


def default_pipeline(crop_size: int = 475) -> Pipeline:
    """The notebook's pipeline (data_processing.ipynb cell 1): Unlabelled ->
    MaskIntegrate -> ContourFill -> Crop(border .3, thresh 30) -> Unsharp ->
    z-score."""
    return Pipeline([
        UnlabelledRemover(),
        MaskIntegrater(),
        MaskContourFiller(),
        Cropper(size=crop_size, border_ratio=0.3, thresh=30),
        Unsharper(),
        IntensityNormalizer(),
    ])


def write_dataset(
    images: Sequence[np.ndarray],
    masks: Sequence[np.ndarray],
    keys: Sequence[str],
    out_dir: str,
) -> None:
    """Write the dataset/imgs + dataset/masks npy layout (notebook cell 3):
    float32 images, mask // 255 uint8."""
    img_dir = os.path.join(out_dir, "imgs")
    msk_dir = os.path.join(out_dir, "masks")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(msk_dir, exist_ok=True)
    for im, m, k in zip(images, masks, keys):
        np.save(os.path.join(img_dir, f"{k}.npy"), np.asarray(im, np.float32))
        np.save(os.path.join(msk_dir, f"{k}.npy"),
                (np.asarray(m) // 255).astype(np.uint8))
