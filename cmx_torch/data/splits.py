"""Deterministic data-split contract (seed 42), a copy of cmx/data/splits.py.

Every reference silo re-derives identical splits with sklearn's
train_test_split(random_state=42) (Finetuning/train.py:467-468,
Genesis_Chest_CT.py:28-29, Spark/main.py:56-57, moco_data_module.py:156-157,
cmunet_dataset.py:31-32); cmx calls that function. The machine with the card
has no scikit-learn, so `train_test_split` here repeats its arithmetic for
a float test_size and lists: n_test = ceil(test_size * n), one
np.random.RandomState(random_state).permutation(n), test = its first n_test
entries, train the rest, in permutation order. The splits equal cmx's for
any file list (tests/test_torch_port_cli.py holds them to it). `KFold`
repeats scikit-learn's KFold(shuffle=True) the same way (the fine-tune
harness's folds; tests/test_torch_port_finetune.py).

Layout contract (SURVEY §1 L0->L1): dataset/imgs/<key>.npy (float32 2-D,
intensity-normalized) and dataset/masks/<key>.npy (uint8 {0,1}).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def train_test_split(*arrays: Sequence, test_size: float,
                     random_state: int = 42) -> List[list]:
    """sklearn.model_selection.train_test_split for lists and a float
    test_size in (0, 1) (shuffled, not stratified): [train_0, test_0,
    train_1, test_1, ...]."""
    n = len(arrays[0])
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         f"(0, 1) range")
    n_test = math.ceil(test_size * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(f"With n_samples={n}, test_size={test_size}, the "
                         f"resulting train set will be empty.")
    perm = np.random.RandomState(random_state).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    out: List[list] = []
    for a in arrays:
        out += [[a[i] for i in train], [a[i] for i in test]]
    return out


class KFold:
    """sklearn.model_selection.KFold(n_splits, shuffle=True, random_state),
    the fine-tune harness's: np.random.RandomState(random_state).shuffle(
    arange(n)), folds of n // k samples, one more in each of the first
    n % k; split() yields (train, test) index arrays, both in ascending
    order."""

    def __init__(self, n_splits: int = 5, random_state: int = 42):
        if n_splits < 2:
            raise ValueError(f"n_splits={n_splits} must be at least 2")
        self.n_splits = n_splits
        self.random_state = random_state

    def split(self, x: Sequence):
        n = len(x)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits="
                             f"{self.n_splits} greater than the number of "
                             f"samples: n_samples={n}.")
        order = np.arange(n)
        np.random.RandomState(self.random_state).shuffle(order)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = np.zeros(n, dtype=bool)
            test[order[start:start + size]] = True
            start += size
            yield np.flatnonzero(~test), np.flatnonzero(test)


def list_corpus(data_dir: str) -> Tuple[List[str], List[str]]:
    """Sorted (image_paths, mask_paths) from dataset/imgs + dataset/masks.

    Mirrors prepare_train_test (Finetuning/dataset.py:116-132): sorted
    listdir over the two directories.
    """
    img_dir = os.path.join(data_dir, "imgs")
    msk_dir = os.path.join(data_dir, "masks")
    imgs = sorted(os.listdir(img_dir))
    msks = sorted(os.listdir(msk_dir))
    return (
        [os.path.join(img_dir, f) for f in imgs],
        [os.path.join(msk_dir, f) for f in msks],
    )


@dataclass
class Splits:
    """The three-way split every regime shares.

    test: fixed held-out 20%.
    pretrain: the (1 - ratio/0.8) share of the remaining 80% — unlabeled SSL.
    finetune: the ratio/0.8 share — labeled supervised set.
    """

    pretrain_x: List[str]
    pretrain_y: List[str]
    finetune_x: List[str]
    finetune_y: List[str]
    test_x: List[str]
    test_y: List[str]


def make_splits(x: Sequence[str], y: Sequence[str], ratio: float = 0.1) -> Splits:
    """The exact double-split: 80/20 then ratio/0.8 of the 80%.

    ratio is the fine-tune fraction of the FULL corpus: ratio=0.3 -> 50/30
    split, ratio=0.01 -> the 18-image 79/1 split (reference train.py:467-468;
    cmunet_dataset.py:32 hard-codes the equivalent 0.0125 of the 80%).
    """
    x_train, x_test, y_train, y_test = train_test_split(
        list(x), list(y), test_size=0.2, random_state=42
    )
    pre_x, ft_x, pre_y, ft_y = train_test_split(
        x_train, y_train, test_size=ratio / 0.8, random_state=42
    )
    return Splits(pre_x, pre_y, ft_x, ft_y, x_test, y_test)
