"""The initial weights and the corpus of a run, made on the device from the
run's seed in a few large calls.

Weights follow a reference's spec, [(name, shape, init)]: "zeros",
"ones", ("trunc", std) a normal clamped at two deviations (flax's
truncated lecun-normal kernels and SparK's mask tokens, the cut made by a
clamp), ("normal", std), ("unit_rows",) normal draws scaled so that each
row over the last dimension has norm 1 (a queue of keys). Every drawn
entry comes from one flat draw, in the spec's order. The corpus is 1,024 (or the configuration's
count) smooth random fields with fine noise, each scaled to [0, 1]: a
synthetic stand-in for grey-level angiograms, the same for the same seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_WEIGHTS, _CORPUS = 2, 3  # streams of the run's seed
DRAWN = ("trunc", "normal", "unit_rows")


def generator(device, seed: int, stream: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 4 + stream) % (2 ** 63))
    return gen


def make_weights(spec: List[Tuple[str, tuple, object]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on `device`} for every entry of `spec`."""
    drawn = [(n, s, i) for n, s, i in spec if isinstance(i, tuple)]
    for name, _, init in drawn:
        if init[0] not in DRAWN:
            raise ValueError(f"{name}: unknown init {init!r}")
    sizes = [int(torch.Size(s).numel()) for _, s, _ in drawn]
    out: Dict[str, torch.Tensor] = {}
    if drawn:
        std = torch.tensor([1.0 if i[0] == "unit_rows" else i[1]
                            for _, _, i in drawn], device=device)
        cut = torch.tensor([2.0 * i[1] if i[0] == "trunc" else float("inf")
                            for _, _, i in drawn], device=device)
        counts = torch.tensor(sizes, device=device)
        flat = torch.randn(sum(sizes), generator=generator(device, seed,
                                                           _WEIGHTS),
                           device=device)
        bound = torch.repeat_interleave(cut, counts)
        flat = torch.maximum(torch.minimum(
            flat * torch.repeat_interleave(std, counts), bound), -bound)
        for (name, shape, init), part in zip(drawn, flat.split(sizes)):
            out[name] = part.view(shape)
            if init[0] == "unit_rows":
                out[name] = out[name] / torch.linalg.vector_norm(
                    out[name], dim=-1, keepdim=True)
    for name, shape, init in spec:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif not isinstance(init, tuple):
            raise ValueError(f"{name}: unknown init {init!r}")
    return {name: out[name] for name, _, _ in spec}


def make_corpus(n: int, size: int, seed: int, device) -> torch.Tensor:
    """(n, size, size) float32 images in [0, 1]."""
    gen = generator(device, seed, _CORPUS)
    coarse = torch.randn((n, 1, 16, 16), generator=gen, device=device)
    fields = F.interpolate(coarse, size=(size, size), mode="bicubic",
                           align_corners=False)[:, 0]
    fields = fields + 0.1 * torch.randn((n, size, size), generator=gen,
                                        device=device)
    lo = fields.amin(dim=(1, 2), keepdim=True)
    hi = fields.amax(dim=(1, 2), keepdim=True)
    return (fields - lo) / (hi - lo)


def index_rows(n_images: int, batch: int, steps: int, seed: int):
    """(steps, batch) int64 rows of image indices: successive batches of
    seeded permutations of the corpus (a new permutation an epoch), so
    the rows of the first epoch all differ."""
    rng = np.random.default_rng(seed)
    need = steps * batch
    perms = [rng.permutation(n_images)
             for _ in range(-(-need // n_images))]
    return np.concatenate(perms)[:need].reshape(steps, batch).astype(np.int64)
