"""K3, the SparK loss tail: the port's plain forward and backward (the
kernels' CPU paths) against cmx's `spark_loss_pallas` in interpret mode and
`jax.grad` of `spark_loss_pallas_trainable`, with rec in bf16 and fp32; and
a CPU replay of the CUDA forward's reduction order (csrc/spark_loss.cu).

Tolerances: the loss rel 1e-5 (the Pallas kernel sums patches by
block-indicator matmuls, the plain version by reshaped sums); drec 1e-6 abs
in fp32 (its entries are ~1e-3 here) and one bf16 ulp of each entry in bf16
(the fp32 values may round to either neighbour); the replay rel 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx.ops import pallas_ops as cpo
from cmx_torch.ops import _build
from cmx_torch.ops import pallas_ops as tpo


def _inputs(seed, B, H, rec_dtype):
    """imgs fp32, rec in rec_dtype (its values exact in both packages), the
    active grid (1 = visible), as numpy and torch."""
    rng = np.random.default_rng(seed)
    f = H // 16
    imgs = (rng.normal(size=(B, H, H)) * 2.0 + 0.5).astype(np.float32)
    rec_t = torch.from_numpy(rng.normal(size=(B, H, H)).astype(np.float32))
    rec_t = rec_t.to(rec_dtype)
    active = (rng.random((B, f, f)) > 0.6).astype(np.float32)
    active[0, 0, 0] = 0.0
    jrec = jnp.asarray(rec_t.float().numpy())
    if rec_dtype == torch.bfloat16:
        jrec = jrec.astype(jnp.bfloat16)
    return imgs, rec_t, active, jrec


def _bf16_ulp(x):
    """The spacing of bf16 at |x| (8 significant bits)."""
    x = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("B,H", [(2, 64), (3, 32)])
@pytest.mark.parametrize("rec_dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_and_backward_match_cmx(B, H, rec_dtype):
    imgs, rec, active, jrec = _inputs(B * H, B, H, rec_dtype)
    ref = cpo.spark_loss_pallas(jrec, jnp.asarray(imgs), jnp.asarray(active),
                                interpret=True)
    loss = tpo.spark_loss_pallas_plain(rec, torch.from_numpy(imgs),
                                       torch.from_numpy(active))
    assert abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref))

    g = 0.75
    jgrad = jax.grad(lambda r: g * cpo.spark_loss_pallas_trainable(
        r, jnp.asarray(imgs), jnp.asarray(active), 16))(jrec)
    drec = tpo.spark_loss_bwd_plain(rec, torch.from_numpy(imgs),
                                    torch.from_numpy(active),
                                    torch.tensor(g), 16)
    assert drec.dtype == rec_dtype
    ours = drec.float().numpy()
    theirs = np.asarray(jgrad.astype(jnp.float32))
    if rec_dtype == torch.float32:
        assert float(np.max(np.abs(ours - theirs))) <= 1e-6
    else:
        assert np.all(np.abs(ours - theirs) <= _bf16_ulp(theirs))
    assert float(np.max(np.abs(theirs))) > 1e-4  # not a vacuous comparison


@pytest.mark.parametrize("rec_dtype", [torch.float32, torch.bfloat16])
def test_spark_loss_autograd_on_the_cpu_is_the_plain_pair(rec_dtype):
    """SparkLoss on CPU tensors: the plain forward, and the plain backward
    through the `spark_loss_bwd` wrapper (recorded, no launch counted)."""
    imgs, rec, active, _ = _inputs(3, 2, 32, rec_dtype)
    imgs_t, act_t = torch.from_numpy(imgs), torch.from_numpy(active)
    before = (tpo.spark_loss_pallas.launches, tpo.spark_loss_bwd.launches)
    r = rec.clone().requires_grad_(True)
    _build.recorded = []
    try:
        loss = tpo.spark_loss_pallas_trainable(r, imgs_t, act_t, 16)
        (2.0 * loss).backward()
        names = [n for n, _ in _build.recorded]
    finally:
        _build.recorded = None
    assert names == ["spark_loss_pallas", "spark_loss_bwd"]
    assert torch.equal(loss.detach(),
                       tpo.spark_loss_pallas_plain(rec, imgs_t, act_t))
    assert torch.equal(r.grad, tpo.spark_loss_bwd_plain(
        rec, imgs_t, act_t, torch.tensor(2.0)))
    assert (tpo.spark_loss_pallas.launches,
            tpo.spark_loss_bwd.launches) == before


def _kernel_constant(name):
    src = (_build.CSRC / "spark_loss.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _replay_forward(rec, imgs, active):
    """The CUDA forward's sums in its order, in fp32: a block per (image,
    row of patches); warp w of kWarps adds the l2 * masked and masked of
    patches w, w + kWarps, ...; the block adds its warps in order; the last
    block's thread t adds partials t, t + kThreads, ..., then a halving tree
    over the threads; loss = sum / (masked + 1e-8)."""
    threads = _kernel_constant("kThreads")
    warps = threads // 32
    l2 = tpo.masked_l2_plain(rec, imgs, active).numpy()  # (B, fh, fw)
    masked = (1.0 - active).numpy().astype(np.float32)
    B, fh, fw = l2.shape
    partials = []
    for b in range(B):
        for row in range(fh):
            wl, wm = [], []
            for w in range(warps):
                al = am = np.float32(0.0)
                for j in range(w, fw, warps):
                    al = np.float32(al + l2[b, row, j])
                    am = np.float32(am + masked[b, row, j])
                wl.append(al)
                wm.append(am)
            bl = bm = np.float32(0.0)
            for w in range(warps):
                bl, bm = np.float32(bl + wl[w]), np.float32(bm + wm[w])
            partials.append((bl, bm))
    sl = np.zeros(threads, np.float32)
    sm = np.zeros(threads, np.float32)
    for t in range(threads):
        for i in range(t, len(partials), threads):
            sl[t] = np.float32(sl[t] + partials[i][0])
            sm[t] = np.float32(sm[t] + partials[i][1])
    half = threads // 2
    while half:
        sl[:half] = sl[:half] + sl[half:2 * half]
        sm[:half] = sm[:half] + sm[half:2 * half]
        half //= 2
    denom = np.float32(sm[0] + np.float32(1e-8))
    return np.float32(sl[0] / denom), denom


@pytest.mark.parametrize("B,H", [(2, 64), (24, 192)])  # 8 and 288 blocks
def test_kernel_reduction_order_replay_matches_plain(B, H):
    imgs, rec, active, _ = _inputs(7, B, H, torch.float32)
    loss, denom = _replay_forward(rec, torch.from_numpy(imgs),
                                  torch.from_numpy(active))
    ref = float(tpo.spark_loss_pallas_plain(rec, torch.from_numpy(imgs),
                                            torch.from_numpy(active)))
    assert abs(float(loss) - ref) <= 1e-6 * abs(ref)
    assert float(denom) == float((1.0 - active).sum())


def test_kernel_operands_are_checked_on_the_host():
    """What the K3 kernels take: 16x16 patches, H and W multiples of 16,
    rec (B,H,W) and the grid (B,H/16,W/16); rec and the grid stay in their
    own dtype where it is fp32 or bf16 (no copy), others become fp32."""
    imgs = torch.zeros((2, 32, 48))
    rec = torch.zeros((2, 32, 48), dtype=torch.bfloat16)
    act = torch.zeros((2, 2, 3))
    r, i, a, rb, ab = tpo._loss_operands(rec, imgs, act, 16)
    assert r.data_ptr() == rec.data_ptr() and (rb, ab) == (1, 0)
    _, _, a, _, ab = tpo._loss_operands(rec, imgs, act.bool(), 16)
    assert a.dtype == torch.float32 and ab == 0
    for bad in ((rec, imgs, act, 8), (rec[:, :16], imgs, act, 16),
                (rec, imgs, act[:, :1], 16),
                (rec[..., :40], imgs[..., :40], act, 16)):
        with pytest.raises(ValueError):
            tpo._loss_operands(*bad)
    offset = torch.zeros(2 * 32 * 48 + 1)[1:].reshape(2, 32, 48)
    assert offset.data_ptr() % 16 and tpo._aligned(offset).data_ptr() % 16 == 0
