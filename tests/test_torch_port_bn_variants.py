"""The BatchNorm moment variants (CMX_BN_VARIANT: shift_ra, shift_max,
two_pass, naive) of cmx_torch.models.blocks.MaskedBatchNorm against cmx's
on the CPU, with cmx.models.blocks.BN_VARIANT and the port's global patched
alike.

  * the module, unmasked, masked, and masked with every subsampled
    position (x[:, :, ::8, ::8]) inactive, in fp32 and bf16, on a
    large-mean input (|mean| / std = 100 in every channel, as
    tests/test_masked_bn.py builds it), where naive's E[x^2] - mean^2
    cancels. Each package's batch variance (read back from the running
    update) within the variant's envelope of the float64 two-pass
    variance of the same (rounded) input: ACCURATE = 1e-4 relative for
    shift_ra (running mean 3 sigma from the batch mean), shift_max and
    two_pass; CANCELS = 1e-1 for naive and for shift_max whose subsample is
    all masked (shift 0). The running mean within 1e-6 relative. fp32: the
    output and the input gradient within the envelope, relative to their
    largest entry (a variance off by e moves the output by e/2). bf16: the
    output within two bf16 ulps of the largest |shift| of the fold plus
    1e-2 of the largest output (the normalize is one bf16 multiply-add, and
    shift = bias - mean * inv, |mean * inv| = 100, has an ulp of 0.5: a
    last-bit change of the fp32 moments flips it), the input gradient
    within 1e-1 of its largest entry (the (C,)-sized folds' cotangents are
    bf16 sums of g * x, |x| = 100, in both packages, in another order);
  * an unknown variant runs naive, bit for bit, in the port as in cmx;
  * fp64 (fault F3): the port keeps fp64 and runs two_pass whatever the
    variant, as cmx under jax.enable_x64(True): the moments before
    their fp32 cast within 1e-12 relative of cmx's (read from cmx's jnp
    calls) at |mean| / std = 1e8, where naive would lose every digit;
  * the reduced-width fused bf16 SparK step (tests/test_torch_port_step.py's
    model at 32^2, down1 fused, FUSED_MIN_HW 32, cmx's mask injected) under
    shift_max and two_pass: the loss and every BN running statistic against
    cmx's loss_fn on the same weights, at that test's bf16 margins (2e-2,
    5e-2);
  * CMX_BN_VARIANT in the environment reaches the port's global;
  * data parallel: two gloo ranks (spawned once, `python
    tests/test_torch_port_bn_variants.py OUT`) run a masked
    MaskedBatchNorm and a reduced-width DoubleConv forward and backward
    under each variant, each on its half of the global batch, against this
    process on the whole batch: outputs, input gradients and the parameter
    gradients summed over the ranks within 1e-5 of their largest entry (the
    conv biases the norms absorb, whose true gradient is 0, within 1e-5 of
    the module's largest gradient entry), the running stats within 1e-5
    absolute (cmx's DP tolerance,
    tests/test_distributed_parity.py); the collectives a forward and
    backward makes per norm: two all-reduces (the moments' sums and their
    cotangents) for shift_ra and naive, plus one MAX all-reduce for
    shift_max, four for two_pass.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = ("shift_ra", "shift_max", "two_pass", "naive")
ACCURATE, CANCELS = 1e-4, 1e-1
MEANS = np.array([100.0, -100.0, 50.0])  # |mean| / std = 100 per channel
STDS = np.array([1.0, 1.0, 0.5])
THREADS = 2
WORLD = 2
DP_SHAPE = (4, 3, 16, 16)  # the global batch of the gloo cases (NCHW)
DC_WIDTHS = (3, 8)         # the DoubleConv's Cin and features


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def variant_in_both(monkeypatch):
    """set(v): cmx's and the port's BN_VARIANT to v for the test."""
    import cmx.models.blocks as cb

    import cmx_torch.models.blocks as tb

    def set_variant(v):
        monkeypatch.setattr(cb, "BN_VARIANT", v)
        monkeypatch.setattr(tb, "BN_VARIANT", v)

    return set_variant


def _large_mean(kind, seed=0):
    """(x (4, 16, 16, 3) NHWC fp32, mask (4, 16, 16, 1) or None)."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 16, 16, 3)) * STDS + MEANS).astype(np.float32)
    if kind == "unmasked":
        return x, None
    m = (rng.random((4, 16, 16, 1)) > 0.4).astype(np.float32)
    if kind == "masked_sub_empty":
        m[:, ::8, ::8] = 0.0
    return x, m


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-30)


def _cmx_bn(x, m, dtype, ra_mean):
    """cmx's MaskedBatchNorm(dtype) on x (cast to dtype): (output, its
    running stats after the update, the gradient of sum(out * g) by x, g)."""
    import jax
    import jax.numpy as jnp

    from cmx.models.blocks import MaskedBatchNorm

    bn = MaskedBatchNorm(dtype=dtype)
    xj = jnp.asarray(x).astype(dtype)
    v = jax.tree.map(lambda a: np.asarray(a, np.float32),
                     bn.init(jax.random.key(0), xj, m))
    v["batch_stats"]["mean"] = ra_mean
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def f(xx):
        out, mut = bn.apply(v, xx, m, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * g), (out, mut)

    (_, (out, mut)), gx = jax.value_and_grad(f, has_aux=True)(xj)
    return (np.asarray(out.astype(jnp.float32)), mut["batch_stats"],
            np.asarray(gx.astype(jnp.float32)), g, v)


def _port_bn(x, m, dtype, v, g):
    from cmx_torch.ckpt.checkpoint import from_flax
    from cmx_torch.models.blocks import MaskedBatchNorm

    bn = from_flax(MaskedBatchNorm(x.shape[-1], dtype), v).train()
    xt = _nchw(x).to(dtype).requires_grad_()
    out = bn(xt, None if m is None else _nchw(m))
    (out.float() * _nchw(g)).sum().backward()
    return (out.detach().float().numpy().transpose(0, 2, 3, 1), bn,
            xt.grad.float().numpy().transpose(0, 2, 3, 1))


def _batch_var(running_var):
    """The batch variance an update from a running var of 1 folded in."""
    return (np.asarray(running_var, np.float64) - 0.9) / 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["unmasked", "masked", "masked_sub_empty"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_masked_batch_norm_variant_matches_cmx(variant_in_both, variant,
                                               kind, dtype):
    import jax.numpy as jnp

    variant_in_both(variant)
    x, m = _large_mean(kind)
    ra_mean = (MEANS + 3 * STDS).astype(np.float32)  # 3 sigma of lag
    out, stats, gx, g, v = _cmx_bn(x, m, jnp.dtype(dtype), ra_mean)
    tout, tbn, tgx = _port_bn(x, m, getattr(torch, dtype), v, g)

    cancels = variant == "naive" or (variant == "shift_max"
                                     and kind == "masked_sub_empty")
    env = CANCELS if cancels else ACCURATE
    # the float64 two-pass moments of the input as both packages read it
    xr = np.asarray(jnp.asarray(x).astype(jnp.dtype(dtype))
                    .astype(jnp.float32), np.float64)
    mm = np.ones(x.shape[:3] + (1,)) if m is None else m.astype(np.float64)
    n = mm.sum((0, 1, 2))
    mean = (xr * mm).sum((0, 1, 2)) / n
    var = (((xr - mean) ** 2) * mm).sum((0, 1, 2)) / n
    for name, got in (("cmx", _batch_var(stats["var"])),
                      ("port", _batch_var(tbn.var.numpy()))):
        assert np.max(np.abs(got - var) / var) <= env, name
    np.testing.assert_allclose(tbn.mean.numpy(), stats["mean"], rtol=1e-6)
    if dtype == "float32":
        assert _rel(tout, out) <= env
        assert _rel(tgx, gx) <= env
    else:
        inv = 1.0 / np.sqrt(var + 1e-5)
        ulp = 2.0 ** (np.floor(np.log2(np.max(np.abs(mean * inv)))) - 7)
        assert np.max(np.abs(tout - out)) <= 2 * ulp + 1e-2 * np.max(
            np.abs(out))
        assert _rel(tgx, gx) <= 1e-1


def test_unknown_variant_runs_naive(variant_in_both):
    """Any value but the three named ones is naive, as cmx's `else`."""
    import jax.numpy as jnp

    x, m = _large_mean("masked")
    ra = np.zeros(3, np.float32)
    got = {}
    for v in ("naive", "shift-ra"):
        variant_in_both(v)
        out, stats, _, g, params = _cmx_bn(x, m, jnp.float32, ra)
        tout, tbn, tgx = _port_bn(x, m, torch.float32, params, g)
        got[v] = (out, np.asarray(stats["var"]), tout, tbn.var.numpy(), tgx)
    for a, b in zip(got["naive"], got["shift-ra"]):
        assert np.array_equal(a, b)


class _Recorder:
    """cmx.models.blocks' `jnp`, recording the moments cmx computes before
    their fp32 cast: jnp.mean's and jnp.sum's results, the denominator
    (jnp.maximum(., 1.0)) and the variance (jnp.maximum(., 0.0))."""

    def __init__(self, jnp):
        self._jnp, self.means, self.sums, self.max = jnp, [], [], {}

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def mean(self, *a, **k):
        self.means.append(self._jnp.mean(*a, **k))
        return self.means[-1]

    def sum(self, *a, **k):
        self.sums.append(self._jnp.sum(*a, **k))
        return self.sums[-1]

    def maximum(self, a, b):
        self.max[b] = a
        return self._jnp.maximum(a, b)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_fp64_runs_two_pass_in_fp64_as_cmx(variant_in_both, monkeypatch,
                                           masked):
    import jax
    import jax.numpy as jnp

    import cmx.models.blocks as cb
    from cmx_torch.ckpt.checkpoint import from_flax
    from cmx_torch.models.blocks import MaskedBatchNorm

    variant_in_both("naive")  # fp64 ignores the variant in both
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 16, 3)) + 1e8
    m = (rng.random((2, 16, 16, 1)) > 0.4).astype(np.float64) \
        if masked else None
    rec = _Recorder(jnp)
    monkeypatch.setattr(cb, "jnp", rec)
    with jax.enable_x64(True):
        bn = cb.MaskedBatchNorm()
        v = bn.init(jax.random.key(0), jnp.asarray(x), m)
        rec.means.clear(), rec.sums.clear(), rec.max.clear()
        out, mut = bn.apply(v, jnp.asarray(x), m, mutable=["batch_stats"])
        assert out.dtype == jnp.float64
        if masked:
            cmean = np.asarray(rec.sums[1] / rec.max[1.0])
        else:
            cmean = np.asarray(rec.means[0])
        cvar = np.asarray(rec.max[0.0])
        v = jax.tree.map(np.asarray, v)
    tbn = from_flax(MaskedBatchNorm(3), v).train()
    xt = _nchw(x)
    mt = None if m is None else _nchw(m)
    tmean, tvar, _ = tbn.moments(xt, mt)
    assert tmean.dtype == tvar.dtype == torch.float64
    assert _rel(tmean.numpy(), cmean) <= 1e-12
    assert _rel(tvar.numpy(), cvar) <= 1e-12
    mm = np.ones(x.shape[:3] + (1,)) if m is None else m
    true = (((x - cmean) ** 2) * mm).sum((0, 1, 2)) / mm.sum((0, 1, 2))
    assert _rel(tvar.numpy(), true) <= 1e-12
    tout = tbn(xt, mt)
    assert tout.dtype == torch.float64
    np.testing.assert_array_equal(tbn.mean.numpy(), mut["batch_stats"]["mean"])
    np.testing.assert_array_equal(tbn.var.numpy(), mut["batch_stats"]["var"])
    assert _rel(tout.detach().numpy().transpose(0, 2, 3, 1), out) <= 1e-12


@pytest.fixture(scope="module")
def step_setup():
    """Weights and images of the reduced SparK step, and cmx's mask."""
    import jax

    from cmx.ops.masking import spark_active_mask
    from cmx.ssl.spark import SparKModel as JSparK

    size, b = 32, 2
    imgs = np.random.default_rng(0).normal(size=(b, size, size)).astype(
        np.float32)
    jm = JSparK(widths=(8, 16, 32, 64), bottleneck_width=128,
                dtype=jax.numpy.bfloat16, fused=True)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), imgs[:1],
                            np.ones((1, size // 16, size // 16), np.float32))
    rng = np.random.default_rng(1)

    def fill(path, sd):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name or "'var'" in name:
            return np.ones(sd.shape, np.float32)
        if "bias" in name or "'mean'" in name or "token" in name:
            return (rng.normal(size=sd.shape) * 0.1).astype(np.float32)
        fan = int(np.prod(sd.shape[:-1])) if len(sd.shape) > 1 else 1
        return (rng.normal(size=sd.shape) / np.sqrt(fan)).astype(np.float32)

    v = jax.tree_util.tree_map_with_path(fill, shapes)
    key = jax.random.key(7)
    km, _ = jax.random.split(jax.random.fold_in(key, 0))
    active = np.array(spark_active_mask(km, b, size // 16, 0.6))
    return jm, v, imgs, key, active


@pytest.mark.parametrize("variant", ["shift_max", "two_pass"])
def test_fused_spark_step_matches_cmx(variant_in_both, monkeypatch,
                                      step_setup, variant):
    import jax
    import jax.numpy as jnp

    from cmx.ops import fused_conv as cfc
    from cmx.ssl.spark import make_spark_task as jtask
    from cmx_torch.ckpt.checkpoint import from_flax
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ops import fused_conv_flat as tff
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step

    variant_in_both(variant)
    monkeypatch.setattr(cfc, "FUSED_MIN_HW", 32)
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)
    jm, v, imgs, key, active = step_setup
    jt, _ = jtask(jm, input_size=32, pallas_loss=False, augment=False)
    state = type("S", (), {"batch_stats": v["batch_stats"]})
    jl, jaux = jax.jit(lambda p: jt.loss_fn(
        p, state, jnp.asarray(imgs), jax.random.fold_in(key, 0)))(v["params"])

    tm = from_flax(SparKModel(widths=(8, 16, 32, 64), bottleneck_width=128,
                              dtype=torch.bfloat16, fused=True), v)
    task, _ = make_spark_task(tm, input_size=32, pallas_loss=False,
                              augment=False)
    tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                        named_params=tm.named_parameters())
    st = TrainState.create(model=tm, tx=tx)
    calls = []
    orig = tff.flat_double_conv
    monkeypatch.setattr(tff, "flat_double_conv",
                        lambda *a: (calls.append(a[0].shape), orig(*a))[1])
    met = make_train_step(task, tx)(st, torch.from_numpy(imgs),
                                    {"active": torch.from_numpy(active)})
    assert [tuple(s) for s in calls] == [(2, 1, 32 * 32)]  # down1 fused
    tl = float(met["loss"])
    assert np.isfinite(tl) and float(met["nonfinite"]) == 0.0
    assert abs(tl - float(jl)) <= 2e-2 * abs(float(jl))
    for name, b in tm.named_buffers():
        ref = jaux.batch_stats
        for k in name.split("."):
            ref = ref[k]
        assert float(np.max(np.abs(b.numpy() - np.asarray(ref)))) < 5e-2, name


def test_the_environment_sets_the_variant():
    out = subprocess.run(
        [sys.executable, "-c", "import cmx_torch.models.blocks as b; "
         "print(b.BN_VARIANT)"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CMX_BN_VARIANT="two_pass", PYTHONPATH=str(ROOT)),
        timeout=120, check=True)
    assert out.stdout.strip() == "two_pass"


# ------------------------------------------------------ data parallel
# (run in every process: torch only)


def _dp_inputs():
    """The global batch: x, mask, the output cotangent (NCHW, fp32)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=DP_SHAPE) * 2.0 + 5.0
    m = rng.random((DP_SHAPE[0], 1) + DP_SHAPE[2:]) > 0.4
    g = rng.normal(size=(DP_SHAPE[0], DC_WIDTHS[1]) + DP_SHAPE[2:])
    return (torch.from_numpy(x).float(), torch.from_numpy(m).float(),
            torch.from_numpy(g).float())


def run_dp_cases():
    """Every variant's MaskedBatchNorm and DoubleConv forward and backward
    on this rank's rows of the global batch: {variant: {name: array}} and
    the collectives each made."""
    from cmx_torch.models import blocks
    from cmx_torch.parallel import mesh

    x, m, g = (mesh.rank_slice(t) for t in _dp_inputs())
    out = {}
    for variant in VARIANTS:
        blocks.BN_VARIANT = variant
        res = {}
        for name in ("bn", "dc"):
            torch.manual_seed(0)
            if name == "bn":
                mod = blocks.MaskedBatchNorm(DP_SHAPE[1], torch.float32)
                with torch.no_grad():
                    mod.mean.fill_(4.0)
                    mod.scale.uniform_(0.5, 1.5)
                gg = g[:, :DP_SHAPE[1]]
            else:
                mod = blocks.DoubleConv(*DC_WIDTHS, torch.float32)
                mod.conv0.reset_parameters(torch.Generator().manual_seed(1))
                mod.conv1.reset_parameters(torch.Generator().manual_seed(2))
                gg = g
            mod.train()
            xi = (x * m).requires_grad_()
            mesh.reset_counts()
            y = mod(xi, m)
            (y * gg).sum().backward()
            res[f"{name}/counts"] = dict(mesh.counts)
            res[f"{name}/out"] = y.detach().numpy()
            res[f"{name}/dx"] = xi.grad.numpy()
            for n, p in mod.named_parameters():
                res[f"{name}/grad/{n}"] = p.grad.numpy()
            for n, b in mod.named_buffers():
                res[f"{name}/buf/{n}"] = b.numpy()
        out[variant] = res
    blocks.BN_VARIANT = "shift_ra"
    return out


def _dp_worker(out_path):
    torch.set_num_threads(THREADS)
    sys.path.insert(0, str(ROOT))
    from cmx_torch.parallel import dist

    dist.initialize_distributed("cpu")
    rank, _ = dist.process_info()
    res = run_dp_cases()
    arrays = {f"{v}/{k}": a for v, r in res.items() for k, a in r.items()
              if not k.endswith("/counts")}
    np.savez(f"{out_path}.{rank}.npz", **arrays)
    Path(f"{out_path}.{rank}.json").write_text(json.dumps(
        {v: {k: c for k, c in r.items() if k.endswith("/counts")}
         for v, r in res.items()}))
    dist.shutdown()


if __name__ == "__main__":
    _dp_worker(sys.argv[1])
    sys.exit(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(the ranks' results, their collective counts, this process's)."""
    tmp = tmp_path_factory.mktemp("bn_dp")
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    procs = []
    for rank in range(WORLD):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp / "out")],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    one = run_dp_cases()  # meanwhile, the whole batch in this process
    bad = []
    for p, log in procs:
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode:
            bad.append(Path(log.name).read_text()[-4000:])
    assert not bad, "a rank failed:\n" + "\n---\n".join(bad)
    ranks, counts = [], []
    for r in range(WORLD):
        with np.load(tmp / f"out.{r}.npz") as f:
            ranks.append({k: f[k] for k in f.files})
        counts.append(json.loads((tmp / f"out.{r}.json").read_text()))
    return ranks, counts, one


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_ranks_equal_one_process(dp_runs, variant):
    ranks, _, one = dp_runs
    ref = one[variant]
    for name in ("bn", "dc"):
        for part in ("out", "dx"):
            got = np.concatenate([r[f"{variant}/{name}/{part}"]
                                  for r in ranks])
            assert _rel(got, ref[f"{name}/{part}"]) <= 1e-5, (name, part)
        grads = {k: v for k, v in ref.items()
                 if k.startswith(f"{name}/grad/")}
        scale = max(float(np.max(np.abs(v))) for v in grads.values())
        for k, want in grads.items():
            got = sum(r[f"{variant}/{k}"] for r in ranks)
            # a conv bias that a BN absorbs has the true gradient 0
            bound = scale if k.endswith("conv0.bias") or k.endswith(
                "conv1.bias") else float(np.max(np.abs(want)))
            assert np.max(np.abs(got - want)) <= 1e-5 * bound, k
        for k, want in ref.items():
            if k.startswith(f"{name}/buf/"):
                for r in ranks:
                    np.testing.assert_allclose(r[f"{variant}/{k}"], want,
                                               rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_collectives_are_counted(dp_runs, variant):
    _, counts, one = dp_runs
    per_norm = {"shift_ra": {"all_reduce": 2}, "naive": {"all_reduce": 2},
                "shift_max": {"all_reduce": 2, "all_reduce_max": 1},
                "two_pass": {"all_reduce": 4}}[variant]
    for name, norms in (("bn", 1), ("dc", 2)):
        assert one[variant][f"{name}/counts"] == {}  # no group here
        for c in counts:
            calls = {k: v for k, v in c[variant][f"{name}/counts"].items()
                     if not k.endswith("_bytes")}
            assert calls == {k: norms * v for k, v in per_norm.items()}, name
