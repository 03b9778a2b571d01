"""The fine-tune harness and CLI under data parallel on the CPU: two gloo
ranks against cmx's data-parallel fit and against one process.

cmx's fit is data parallel inside one process (its tests run on 8 virtual
CPU devices): `_fit_scan` trains on the gcd submesh (batch 4: 4 devices),
the host loop on the whole mesh (batch 8: 8 devices). The port runs a rank
a device (cmx_torch.parallel.mesh): `fit` trains the first gcd(batch, W)
ranks of a gloo group, each on its rows of every chunk. Every case runs in
two processes spawned once for the module (`python
tests/test_torch_port_dp_finetune.py INPUTS OUT`, torch only), while the
test process runs the same cases without a group and cmx's fits.

Reduced widths (8, 16, 32, 64), bottleneck 128, 32^2, fp32 unless a case
says otherwise. Tolerances: against cmx, test_torch_port_finetune's
`_assert_logs_close`; between the ranks and one process, cmx's DP
tolerances (tests/test_distributed_parity.py: losses rtol 1e-5, parameters
atol 2e-5, BN running stats atol 1e-5). Those hold for SGD, not for fit's
Adam: Adam's update is about lr * sign(grad), so gradients whose true value
is 0 (the conv biases a BN absorbs) move by +-lr with signs that follow the
summation order (cmx's DP test steps SGD for the same reason). The cases
held to one process therefore swap fit's optimizer for SGD momentum 0.9 in
both (`_sgd`). The grad norm is held at _assert_logs_close's 1e-2: a
max-pool window whose two largest values differ by rounding routes the
gradient to the other pixel, which moves the norm (9e-4 at one step of the
scan case) and not the loss.

Cases:
  scan (i): the default path at batch 4 with cmx's permutations injected
    (k = 2: 2 rows a rank), against cmx's fit on its 4-device submesh
    (Adam) and against one process (SGD);
  host (ii): the host loop (host_metrics_every=1) at batch 8, against
    cmx's 8-device host loop (Adam) and one process (SGD);
  gcd (iii): batch 3 over 2 ranks: k = 1, rank 1 takes no step, and both
    return the one-process fit bit for bit (Adam);
  fused (iv): the UNet with fused=True through FlatDoubleConv (down1 and
    up1 at 32^2, FUSED_MIN_HW 32), the plain K1/K2 computing in fp32
    (COMPUTE_DTYPE and the bf16 gate patched as test_torch_port_dp.py's
    spark_flat case), SGD, against one process; the K1/K2 sums counted in
    the group of 2;
  cli (v): `cmx_torch.cli.finetune --device cpu` from the launcher's
    variables in both ranks (SGD): rank 0 alone writes the pickle and the
    json, whose metrics are the one-process CLI's within the DP tolerances;
  trainer (vi): `Trainer.prepare_state` and `run_step` on the global batch
    against cmx's Trainer on its 8-device mesh (SGD);
  scopes (vii): `mesh.local`, `mesh.sub_group(1)` (rank 1 outside: its
    collectives raise) and a backward run after its scope has exited, which
    sums in the scope of its forward (a `_SyncSum` and FlatDoubleConv's
    K2 sums); a host-loop batch that does not split over the ranks raises.
"""

import contextlib
import functools
import hashlib
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (8, 16, 32, 64)
BNECK = 128
THREADS = 2  # every process's intra-op threads (bit for bit across them)
WORLD = 2
SGD_LR = 1e-2
# cmx's DP tolerances (tests/test_distributed_parity.py)
LOSS_RTOL, PARAM_ATOL, BN_ATOL = 1e-5, 2e-5, 1e-5
GRAD_NORM_RTOL = 1e-2  # _assert_logs_close's (see the module docstring)
# (n_train, n_valid, data seed) and fit's arguments of each case
FITS = {
    "scan": ((6, 5, 10), dict(lr=1e-3, epochs=3, batch=4, seed=5)),
    "host": ((10, 4, 9), dict(lr=1e-3, epochs=2, batch=8, seed=3,
                              host_metrics_every=1)),
    "gcd": ((5, 3, 11), dict(lr=1e-3, epochs=2, batch=3, seed=7)),
    "fused": ((4, 2, 12), dict(lr=1e-3, epochs=2, batch=4, seed=2)),
}
# (options before the overrides: --batches would take them)
CLI_OPTIONS = ["--device", "cpu", "--lrs", "1e-3", "--epochs", "1",
               "--batches", "8"]
CLI_OVERRIDES = ["data.synthetic=True", "data.synthetic_n=12",
                 "data.image_size=32", "data.ratio=0.3",
                 "model.dtype=float32"]
TRAINER_BATCH = 8


# ---------------------------------------------------------------- the cases
# (run in every process: torch only)


def _unet(fused=False, seed=0):
    from cmx_torch.models.unet import UNet

    model = UNet(2, WIDTHS, BNECK, dtype=torch.float32, fused=fused)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model


def _sgd(named, lr):
    from cmx_torch.train.optim import Sgd

    return Sgd(named, SGD_LR, momentum=0.9)


@contextlib.contextmanager
def _patched(obj, **attrs):
    saved = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(obj, k, v)


@contextlib.contextmanager
def _fused_fp32():
    """The fused gate at 32^2 and the flat kernels' plain versions
    computing in fp32 behind a gate that takes an fp32 model."""
    from cmx_torch.models import blocks
    from cmx_torch.ops import fused_conv as fc

    def use_fused(self, x):
        _, cin, h, w = x.shape
        return (self.fused and self.training and h >= fc.FUSED_MIN_HW
                and h % fc.STRIP == 0 and w % 8 == 0
                and cin <= fc.FUSED_MAX_CIN)

    with _patched(fc, FUSED_MIN_HW=32, COMPUTE_DTYPE=torch.float32), \
            _patched(blocks.DoubleConv, use_fused=use_fused):
        yield


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _state_tensors(state):
    opt = [t for v in state.opt.state_dict().values()
           for t in (v if isinstance(v, list) else [v])]
    return list(state.model.state_dict().values()) + opt


def _summary(res):
    """A FitResult as JSON, and its model's tensors."""
    return ({"train": res.train_logs, "valid": res.valid_logs,
             "best_epoch": res.best_epoch, "step": res.state.step,
             "digest": _digest(_state_tensors(res.state))},
            {k: v.numpy() for k, v in res.state.model.state_dict().items()})


def run_fit(case, inputs, sgd):
    """`case`'s fit in this process (a rank of the group, or alone)."""
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.parallel import mesh
    from cmx_torch.train import harness

    (_, _, _), kw = FITS[case]
    data = [inputs[f"{case}/{k}"] for k in ("xtr", "ytr", "xva", "yva")]
    perms = ([inputs[f"{case}/perm{e}"] for e in range(kw["epochs"])]
             if f"{case}/perm0" in inputs else None)
    calls, sums = {"k1": 0, "k2": 0}, []

    def counted(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    def spy_many(*ts):
        sums.append(mesh.info()[1])
        return many(*ts)

    many = mesh.all_reduce_sum_many
    with contextlib.ExitStack() as stack:
        if sgd:
            stack.enter_context(_patched(harness, Adam=_sgd))
        if case == "fused":
            stack.enter_context(_fused_fp32())
            stack.enter_context(_patched(
                ff, flat_conv3x3_mask_stats=counted(
                    "k1", ff.flat_conv3x3_mask_stats),
                flat_bwd_mega=counted("k2", ff.flat_bwd_mega)))
            stack.enter_context(_patched(mesh, all_reduce_sum_many=spy_many))
        mesh.reset_counts()
        res = harness.fit(*data, model=_unet(fused=case == "fused"),
                          augment=False, device="cpu", perms=perms, **kw)
        summary, values = _summary(res)
    summary["counts"] = dict(mesh.counts)
    summary["calls"], summary["sum_groups"] = calls, sums
    return summary, values


def run_trainer(inputs):
    """`Trainer` on the global batch: rank r builds its model from seed r,
    `prepare_state` makes it rank 0's, one SGD step."""
    from cmx_torch.parallel import mesh
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.supervised import make_supervised_task
    from cmx_torch.train.trainer import Trainer

    model = _unet(seed=mesh.info()[0])
    task, _ = make_supervised_task(model, augment=False)
    tx = make_optimizer("sgd", SGD_LR, 0.0, momentum=0.9,
                        named_params=model.named_parameters())
    trainer = Trainer(task, tx)
    state = trainer.prepare_state(TrainState.create(model=model, tx=tx,
                                                    seed=3))
    batch = (torch.from_numpy(inputs["trainer/x"]),
             torch.from_numpy(inputs["trainer/y"]))
    m = trainer.run_step(state, batch)
    return ({"metrics": {k: float(v) for k, v in m.items()},
             "digest": _digest(_state_tensors(state))},
            {k: v.numpy() for k, v in model.state_dict().items()})


def run_scopes(inputs):
    """The scopes inside a group of 2 (see the module docstring)."""
    from cmx_torch.ops import fused_conv_flat as ff
    from cmx_torch.parallel import mesh
    from cmx_torch.train.harness import fit

    out = {}
    x = torch.ones(3)
    mesh.reset_counts()
    with mesh.local():
        out["local_info"] = mesh.info()
        mesh.all_reduce_sum(x)
    out["local_sum"], out["local_counts"] = x.tolist(), dict(mesh.counts)
    seen = []
    orig = mesh.all_reduce_sum

    def spy(t, op="all_reduce"):
        seen.append(mesh.info())
        return orig(t, op)

    g = torch.Generator().manual_seed(0)
    a = torch.ones(3, requires_grad=True)
    xf = torch.randn((2, 8, 64), generator=g).requires_grad_(True)
    mflat = torch.ones((2, 1, 64))
    w = [torch.randn((3, 3, 8, 8), generator=g).requires_grad_(True)
         for _ in range(2)]
    vec = [torch.randn(8, generator=g).requires_grad_(True)
           for _ in range(6)]
    with _patched(mesh, all_reduce_sum=spy):
        with mesh.sub_group(1) as member:
            out["member"] = member
            if member:
                out["sub_info"] = mesh.info()
                y = mesh.all_reduce_sync(a * 2.0)
                h, _ = ff.flat_double_conv(xf, mflat, w[0], vec[0], vec[1],
                                           vec[2], w[1], vec[3], vec[4],
                                           vec[5], 8, 8)
            else:
                try:
                    mesh.all_reduce_sum(torch.ones(1))
                    out["outside"] = "no error"
                except RuntimeError as e:
                    out["outside"] = str(e)
        if member:  # the backward after the scope has exited
            seen.clear()
            (y.sum() + h.float().sum()).backward()
            out["backward_infos"] = seen[:]
            out["sync_grad"] = a.grad.tolist()
        # the same in the world group: the cotangents of both ranks
        b = torch.ones(3, requires_grad=True)
        seen.clear()
        mesh.all_reduce_sync(b * 2.0).sum().backward()
        out["world_infos"], out["world_grad"] = seen[:], b.grad.tolist()
    try:  # a host-loop chunk of 3 rows over 2 ranks
        fit(*(inputs[f"gcd/{k}"] for k in ("xtr", "ytr", "xva", "yva")),
            model=_unet(), epochs=1, batch=3, host_metrics_every=1,
            augment=False, device="cpu")
        out["split"] = "no error"
    except ValueError as e:
        out["split"] = str(e)
    return out


def run_cli(out_dir, data_dir):
    """The finetune CLI (SGD, reduced widths) as a user runs it; returns
    the basenames of the files this process wrote."""
    import cmx_torch.models.unet as unet
    from cmx_torch.cli.finetune import main
    from cmx_torch.train import harness

    written = []

    def record(fn):
        @functools.wraps(fn)
        def wrapper(obj, f, *a, **k):
            written.append(os.path.basename(f.name))
            return fn(obj, f, *a, **k)
        return wrapper

    with _patched(unet, UNet=functools.partial(unet.UNet, widths=WIDTHS,
                                               bottleneck=BNECK)), \
            _patched(harness, Adam=_sgd), \
            _patched(pickle, dump=record(pickle.dump)), \
            _patched(json, dump=record(json.dump)):
        res = main(CLI_OPTIONS + ["--out", str(out_dir)] + CLI_OVERRIDES
                   + [f"data.data_dir={data_dir}"])
    return {"written": written, "test_metrics": res["test_metrics"],
            "digest": _digest(_state_tensors(res["state"])),
            "tag": res["tag"]}


def run_all(inputs, tmp):
    """Every case in this process: ({case: JSON}, {name: array})."""
    out, values = {}, {}
    for case, sgd in (("scan", False), ("scan", True), ("host", False),
                      ("host", True), ("gcd", False), ("fused", True)):
        name = f"{case}_sgd" if sgd else case
        out[name], vals = run_fit(case, inputs, sgd)
        values.update({f"{name}/{k}": v for k, v in vals.items()})
    out["trainer"], vals = run_trainer(inputs)
    values.update({f"trainer/{k}": v for k, v in vals.items()})
    out["cli"] = run_cli(tmp / "cli_out", tmp / "cli_data")
    return out, values


def _worker(inputs_path, out_path):
    """One rank: the group from the launcher's environment (gloo), every
    case, results to OUT.<rank>.json and .npz."""
    torch.set_num_threads(THREADS)
    sys.path.insert(0, str(ROOT))
    from cmx_torch.parallel import dist

    dist.initialize_distributed("cpu")
    rank = dist.process_info()[0]
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    out, values = run_all(inputs, Path(out_path).parent)
    out["scopes"] = run_scopes(inputs)
    Path(f"{out_path}.{rank}.json").write_text(json.dumps(out))
    np.savez(f"{out_path}.{rank}.npz", **values)
    dist.shutdown()


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
    sys.exit(0)


# ------------------------------------------------------------- the test side


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs():
    """Every case's arrays (numpy, cmx's layouts) and cmx's permutations
    of the scan case (jax.random.permutation of fold_in(key(seed ^
    0x5EED), epoch), as cmx's _fit_scan draws them)."""
    import jax

    from test_torch_port_finetune import _fit_data

    out = {}
    for case, ((n_tr, n_va, s), kw) in FITS.items():
        for k, v in zip(("xtr", "ytr", "xva", "yva"),
                        _fit_data(n_tr, n_va, 32, s)):
            out[f"{case}/{k}"] = v
    (n_tr, _, _), kw = FITS["scan"]
    base = jax.random.key(np.uint32(kw["seed"]) ^ np.uint32(0x5EED))
    for ep in range(kw["epochs"]):
        out[f"scan/perm{ep}"] = np.asarray(jax.random.permutation(
            jax.random.fold_in(base, ep), n_tr))
    x, y, _, _ = _fit_data(TRAINER_BATCH, 0, 32, 13)
    out["trainer/x"] = x
    out["trainer/y"] = np.ascontiguousarray(y.transpose(0, 3, 1, 2))
    return out


def _cmx_fits(inputs):
    """cmx's fits of the scan and host cases (Adam, its data-parallel
    paths on the test session's 8 CPU devices) from the port's weights."""
    from cmx.train.harness import fit as jfit
    from cmx_torch.ckpt.checkpoint import to_flax
    from test_torch_port_finetune import SmallUNet

    v = to_flax(_unet())
    out = {}
    for case in ("scan", "host"):
        _, kw = FITS[case]
        data = [inputs[f"{case}/{k}"] for k in ("xtr", "ytr", "xva", "yva")]
        out[case] = jfit(*data, model=SmallUNet(), augment=False,
                         init_variables=v, **kw)
    return out


def _cmx_trainer(inputs):
    """cmx's Trainer on its mesh (the 8 devices) at the global batch, one
    SGD step from the port's seed-0 weights: (metrics, state)."""
    import jax
    import jax.numpy as jnp

    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.state import TrainState as JState
    from cmx.train.supervised import make_supervised_task
    from cmx.train.trainer import Trainer as JTrainer
    from cmx_torch.ckpt.checkpoint import to_flax
    from test_torch_port_finetune import SmallUNet

    v = jax.tree.map(np.asarray, to_flax(_unet()))
    jt, _ = make_supervised_task(SmallUNet(dtype=jnp.float32), augment=False)
    jtx = jopt("sgd", SGD_LR, 0.0, momentum=0.9, params_example=v["params"])
    trainer = JTrainer(jt, jtx)
    assert trainer.mesh.devices.size == 8
    state = trainer.prepare_state(JState.create(
        params=v["params"], batch_stats=v["batch_stats"], tx=jtx,
        rng=jax.random.key(7)))
    batch = (jnp.asarray(inputs["trainer/x"]),
             jnp.asarray(inputs["trainer/y"].transpose(0, 2, 3, 1)))
    state, m = trainer.run_step(state, batch)
    return {k: float(x) for k, x in m.items()}, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [rank 0's and rank 1's (JSON, arrays)], "one": the cases
    without a group, "cmx": cmx's scan and host fits, "cmx_trainer",
    "tmp": the directory}."""
    tmp = tmp_path_factory.mktemp("dp_ft")
    inputs = _inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    procs = []
    for rank in range(WORLD):
        (tmp / "ranks").mkdir(exist_ok=True)
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp / "inputs.npz"),
             str(tmp / "ranks" / "out")],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(THREADS)
        try:
            (tmp / "one").mkdir()
            one = run_all(inputs, tmp / "one")
        finally:
            torch.set_num_threads(threads)
        ref = _cmx_fits(inputs)
        ref_trainer = _cmx_trainer(inputs)
    finally:
        bad = []
        for p, log in procs:
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            log.close()
            if p.returncode != 0:
                bad.append(Path(log.name).read_text()[-4000:])
    assert not bad, "a rank failed:\n" + "\n---\n".join(bad)
    ranks = []
    for rank in range(WORLD):
        with np.load(tmp / "ranks" / f"out.{rank}.npz") as f:
            ranks.append((json.loads(
                (tmp / "ranks" / f"out.{rank}.json").read_text()),
                {k: f[k] for k in f.files}))
    return {"ranks": ranks, "one": one, "cmx": ref,
            "cmx_trainer": ref_trainer, "tmp": tmp}


# ------------------------------------------------------------------- tests


def _bn(name):
    return name.endswith((".mean", ".var"))


def _assert_logs_within_dp(ours, ref):
    """Every log of `ours` against `ref`: the losses and metrics at rtol
    LOSS_RTOL, the grad norm at GRAD_NORM_RTOL."""
    assert sorted(ours) == sorted(ref)
    for k in ref:
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else LOSS_RTOL
        np.testing.assert_allclose(ours[k], ref[k], rtol=rtol, atol=1e-7,
                                   err_msg=k)


def _assert_values_within_dp(ours, ref, prefix):
    names = [k for k in ref if k.startswith(prefix + "/")]
    assert names
    for k in names:
        np.testing.assert_allclose(ours[k], ref[k],
                                   atol=BN_ATOL if _bn(k) else PARAM_ATOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["scan", "host"])
def test_two_ranks_match_cmx_data_parallel_fit(runs, case):
    """Two ranks (Adam) against cmx's fit on its devices: the scan path at
    batch 4 on cmx's 4-device gcd submesh with cmx's permutations, the host
    loop at batch 8 on its 8-device mesh: logs within
    _assert_logs_close's bounds, the best epoch equal."""
    from test_torch_port_finetune import _assert_logs_close

    ref = runs["cmx"][case]
    got = runs["ranks"][0][0][case]
    _assert_logs_close(got["train"], ref.train_logs)
    _assert_logs_close(got["valid"], ref.valid_logs)
    assert got["best_epoch"] == ref.best_epoch
    if case == "host":
        assert len(got["valid"]["hausdorff"]) == FITS["host"][1]["epochs"]


@pytest.mark.parametrize("case", ["scan_sgd", "host_sgd", "fused_sgd"])
def test_two_ranks_equal_one_process(runs, case):
    """Two ranks against one process, both with SGD: every train and
    validation log, and the returned model's parameters and BN running
    stats, within cmx's DP tolerances; the same best epoch and step."""
    (r0, v0), one = runs["ranks"][0], runs["one"]
    got, ref = r0[case], one[0][case]
    _assert_logs_within_dp(got["train"], ref["train"])
    _assert_logs_within_dp(got["valid"], ref["valid"])
    assert (got["best_epoch"], got["step"]) == (ref["best_epoch"],
                                                ref["step"])
    _assert_values_within_dp(v0, one[1], case)


@pytest.mark.parametrize("case", ["scan", "scan_sgd", "host", "host_sgd",
                                  "gcd", "fused_sgd", "trainer", "cli"])
def test_ranks_return_the_same_state_bit_for_bit(runs, case):
    """Every rank returns rank 0's state (parameters, BN buffers, optimizer
    state) bit for bit, and the same logs."""
    a, b = (runs["ranks"][r][0][case] for r in range(WORLD))
    assert a["digest"] == b["digest"]
    for k in ("train", "valid", "best_epoch", "step", "metrics"):
        assert a.get(k) == b.get(k), k


def test_gcd_fit_trains_on_rank_zero_alone(runs):
    """Batch 3 over 2 ranks: k = gcd(3, 2) = 1. Rank 0 steps in a group of
    one (every collective the identity), rank 1 takes no step and no
    collective of the fit's group, and both return the one-process fit bit
    for bit: state, logs, best epoch."""
    (n_tr, _, _), kw = FITS["gcd"]
    steps = kw["epochs"] * -(-n_tr // kw["batch"])
    r0, r1 = (runs["ranks"][r][0]["gcd"] for r in range(WORLD))
    one = runs["one"][0]["gcd"]
    assert r0["counts"]["grad_all_reduce"] == steps
    assert r1["counts"].get("grad_all_reduce", 0) == 0
    assert r1["counts"].get("all_reduce", 0) == 0
    assert not one["counts"]  # no group, no collective
    for r in (r0, r1):
        assert r["digest"] == one["digest"]
        assert (r["train"], r["valid"], r["best_epoch"], r["step"]) == (
            one["train"], one["valid"], one["best_epoch"], one["step"])


def test_fused_fit_sums_run_in_the_sub_group(runs):
    """The fused fit: each step calls K1 4 and K2 4 times (down1 and up1,
    two stages each); each call's sums are one all-reduce in the group of
    2, counted in mesh.counts beside one gradient all-reduce a step. One
    process makes the same calls and no collective."""
    (n_tr, _, _), kw = FITS["fused"]
    steps = kw["epochs"] * -(-n_tr // kw["batch"])
    for rank in range(WORLD):
        got = runs["ranks"][rank][0]["fused_sgd"]
        assert got["calls"] == {"k1": 4 * steps, "k2": 4 * steps}
        assert got["sum_groups"] == [WORLD] * (8 * steps)
        assert got["counts"]["grad_all_reduce"] == steps
        assert got["counts"]["all_reduce"] >= 8 * steps
    one = runs["one"][0]["fused_sgd"]
    assert one["calls"] == {"k1": 4 * steps, "k2": 4 * steps}
    assert one["sum_groups"] == [1] * (8 * steps)
    assert not one["counts"]


def test_cli_rank_zero_alone_writes_its_files(runs):
    """Both ranks ran the CLI on one data directory into one --out
    directory: rank 0 wrote the synthetic corpus (its meta.json),
    result_finetuning_unet_None.pkl and test_None.json; rank 1 nothing."""
    r0, r1 = (runs["ranks"][r][0]["cli"] for r in range(WORLD))
    assert sorted(r0["written"]) == ["meta.json",
                                     "result_finetuning_unet_None.pkl",
                                     "test_None.json"]
    assert r1["written"] == []
    assert r0["tag"] == r1["tag"] == "None"
    out = runs["tmp"] / "ranks" / "cli_out"
    assert sorted(os.listdir(out)) == ["result_finetuning_unet_None.pkl",
                                       "test_None.json"]


def test_cli_two_ranks_equal_one_process(runs):
    """The two-rank CLI's test_None.json and grid pickle against the
    one-process CLI's: the test metrics within cmx's DP loss tolerance,
    the same hypers and fold count; both ranks report rank 0's metrics."""
    tmp = runs["tmp"]
    ours = json.loads((tmp / "ranks" / "cli_out" / "test_None.json")
                      .read_text())
    ref = json.loads((tmp / "one" / "cli_out" / "test_None.json")
                     .read_text())
    assert ours["hypers"] == ref["hypers"] == {"lr": 1e-3, "batch": 8,
                                               "epochs": 1}
    assert sorted(ours["test_metrics"]) == sorted(ref["test_metrics"])
    for k, v in ref["test_metrics"].items():
        np.testing.assert_allclose(ours["test_metrics"][k], v,
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert runs["ranks"][1][0]["cli"]["test_metrics"] == ours["test_metrics"]
    grids = []
    for d in ("ranks", "one"):
        with open(tmp / d / "cli_out" / "result_finetuning_unet_None.pkl",
                  "rb") as f:
            grids.append(pickle.load(f))
    assert len(grids[0][0]["folds"]) == len(grids[1][0]["folds"]) == 3
    np.testing.assert_allclose(grids[0][0]["score"], grids[1][0]["score"],
                               rtol=LOSS_RTOL)


def test_trainer_run_step_matches_cmx_trainer(runs):
    """Trainer on 2 ranks (rank 1 built from another seed, made rank 0's by
    prepare_state) against cmx's Trainer on 8 devices, one SGD step on the
    global batch of 8: loss and metrics at rtol 1e-5 (dice 1e-6), grad norm
    1e-5, parameters within 2e-5 and BN running stats within 1e-5."""
    from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout

    jm, jstate = runs["cmx_trainer"]
    r0, vals = runs["ranks"][0][0]["trainer"], runs["ranks"][0][1]
    m = r0["metrics"]
    for k in ("loss", "cross_entropy_loss", "iou_loss", "grad_norm"):
        np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(m["dice_loss"], jm["dice_loss"], rtol=1e-6)
    model = _unet()
    for name, _ in model.named_parameters():
        ref = jstate.params
        for part in name.split("."):
            ref = ref[part]
        got = _to_flax_layout(vals[f"trainer/{name}"], _kind(model, name))
        np.testing.assert_allclose(got, np.asarray(ref), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)
    for name, _ in model.named_buffers():
        ref = jstate.batch_stats
        for part in name.split("."):
            ref = ref[part]
        np.testing.assert_allclose(vals[f"trainer/{name}"], np.asarray(ref),
                                   atol=BN_ATOL, rtol=0, err_msg=name)


def test_local_scope_makes_collectives_no_ops(runs):
    """Under mesh.local() in a group of 2 a rank is alone: info (0, 1), an
    all-reduce leaves its tensor and counts nothing."""
    for rank in range(WORLD):
        s = runs["ranks"][rank][0]["scopes"]
        assert s["local_info"] == [0, 1]
        assert s["local_sum"] == [1.0, 1.0, 1.0]
        assert s["local_counts"] == {}


def test_sub_group_of_one_and_a_rank_outside_it(runs):
    """mesh.sub_group(1): rank 0 is its member (rank 0 of 1), rank 1 is not
    and any collective it tries there raises."""
    s0, s1 = (runs["ranks"][r][0]["scopes"] for r in range(WORLD))
    assert s0["member"] and s0["sub_info"] == [0, 1]
    assert not s1["member"]
    assert "outside the current sub group" in s1["outside"]


def test_backward_sums_in_the_scope_of_its_forward(runs):
    """A _SyncSum and a FlatDoubleConv made inside sub_group(1), their
    backward run after the block has exited: every all-reduce of the
    backward (the cotangent's, K2's dgamma/dbeta sums) runs in the group of
    one, so the cotangent is rank 0's alone (2, not 4 as in the world)."""
    s0 = runs["ranks"][0][0]["scopes"]
    assert s0["backward_infos"]
    assert all(i == [0, 1] for i in s0["backward_infos"])
    assert len(s0["backward_infos"]) == 1 + 2  # _SyncSum, K2's two sums
    assert s0["sync_grad"] == [2.0, 2.0, 2.0]
    for rank in range(WORLD):
        s = runs["ranks"][rank][0]["scopes"]
        assert s["world_infos"] == [[rank, 2], [rank, 2]]  # fwd, bwd
        assert s["world_grad"] == [4.0, 4.0, 4.0]


def test_host_loop_batch_that_does_not_split_raises(runs):
    """The host loop pads a chunk to max(batch, W) rows; a batch of 3 over 2
    ranks does not split, and fit says so before any step (cmx's
    shard_batch fails there too)."""
    for rank in range(WORLD):
        msg = runs["ranks"][rank][0]["scopes"]["split"]
        assert msg == "the host loop's batch of 3 does not split over 2 ranks"


def test_mesh_scopes_are_no_ops_without_a_group():
    """Without a process group sub_group(k) yields True and local() changes
    nothing: info (0, 1), no collective counted, a backward the identity."""
    from cmx_torch.parallel import mesh

    mesh.reset_counts()
    x = torch.ones(3, requires_grad=True)
    for scope in (mesh.sub_group(4), mesh.local()):
        with scope as member:
            assert member in (True, None)
            assert mesh.info() == (0, 1) and not mesh.active()
            assert mesh.all_reduce_sync(x) is x
            assert mesh.broadcast_object({"a": 1}) == {"a": 1}
            assert mesh.backend() == "none"
    assert mesh.scope() is None and not mesh.counts


@pytest.mark.parametrize("n,batch,pad", [(10, 8, 8), (3, 8, 8), (10, 8, 2),
                                         (5, 3, 8), (16, 4, 8), (1, 1, 4),
                                         (7, 4, 1)])
def test_batches_pad_like_cmx(n, batch, pad):
    """_batches(n, batch, rng, pad_multiple) equals cmx's: chunks of
    max(batch, pad_multiple) rows, wrap-padded."""
    from cmx.train.harness import _batches as jbatches
    from cmx_torch.train.harness import _batches

    ours = list(_batches(n, batch, np.random.default_rng(n), pad))
    ref = list(jbatches(n, batch, np.random.default_rng(n), pad))
    assert len(ours) == len(ref)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert all(len(c) == max(batch, pad) for c in ours)
