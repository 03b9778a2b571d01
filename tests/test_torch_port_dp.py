"""Data parallel of the port (cmx_torch.parallel): two gloo ranks on the CPU
against one process and against cmx.

cmx's step is one global-view program over a batch-sharded mesh, and its
own test holds a sharded step to the unsharded one
(tests/test_distributed_parity.py: loss rtol 1e-5, dice_loss rtol 1e-6,
parameters atol 2e-5, BN running stats atol 1e-5). Here every case runs in
three processes spawned once for the module (`python
tests/test_torch_port_dp.py DRAWS OUT`, gloo, torch only): the two ranks of
a group, each with its B/2 rows of the global batch of B, and one process in
a group of one. The test process runs the same cases without a group
(`one`), and cmx's step at B from the same weights (the port's, crossed by
to_flax) and draws. Each case takes two steps:
  step 1 without augmentation, cmx's draws injected for the global batch
  (each rank takes its rows): against cmx;
  step 2 with the augmentation and the port's own draws, made for the global
  batch from the step generator and sliced: the ranks against one process.
Cases (fp32 unless named; reduced widths (8, 16, 32, 64), bottleneck 128):
  sup: the supervised UNet, Dice + CE, SGD momentum 0.9 (cmx's own DP case),
    32^2, B 8;
  spark_flat / spark_nhwc: SparK fused through FlatDoubleConv /
    FusedDoubleConv (the plain K1/K2 and K6-K8 inside the same autograd
    Functions, computing in fp32: COMPUTE_DTYPE and the bf16 gate patched)
    with pallas_loss (K3's plain version inside SparkLoss), SGD, 64^2
    (down1 and down2 fused), B 4; cmx runs its fp32 step (its gate fuses
    bf16 only), its K3 in interpret mode;
  spark_bf16: the same in bf16 with LAMB, the SparK recipe's, at 32^2
    (down1 fused) against cmx's fused bf16 step (Pallas in interpret mode),
    at test_torch_port_step.py's bf16 bands (loss 2e-2, BN stats 5e-2);
  moco: UNetEncoderGAP, queue K 8, SGD, 32^2 images as the views in step 1
    and 32^2 views of 64^2 images in step 2, B 4;
  cmunet: CMUNetOnline, view 32, SGD, EMA 0.996, B 4, at the reduced widths
    in both packages (their cmunet modules' UNetEncoder and UNetDecoder
    patched; the target's 1x1 reduce then takes 128 channels to 256).
Two ranks are held to one process at cmx's DP tolerances after both steps,
but for step 2's grad norm (rel 1e-4: step 1's rounding, amplified by BN
over 4 images). Against cmx the port's own one-process tolerances hold
where they are looser than cmx's DP ones (MoCo's and SparK's losses: rel
1e-4, as test_torch_port_moco.py and test_torch_port_step.py).
"""

import contextlib
import functools
import hashlib
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
WIDTHS = (8, 16, 32, 64)
BNECK = 128
THREADS = 2  # every process's intra-op threads (bit-for-bit across them)
CASES = ("sup", "spark_flat", "spark_nhwc", "spark_bf16", "moco", "cmunet")
SIZES = {"sup": (8, 32), "spark_flat": (4, 64), "spark_nhwc": (4, 64),
         "spark_bf16": (4, 32), "moco": (4, 32), "cmunet": (4, 32)}
MOCO_K, VIEW = 8, 32
SPARK_LR, SGD_LR = 2e-4, 1e-2
# cmx's DP tolerances (tests/test_distributed_parity.py)
LOSS_RTOL, DICE_RTOL, PARAM_ATOL, BN_ATOL = 1e-5, 1e-6, 2e-5, 1e-5


# ---------------------------------------------------------------- the cases
# (run in every process: torch only)


def _images(case, seed=0, size=None):
    b, s = SIZES[case]
    return np.random.default_rng(seed).normal(
        size=(b, size or s, size or s)).astype(np.float32) + 1.0


def _masks(b, s):
    lab = np.random.default_rng(1).random((b, s, s)) > 0.6
    return np.stack([~lab, lab], 1).astype(np.float32)  # one-hot NCHW


def _tensors(state):
    """Every tensor of a TrainState by name: the model's parameters and
    buffers, the optimizer's state, the task's extra."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"opt/{k}/{i}"] = t
    for k, v in (state.extra or {}).items():
        items = (v.state_dict().items() if isinstance(v, torch.nn.Module)
                 else [("", v)])
        for n, t in items:
            out[f"extra/{k}/{n}"] = t
    return out


def _digest(t):
    a = t.detach().cpu().contiguous().reshape(-1)
    return hashlib.sha256(a.view(torch.uint8).numpy().tobytes()
                          if a.numel() else b"").hexdigest()


def _spark(case):
    from cmx_torch.ssl.spark import SparKModel, make_spark_task

    dtype = torch.bfloat16 if case == "spark_bf16" else torch.float32
    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK, dtype=dtype,
                       fused=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    size = SIZES[case][1]
    tasks = [make_spark_task(model, input_size=size, pallas_loss=True,
                             augment=a)[0] for a in (False, True)]
    # LAMB (the SparK recipe's) in bf16; SGD in fp32: Adam-type steps turn
    # the rounding noise of the gradients whose true value is 0 (the conv
    # biases a BN absorbs) into +-lr moves whose signs differ with the
    # summation order, which holds neither package to another (see
    # test_torch_port_step.py)
    if case == "spark_bf16":
        return model, tasks, "lamb", SPARK_LR, None
    return model, tasks, "sgd", SGD_LR, None


def _build(case):
    """(model, (task without augmentation, task with it), optimizer name,
    lr, extra)."""
    if case.startswith("spark"):
        return _spark(case)
    gen = torch.Generator().manual_seed(0)
    if case == "sup":
        from cmx_torch.models.unet import UNet
        from cmx_torch.train.supervised import make_supervised_task

        model = UNet(2, WIDTHS, BNECK, dtype=torch.float32)
        model.reset_parameters(gen)
        tasks = [make_supervised_task(model, augment=a)[0]
                 for a in (False, True)]
        return model, tasks, "sgd", SGD_LR, None
    if case == "moco":
        from cmx_torch.models.unet import UNetEncoderGAP
        from cmx_torch.ssl.moco import make_moco_task

        model = UNetEncoderGAP(WIDTHS, BNECK, dtype=torch.float32)
        model.reset_parameters(gen)
        tasks = [make_moco_task(model, num_negatives=MOCO_K, view_size=VIEW,
                                augment=a)[0] for a in (False, True)]
        extra = tasks[0].init_extra(torch.Generator().manual_seed(1))
        # a key encoder other than the online one, and a queue of its keys
        # of other images, so that the negatives compete with the positive
        # (a loss of order log(K + 1), as in training)
        key = extra["key_model"]
        key.reset_parameters(torch.Generator().manual_seed(2))
        others = torch.from_numpy(_images(case, seed=5, size=VIEW)).repeat(
            MOCO_K // SIZES[case][0], 1, 1)
        with torch.no_grad():
            emb = key.eval()(others + torch.linspace(0, 1, MOCO_K)[:, None,
                                                                    None])
        key.train()
        extra["queue"] = emb / torch.linalg.vector_norm(emb, dim=1,
                                                        keepdim=True)
        return model, tasks, "sgd", SGD_LR, extra
    from cmx_torch.ssl.cmunet import CMUNetOnline, make_cmunet_task

    model = CMUNetOnline(torch.float32, VIEW)
    model.reset_parameters(gen)
    tasks = [make_cmunet_task(model, view_size=VIEW, augment=a)[0]
             for a in (False, True)]
    extra = tasks[0].init_extra(torch.Generator().manual_seed(1))
    return model, tasks, "sgd", SGD_LR, extra


@contextlib.contextmanager
def _patched(case):
    """The fused gate at these sizes (FUSED_MIN_HW 32, as the repo's other
    fused tests), the NHWC impl for spark_nhwc, for the fp32 fused cases
    the kernels' plain versions computing in fp32 behind a gate that takes
    an fp32 model, and CM-UNet at the reduced widths."""
    from cmx_torch.models import blocks, unet
    from cmx_torch.ops import fused_conv as fc
    from cmx_torch.ssl import cmunet

    saved = (fc.FUSED_MIN_HW, fc.FUSED_IMPL, fc.COMPUTE_DTYPE,
             blocks.DoubleConv.use_fused, cmunet.UNetEncoder,
             cmunet.UNetDecoder, cmunet.BOTTLENECK_WIDTH)
    fc.FUSED_MIN_HW = 32
    cmunet.UNetEncoder = functools.partial(unet.UNetEncoder, WIDTHS, BNECK)
    cmunet.UNetDecoder = functools.partial(unet.UNetDecoder, widths=WIDTHS,
                                           in_channels=BNECK)
    cmunet.BOTTLENECK_WIDTH = BNECK
    if case == "spark_nhwc":
        fc.FUSED_IMPL = "nhwc"
    if case in ("spark_flat", "spark_nhwc"):
        fc.COMPUTE_DTYPE = torch.float32

        def use_fused(self, x):
            _, cin, h, w = x.shape
            return (self.fused and self.training and h >= fc.FUSED_MIN_HW
                    and h % fc.STRIP == 0 and w % 8 == 0
                    and cin <= fc.FUSED_MAX_CIN)

        blocks.DoubleConv.use_fused = use_fused
    try:
        yield
    finally:
        (fc.FUSED_MIN_HW, fc.FUSED_IMPL, fc.COMPUTE_DTYPE,
         blocks.DoubleConv.use_fused, cmunet.UNetEncoder, cmunet.UNetDecoder,
         cmunet.BOTTLENECK_WIDTH) = saved


def _batches(case):
    """The global batches of steps 1 and 2 (numpy)."""
    b, s = SIZES[case]
    if case == "sup":
        return ((_images(case), _masks(b, s)),
                (_images(case, seed=2), _masks(b, s)[::-1].copy()))
    second = _images(case, seed=2, size=64 if case == "moco" else None)
    return _images(case), second


def _local(batch):
    from cmx_torch.parallel import mesh

    if isinstance(batch, tuple):
        return tuple(_local(x) for x in batch)
    return mesh.rank_slice(torch.from_numpy(batch))


def run_case(case, draws):
    """Two steps of `case` in this process (its rank's rows of each global
    batch; `draws` the global draws of step 1). Returns the metrics and the
    collectives' counts of each step, step 1's gradients after the
    all-reduce, and every state tensor after each step."""
    from cmx_torch.parallel import mesh
    from cmx_torch.train import trainer
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState

    with _patched(case):
        model, tasks, opt, lr, extra = _build(case)
        if opt == "lamb":
            tx = make_optimizer("lamb", lr, 0.04, clip_norm=5.0,
                                named_params=model.named_parameters())
        else:
            tx = make_optimizer("sgd", lr, 0.0, momentum=0.9,
                                named_params=model.named_parameters())
        state = TrainState.create(model=model, tx=tx, seed=3, extra=extra)
        mesh.replicate(state.model, state.extra)
        names = [n for n, _ in model.named_parameters()]
        grads = {}
        norm = trainer.global_grad_norm

        def capture(gs):
            if not grads:
                grads.update({n: g.detach().clone()
                              for n, g in zip(names, gs)})
            return norm(gs)

        out = {"metrics": [], "counts": [], "states": []}
        trainer.global_grad_norm = capture
        try:
            for task, batch, d in zip(tasks, _batches(case), (draws, None)):
                mesh.reset_counts()
                m = trainer.make_train_step(task, tx)(state, _local(batch), d)
                out["metrics"].append({k: float(v) for k, v in m.items()})
                out["counts"].append(dict(mesh.counts))
                out["states"].append({k: t.detach().clone() for k, t in
                                      _tensors(state).items()})
        finally:
            trainer.global_grad_norm = norm
        out["grads"] = grads
    return out


def _values(case, res):
    """What the test process reads beside the digests: the model's
    parameters and buffers and every tensor of extra after each step, and
    step 1's gradients (after the all-reduce)."""
    keep = {f"s{i}/{k}": t for i, st in enumerate(res["states"])
            for k, t in st.items() if k.startswith(("model/", "extra/"))}
    keep.update({f"grad/{k}": g for k, g in res["grads"].items()})
    return {k: t.float().numpy() if t.is_floating_point() else t.numpy()
            for k, t in keep.items()}


def _pack(case, res, values):
    out = {f"{case}/json": np.array(json.dumps({
        "metrics": res["metrics"], "counts": res["counts"],
        "digests": [{k: _digest(t) for k, t in st.items()}
                    for st in res["states"]]}))}
    if values:
        out.update({f"{case}/{k}": v for k, v in _values(case, res).items()})
    return out


def _unpack(case, f):
    res = json.loads(str(f[f"{case}/json"]))
    pre = f"{case}/"
    res["values"] = {k[len(pre):]: f[k] for k in f.files
                     if k.startswith(pre) and k != f"{case}/json"}
    return res


def _step1_draws(case, arrays):
    d = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in arrays.items()
         if k.startswith(case + "/")}
    return d or None


def _worker(draws_path, out_path):
    """One process of the module's runs: the group from the launcher's
    environment (gloo), every case, results to OUT.<rank>.npz."""
    torch.set_num_threads(THREADS)
    sys.path.insert(0, str(ROOT))
    from cmx_torch.parallel import dist

    dist.initialize_distributed("cpu")
    rank, world = dist.process_info()
    with np.load(draws_path) as f:
        arrays = {k: f[k] for k in f.files}
    out = {}
    for case in CASES:
        res = run_case(case, _step1_draws(case, arrays))
        out.update(_pack(case, res, values=rank == 0 and world > 1))
    np.savez(f"{out_path}.{rank}.npz", **out)
    dist.shutdown()


if __name__ == "__main__":
    _worker(*sys.argv[1:3])
    sys.exit(0)


# ------------------------------------------------------------- the test side


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp, name, world):
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS=str(THREADS))
    procs = []
    for rank in range(world):
        log = open(tmp / f"{name}.{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp / "draws.npz"),
             str(tmp / name)], env=dict(env, RANK=str(rank),
                                        LOCAL_RANK=str(rank)),
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, timeout=600):
    """Every process's exit (each killed past `timeout`); raises with the
    logs when one failed."""
    bad = []
    for p, log in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode != 0:
            bad.append(Path(log.name).read_text()[-4000:])
    if bad:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        raise AssertionError("a rank failed:\n" + "\n---\n".join(bad))


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _cmx_draws():
    """Step 1's draws of each case as cmx's step makes them at step 0 of a
    state keyed 7, for the global batch."""
    import jax

    from cmx.ops.masking import random_patch_mask, spark_active_mask

    rng = jax.random.fold_in(jax.random.key(7), 0)
    out = {}
    for case in ("spark_flat", "spark_nhwc", "spark_bf16"):
        b, s = SIZES[case]
        km, _ = jax.random.split(rng)
        out[f"{case}/active"] = np.array(spark_active_mask(km, b, s // 16,
                                                           0.6))
    _, km = jax.random.split(rng)
    out["cmunet/active"] = np.array(random_patch_mask(km, SIZES["cmunet"][0],
                                                      VIEW, 16, 0.65))
    return out


def _cmx_step(case):
    """cmx's first step at the global batch from the port's initial weights
    (to_flax): (metrics, state). spark_flat and spark_nhwc share one: cmx's
    fp32 SparK step runs its unfused path."""
    if case == "spark_nhwc":
        case = "spark_flat"
    import jax
    import jax.numpy as jnp

    from cmx.ops import fused_conv as cfc
    from cmx.train.optim import make_optimizer as jopt
    from cmx.train.state import TrainState as JState
    from cmx.train.trainer import make_train_step as jstepf
    from cmx_torch.ckpt.checkpoint import (cmunet_extra_to_flax,
                                           moco_extra_to_flax, to_flax)

    with _patched(case):
        model, _, opt, lr, extra = _build(case)
    v = jax.tree.map(np.asarray, to_flax(model))
    batch = _batches(case)[0]
    jextra = None
    if case == "sup":
        from cmx.train.supervised import make_supervised_task
        from test_torch_port_finetune import SmallUNet

        jt, _ = make_supervised_task(SmallUNet(dtype=jnp.float32),
                                     augment=False)
        batch = (batch[0], batch[1].transpose(0, 2, 3, 1))
    elif case.startswith("spark"):
        from cmx.ssl.spark import SparKModel, make_spark_task

        jdt = jnp.bfloat16 if case == "spark_bf16" else jnp.float32
        jt, _ = make_spark_task(
            SparKModel(widths=WIDTHS, bottleneck_width=BNECK, dtype=jdt,
                       fused=True),
            input_size=SIZES[case][1], pallas_loss=True, augment=False)
    elif case == "moco":
        from cmx.ssl.moco import make_moco_task
        from test_torch_port_moco import GapEncoder

        jt, _ = make_moco_task(GapEncoder(dtype=jnp.float32),
                               num_negatives=MOCO_K, view_size=VIEW,
                               augment=False)
        jextra = moco_extra_to_flax(extra)
    else:
        from cmx.ssl import cmunet as jcm

        jt, _ = jcm.make_cmunet_task(jcm.CMUNetOnline(dtype=jnp.float32),
                                     view_size=VIEW, patch_size=16,
                                     augment=False)
        jextra = cmunet_extra_to_flax(extra)
    if opt == "lamb":
        jtx = jopt("lamb", lr, 0.04, clip_norm=5.0, params_example=v["params"])
    else:
        jtx = jopt("sgd", lr, 0.0, momentum=0.9, params_example=v["params"])
    kw = {} if jextra is None else {"extra": jax.tree.map(jnp.asarray,
                                                          jextra)}
    state = JState.create(params=v["params"], batch_stats=v["batch_stats"],
                          tx=jtx, rng=jax.random.key(7), **kw)
    from cmx.models import unet as junet
    from cmx.ssl import cmunet as jcm

    saved = cfc.FUSED_MIN_HW, jcm.UNetEncoder, jcm.UNetDecoder
    cfc.FUSED_MIN_HW = 32
    jcm.UNetEncoder = functools.partial(junet.UNetEncoder, widths=WIDTHS,
                                        bottleneck=BNECK)
    jcm.UNetDecoder = functools.partial(junet.UNetDecoder, widths=WIDTHS)
    try:
        batch = jax.tree.map(jnp.asarray, batch)
        state, m = jstepf(jt, jtx, donate=False)(state, batch)
    finally:
        cfc.FUSED_MIN_HW, jcm.UNetEncoder, jcm.UNetDecoder = saved
    return {k: float(x) for k, x in m.items()}, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"one": the cases without a group, "cmx": cmx's first steps,
    "ranks": the two ranks' results, "w1": the group of one's}."""
    tmp = tmp_path_factory.mktemp("dp")
    np.savez(tmp / "draws.npz", **_cmx_draws())
    procs = {"ranks": _spawn(tmp, "ranks", 2), "w1": _spawn(tmp, "w1", 1)}
    try:
        with np.load(tmp / "draws.npz") as f:
            arrays = {k: f[k] for k in f.files}
        threads = torch.get_num_threads()
        torch.set_num_threads(THREADS)
        try:
            one = {}
            for case in CASES:
                res = run_case(case, _step1_draws(case, arrays))
                packed = _pack(case, res, values=True)
                one[case] = dict(json.loads(str(packed[f"{case}/json"])),
                                 values=_values(case, res))
        finally:
            torch.set_num_threads(threads)
        ref = {case: _cmx_step(case) for case in CASES
               if case != "spark_nhwc"}
        ref["spark_nhwc"] = ref["spark_flat"]
    finally:
        for group in procs.values():
            _wait(group)
    out = {"one": one, "cmx": ref}
    for name, world in (("ranks", 2), ("w1", 1)):
        out[name] = []
        for rank in range(world):
            with np.load(tmp / f"{name}.{rank}.npz") as f:
                out[name].append({c: _unpack(c, f) for c in CASES})
    return out


# ------------------------------------------------------------------- tests


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-30)


def _bn(name):
    return name.endswith((".mean", ".var"))


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(runs, case):
    """Both steps of two ranks at B/2 against one process at B: losses and
    metrics, grad norm, and after each step the parameters and every BN
    running stat (fp32: cmx's DP tolerances; bf16: the bf16 bands)."""
    one, r0 = runs["one"][case], runs["ranks"][0][case]
    bf16 = case == "spark_bf16"
    for i in range(2):
        mo, mr = one["metrics"][i], r0["metrics"][i]
        assert mr["nonfinite"] == mo["nonfinite"] == 0.0
        assert abs(mr["loss"] - mo["loss"]) <= (
            2e-2 if bf16 else LOSS_RTOL) * abs(mo["loss"]), (i, mr, mo)
        if not bf16:
            # step 2 starts from parameters that differ by step 1's
            # rounding, which BN over 4 images amplifies: one process
            # given the same batch with its rows permuted moves CM-UNet's
            # step-1 gradients more than the second rank does (4.8e-4 in
            # L2 on a leaf of 5.4), and its step-2 grad norm moves by 4e-5
            np.testing.assert_allclose(mr["grad_norm"], mo["grad_norm"],
                                       rtol=1e-5 if i == 0 else 1e-4)
        for k in set(mo) - {"loss", "grad_norm", "nonfinite"}:
            rtol = DICE_RTOL if k == "dice_loss" else LOSS_RTOL
            assert abs(mr[k] - mo[k]) <= (2e-2 if bf16 else rtol) * max(
                abs(mo[k]), 1e-6), (i, k, mr[k], mo[k])
        for k, ref in one["values"].items():
            if not k.startswith(f"s{i}/"):
                continue
            got = r0["values"][k]
            if bf16:
                if _bn(k):
                    assert float(np.max(np.abs(got - ref))) < 5e-2, k
                continue
            np.testing.assert_allclose(
                got, ref, atol=BN_ATOL if _bn(k) else PARAM_ATOL, rtol=0,
                err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_replicas_stay_equal_bit_for_bit(runs, case):
    """After each step every tensor of the two ranks' states (parameters,
    BN stats, optimizer state, extra) is the same bits, and both ranks
    report the same metrics."""
    a, b = (runs["ranks"][r][case] for r in range(2))
    for i in range(2):
        assert a["digests"][i] == b["digests"][i], i
        assert a["metrics"][i] == b["metrics"][i]


@pytest.mark.parametrize("case", CASES)
def test_a_group_of_one_is_the_step_without_a_group(runs, case):
    """World size 1 inside a gloo group: every collective is the identity,
    so both steps equal the test process's (no group) bit for bit."""
    w1, one = runs["w1"][0][case], runs["one"][case]
    assert w1["metrics"] == one["metrics"]
    assert w1["digests"] == one["digests"]
    assert not any(one["counts"])  # no group: no collective
    assert all(c["grad_all_reduce"] == 1 for c in w1["counts"])


@pytest.mark.parametrize("case", CASES)
def test_collectives_are_counted(runs, case):
    """Each step all-reduces its gradients once, 4 bytes a parameter, and
    makes the same collectives at world size 1 and 2."""
    r0, w1 = runs["ranks"][0][case], runs["w1"][0][case]
    n = sum(v.size for k, v in runs["one"][case]["values"].items()
            if k.startswith("grad/"))
    for i in range(2):
        c = r0["counts"][i]
        assert c["grad_all_reduce"] == 1 and c["all_reduce"] > 0
        assert c["grad_all_reduce_bytes"] == 4 * n
        assert {k: v for k, v in c.items() if not k.endswith("_bytes")} \
            == {k: v for k, v in w1["counts"][i].items()
                if not k.endswith("_bytes")}


def _flax(model, name, value):
    from cmx_torch.ckpt.checkpoint import _kind, _to_flax_layout

    return _to_flax_layout(value, _kind(model, name))


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_cmx(runs, case):
    """Step 1 of two ranks at B/2 against cmx's step at B from the same
    weights and draws: loss (and the task's metrics), grad norm,
    parameters, BN running stats, and the task state (MoCo's queue and key
    encoder, CM-UNet's target, its EMA and BN stats)."""
    jm, jstate = runs["cmx"][case]
    r0 = runs["ranks"][0][case]
    m = r0["metrics"][0]
    bf16 = case == "spark_bf16"
    # the port's one-process tolerance against cmx where it is looser
    loss_rtol = 2e-2 if bf16 else 1e-4 if case in ("moco", "spark_flat",
                                                    "spark_nhwc") else 1e-5
    assert abs(m["loss"] - jm["loss"]) <= loss_rtol * abs(jm["loss"]), (
        m["loss"], jm["loss"])
    if case == "sup":
        np.testing.assert_allclose(m["dice_loss"], jm["dice_loss"],
                                   rtol=DICE_RTOL)
    with _patched(case):
        model = _build(case)[0]
    vals = r0["values"]
    for name, _ in model.named_parameters():
        if bf16:
            break
        got = _flax(model, name, vals[f"s0/model/{name}"])
        np.testing.assert_allclose(got, np.asarray(_leaf(jstate.params, name)),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    for name, _ in model.named_buffers():
        ref = np.asarray(_leaf(jstate.batch_stats, name))
        got = vals[f"s0/model/{name}"]
        if bf16:
            assert float(np.max(np.abs(got - ref))) < 5e-2, name
        else:
            np.testing.assert_allclose(got, ref, atol=BN_ATOL, rtol=0,
                                       err_msg=name)
    if case == "moco":
        ex = jstate.extra
        np.testing.assert_allclose(vals["s0/extra/queue/"],
                                   np.asarray(ex["queue"]), atol=1e-6)
        assert int(vals["s0/extra/queue_ptr/"]) == int(ex["queue_ptr"]) == 4
        for k, t in vals.items():
            if k.startswith("s0/extra/key_model/"):
                name = k[len("s0/extra/key_model/"):]
                tree = ex["key_batch_stats" if _bn(name) else "key_params"]
                np.testing.assert_allclose(
                    t if _bn(name) else _flax(model, name, t),
                    np.asarray(_leaf(tree, name)), atol=PARAM_ATOL, err_msg=k)
    if case == "cmunet":
        for k in ("loss_ct", "loss_rc"):
            assert abs(m[k] - jm[k]) <= 1e-5 * abs(jm[k]), k
        ex = jstate.extra
        for k, t in vals.items():
            if k.startswith("s0/extra/target_model/"):
                name = k[len("s0/extra/target_model/"):]
                bn = _bn(name)
                np.testing.assert_allclose(
                    t if bn else _flax(model, name, t),
                    np.asarray(_leaf(ex["target_batch_stats" if bn else
                                        "target_params"], name)),
                    atol=BN_ATOL if bn else PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("case", ["spark_flat", "spark_nhwc"])
def test_fused_bn_gradients_are_each_ranks_own(runs, case):
    """The fused DoubleConv's K2 reads the global (dgamma, dbeta) sums, but
    its gamma/beta gradients are the rank's own: the step's all-reduce adds
    them up to one process's. Returning the global sums would count them
    twice here."""
    one, r0 = runs["one"][case]["values"], runs["ranks"][0][case]["values"]
    names = [k for k in one if k.startswith(("grad/encoder.down1.",
                                             "grad/encoder.down2."))
             and ".bn" in k]
    assert len(names) == 2 * 2 * 2  # down1, down2 x bn0, bn1 x scale, bias
    for k in names:
        assert _rel(r0[k], one[k]) <= 1e-5, (k, _rel(r0[k], one[k]))


def test_moco_queue_takes_the_global_keys_in_rank_order(runs):
    """Every rank enqueues the keys of the whole global batch in rank order
    (one process's queue) and the pointer advances by B: 4 after step 1,
    8 mod 8 after step 2."""
    one, r0 = runs["one"]["moco"]["values"], runs["ranks"][0]["moco"]["values"]
    for i, ptr in ((0, 4), (1, 0)):
        np.testing.assert_allclose(r0[f"s{i}/extra/queue/"],
                                   one[f"s{i}/extra/queue/"], atol=1e-6)
        assert int(r0[f"s{i}/extra/queue_ptr/"]) == ptr
    moved = np.any(one["s0/extra/queue/"] != one["s1/extra/queue/"], axis=1)
    assert moved.sum() == 4  # step 2 wrote rows 4..7


def test_mesh_helpers_are_no_ops_without_a_group():
    from cmx_torch.parallel import mesh

    mesh.reset_counts()
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    assert mesh.info() == (0, 1) and not mesh.active()
    for f in (mesh.all_reduce_shared, mesh.all_reduce_sync, mesh.rank_slice,
              mesh.global_mean, mesh.all_gather_batch):
        assert f(x) is x
    y = x[0]
    assert all(a is b for a, b in zip(mesh.all_reduce_sum_many(x, y), (x, y)))
    assert all(a is b for a, b in zip(mesh.all_reduce_tensors([x, y]), (x, y)))
    assert mesh.rank_slice_draws({"a": x, "b": None})["a"] is x
    assert mesh.global_batch(3) == 3
    mesh.replicate(torch.nn.Linear(2, 2), {"t": x})
    mesh.barrier()
    assert not mesh.counts


def test_k3_forward_writes_its_numerator():
    """K3's forward entry takes the numerator's pointer after the loss's
    (8 pointers, the stream last), and its plain version splits the same
    way: num / denom is the loss, bit for bit."""
    from cmx_torch.ops import _build
    from cmx_torch.ops import pallas_ops as po

    assert _build._SIGNATURES["spark_loss"]["cmx_spark_loss_fwd"] == \
        "pppppppp" + "iiiii" + "p"
    src = (_build.CSRC / "spark_loss.cu").read_text()
    assert "void* loss, void* num,\n" in src
    g = torch.Generator().manual_seed(0)
    rec = torch.randn((2, 32, 32), generator=g)
    imgs = torch.randn((2, 32, 32), generator=g)
    act = (torch.rand((2, 2, 2), generator=g) > 0.5).float()
    loss, num, denom = po._spark_loss(rec, imgs, act, 16)
    assert torch.equal(loss, po.spark_loss_pallas_plain(rec, imgs, act))
    assert torch.equal(num / denom, loss)
