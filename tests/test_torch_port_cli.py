"""The port's pretrain CLI and what it runs on, against cmx on the CPU.

  * the sampler's index stream, the synthetic corpus, the splits, the
    loaders and the config dump equal cmx's;
  * `encoder.npz` / `model.npz` cross both ways: each package's export loads
    in the other, the trees equal leaf for leaf, and the encoder's forward
    (eval BN, fp32) agrees to rel 1e-5 (summation order of XLA's and
    torch's CPU convs);
  * `cmx_torch.cli.pretrain.main` on the CPU (`--device cpu`, the kernels'
    plain versions) at small widths: a 4-epoch run cut after its epoch-1
    checkpoint and started again resumes there and ends bit for bit where an
    uninterrupted one does (the same config: the lr and wd schedules span
    train.epochs, so a resume with other epochs follows other schedules, as
    in cmx);
    MoCo validates and stops early; SparK's validation keeps the BN running
    statistics.
"""

import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx_torch.ckpt import checkpoint as tck
from cmx_torch.ckpt.checkpoint import to_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
CLI_BASE = ["data.synthetic=True", "data.image_size=32", "train.batch_size=4",
            "model.dtype=float32"]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


@pytest.mark.parametrize("n,batch,seed", [(7, 4, 42), (12, 4, 0), (33, 8, 3),
                                          (5, 16, 1)])
def test_sampler_yields_cmx_index_stream(n, batch, seed):
    from cmx.parallel.dist import InfiniteBatchSampler as J
    from cmx_torch.parallel.dist import InfiniteBatchSampler as T

    js, ts = J(n, batch, seed=seed), T(n, batch, seed=seed)
    assert ts.iters_per_epoch == js.iters_per_epoch
    ji, ti = iter(js), iter(ts)
    for _ in range(3 * js.iters_per_epoch + 1):  # more than one epoch
        assert np.array_equal(next(ji), next(ti))


def test_single_process_layout(monkeypatch):
    """Without WORLD_SIZE no process group is made and the layout is (0,
    1); WORLD_SIZE=2 without the launcher's other variables raises, naming
    what is missing."""
    from cmx_torch.parallel import dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert dist.process_info() == (0, 1)
    assert dist.initialize_distributed("cpu") is False
    assert dist.process_info() == (0, 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR.*torchrun"):
        dist.initialize_distributed("cpu")
    assert dist.process_info() == (0, 1)


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for f in names:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


@pytest.mark.parametrize("hard", [False, True])
def test_write_corpus_is_byte_equal_to_cmx(tmp_path, hard):
    from cmx.data.synthetic import write_corpus as jw
    from cmx_torch.data.synthetic import write_corpus as tw

    jw(str(tmp_path / "j"), n=4, size=32, seed=3, hard=hard)
    tw(str(tmp_path / "t"), n=4, size=32, seed=3, hard=hard)
    j, t = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert len(j) == 9 and j == t


def test_resolve_corpus_refuses_a_mismatching_meta_as_cmx(tmp_path):
    from cmx.data.synthetic import resolve_corpus as jr
    from cmx_torch.config.config import DataConfig
    from cmx_torch.data.synthetic import resolve_corpus as tr

    cfg = DataConfig(data_dir=str(tmp_path / "c"), image_size=16,
                     synthetic_n=3)
    assert tr(cfg) == str(tmp_path / "c")
    assert tr(cfg) == jr(cfg)  # a matching corpus is reused
    cfg.synthetic_n = 5
    for resolve in (jr, tr):
        with pytest.raises(RuntimeError, match="different parameters"):
            resolve(cfg)


@pytest.mark.parametrize("n,ratio", [(12, 0.1), (40, 0.1), (101, 0.3),
                                     (18, 0.01)])
def test_splits_equal_cmx(tmp_path, n, ratio):
    from cmx.data.splits import list_corpus as jl, make_splits as jm
    from cmx_torch.data.splits import list_corpus as tl, make_splits as tm

    for sub in ("imgs", "masks"):
        (tmp_path / sub).mkdir()
        for i in range(n):
            (tmp_path / sub / f"s{i:03d}.npy").write_bytes(b"")
    assert tl(str(tmp_path)) == jl(str(tmp_path))
    xs, ys = tl(str(tmp_path))
    assert vars(tm(xs, ys, ratio=ratio)) == vars(jm(xs, ys, ratio=ratio))


@pytest.fixture
def corpus(tmp_path):
    from cmx.data.splits import list_corpus
    from cmx.data.synthetic import write_corpus

    write_corpus(str(tmp_path / "c"), n=5, size=40, seed=2)
    return list_corpus(str(tmp_path / "c"))


@pytest.mark.parametrize("size", [40, 32])  # as stored, and resized
def test_loaders_give_cmx_arrays(corpus, size):
    import shutil

    from cmx.data.corpus import load_corpus as jload
    from cmx.native.loader import load_corpus_native as jnative
    from cmx_torch.data.corpus import load_corpus as tload
    from cmx_torch.native.loader import load_corpus_native as tnative

    xs, ys = corpus
    ji, jm = jload(xs, ys, size=size)
    ti, tm = tload(xs, ys, size=size)
    assert np.array_equal(ti, ji) and np.array_equal(tm, jm)
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native loader cannot be built")
    tn = tnative(xs, size)
    assert tn is not None and tn.dtype == np.float32
    assert np.array_equal(tn, jnative(xs, size))
    assert np.array_equal(tnative(ys, size, mode="nearest"),
                          jnative(ys, size, mode="nearest"))


@pytest.mark.parametrize("preset", [None, "spark", "moco"])
def test_to_dict_and_display_equal_cmx(preset):
    from cmx.config import config as jc
    from cmx.config.presets import PRESETS as JP
    from cmx_torch.config import config as tc
    from cmx_torch.config.presets import PRESETS as TP

    jcfg, tcfg = jc.Config(), tc.Config()
    if preset:
        jcfg, tcfg = JP[preset](jcfg), TP[preset](tcfg)
    assert tc.to_dict(tcfg) == jc.to_dict(jcfg)
    assert tc.display(tcfg) == jc.display(jcfg)


def _perturb_buffers(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            noise = torch.rand(b.shape, generator=g)
            b.copy_(0.5 + noise if name.endswith("var") else noise - 0.5)


def _port_spark(seed):
    from cmx_torch.ssl.spark import SparKModel

    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                       dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    _perturb_buffers(model, seed)
    return model


def _state(model):
    from cmx_torch.train.state import TrainState

    return TrainState.create(model=model, tx=None)


def _cmx_spark_variables(seed):
    from cmx.ops.masking import spark_active_mask
    from cmx.ssl.spark import SparKModel as JSparK

    jm = JSparK(widths=WIDTHS, bottleneck_width=BNECK, dtype=jnp.float32)
    key = jax.random.key(seed)
    x = jnp.zeros((1, 32, 32))
    return jm, _np_tree(jax.jit(jm.init)(key, x,
                                         spark_active_mask(key, 1, 2, 0.6)))


def _cmx_encoder_out(params, bs, x):
    from cmx.models.unet import UNetEncoder as JEnc

    enc = JEnc(widths=WIDTHS, bottleneck=BNECK, dtype=jnp.float32,
               use_running_average=True)
    bott, skips = enc.apply({"params": params["encoder"],
                             "batch_stats": bs["encoder"]}, jnp.asarray(x))
    return [np.asarray(bott)] + [np.asarray(s) for s in skips]


def _port_encoder_out(model, x):
    model.eval()
    with torch.no_grad():
        bott, skips = model.encoder(torch.from_numpy(x))
    return [t.numpy().transpose(0, 2, 3, 1) for t in [bott] + list(skips)]


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert np.array_equal(np.asarray(x, np.float32),
                              np.asarray(y, np.float32)), p


def test_port_encoder_npz_loads_in_cmx(tmp_path):
    from cmx.ckpt.checkpoint import load_encoder as jload

    model = _port_spark(5)
    path = str(tmp_path / "encoder.npz")
    tck.export_encoder(_state(model), path)
    _, v = _cmx_spark_variables(0)
    params, bs = jload(path, v["params"], v["batch_stats"])
    ours = to_flax(model)
    _assert_trees_equal({"p": params["encoder"], "b": bs["encoder"]},
                        {"p": ours["params"]["encoder"],
                         "b": ours["batch_stats"]["encoder"]})
    # the rest of cmx's tree is untouched
    _assert_trees_equal(params["decoder"], v["params"]["decoder"])
    x = np.random.default_rng(0).normal(size=(2, 32, 32)).astype(np.float32)
    for a, b in zip(_port_encoder_out(model, x),
                    _cmx_encoder_out(params, bs, x)):
        assert _rel(a, b) <= 1e-5


def _cmx_state(seed):
    import optax

    from cmx.train.state import TrainState

    _, v = _cmx_spark_variables(seed)
    rng = np.random.default_rng(seed)
    bs = jax.tree.map(lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
                      v["batch_stats"])
    return TrainState.create(params=v["params"], batch_stats=bs,
                             tx=optax.sgd(0.1))


def test_cmx_encoder_npz_loads_in_the_port(tmp_path):
    from cmx.ckpt.checkpoint import export_encoder as jexport

    state = _cmx_state(7)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jexport(state, jpath)
    model = _port_spark(1)
    before = to_flax(model)
    tck.load_encoder(jpath, model)
    after = to_flax(model)
    _assert_trees_equal({"p": after["params"]["encoder"],
                         "b": after["batch_stats"]["encoder"]},
                        {"p": state.params["encoder"],
                         "b": state.batch_stats["encoder"]})
    _assert_trees_equal(after["params"]["decoder"], before["params"]["decoder"])
    x = np.random.default_rng(1).normal(size=(2, 32, 32)).astype(np.float32)
    for a, b in zip(_port_encoder_out(model, x),
                    _cmx_encoder_out(state.params, state.batch_stats, x)):
        assert _rel(a, b) <= 1e-5
    # both packages' exports hold the same names and shapes
    tck.export_encoder(_state(model), tpath)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        assert all(j[k].shape == t[k].shape and j[k].dtype == t[k].dtype
                   for k in j.files)
        assert all(np.array_equal(j[k], t[k]) for k in j.files)


def test_model_npz_crosses_both_ways(tmp_path):
    from cmx.ckpt.checkpoint import export_model as jexport
    from cmx.ckpt.checkpoint import load_model_npz as jload

    state = _cmx_state(9)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jexport(state, jpath)
    model = tck.load_model_npz(jpath, _port_spark(2))
    _assert_trees_equal(to_flax(model), {"params": state.params,
                                         "batch_stats": state.batch_stats})
    tck.export_model(_state(model), tpath)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert sorted(j.files) == sorted(t.files)
        assert all(np.array_equal(j[k], t[k]) for k in j.files)
    other = _port_spark(3)
    _, v = _cmx_spark_variables(4)
    params, bs = jload(tpath, v["params"], v["batch_stats"])
    _assert_trees_equal({"params": params, "batch_stats": bs},
                        to_flax(model))
    assert not np.array_equal(to_flax(other)["params"]["mask_token0"],
                              to_flax(model)["params"]["mask_token0"])


@pytest.fixture
def small_widths(monkeypatch):
    """The CLI's models at small widths (cmx's tests use `widths` too)."""
    import cmx_torch.models.unet as unet
    import cmx_torch.ssl.spark as spark

    monkeypatch.setattr(spark, "SparKModel", functools.partial(
        spark.SparKModel, widths=WIDTHS, bottleneck_width=BNECK))
    monkeypatch.setattr(unet, "UNetEncoderGAP", functools.partial(
        unet.UNetEncoderGAP, widths=WIDTHS, bottleneck=BNECK))


def _run(tmp_path, name, task, args):
    from cmx_torch.cli.pretrain import main

    return main(["--device", "cpu", "--task", task] + CLI_BASE
                + [f"data.data_dir={tmp_path / 'data'}",
                   f"train.ckpt_dir={tmp_path / name}"] + args)


def _epochs(ckpt_dir):
    with open(os.path.join(ckpt_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


SPARK_RUNS = {
    "plain": ["task.augment=False"],
    # the plain versions of K1-K3 through the fused DoubleConv (bf16 only,
    # as in cmx; the 32^2 stage passes the gate) and SparkLoss
    "fused": ["model.fused_conv=True", "task.pallas_loss=True",
              "model.dtype=bfloat16"],
}


@pytest.mark.parametrize("run", sorted(SPARK_RUNS))
def test_cli_resume_equals_an_uninterrupted_run(tmp_path, small_widths,
                                                monkeypatch, run):
    from cmx_torch.ops import fused_conv as tfc
    from cmx_torch.ops import fused_conv_flat as tff
    from cmx_torch.ops import pallas_ops as tpo

    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)  # the 32^2 stage fuses
    calls = []
    for mod, name in ((tff, "flat_double_conv"),
                      (tpo, "spark_loss_pallas_trainable")):
        monkeypatch.setattr(mod, name, functools.partial(
            lambda f, *a: (calls.append(f.__name__), f(*a))[1],
            getattr(mod, name)))
    args = ["data.synthetic_n=12", "optim.name=lamb", "optim.lr=1e-3",
            "optim.warmup_epochs=1", "train.epochs=4"] + SPARK_RUNS[run]
    # a run cut right after its epoch-1 checkpoint (step 4 of 8) ...
    save = tck.CheckpointManager.save

    def save_then_stop(mgr, step, *a, **kw):
        save(mgr, step, *a, **kw)
        if step == 4:
            raise KeyboardInterrupt

    monkeypatch.setattr(tck.CheckpointManager, "save", save_then_stop)
    with pytest.raises(KeyboardInterrupt):
        _run(tmp_path, "a", "spark", args + ["train.save_every_epoch=True"])
    monkeypatch.setattr(tck.CheckpointManager, "save", save)
    # ... and started again: it resumes at epoch 2
    resumed = _run(tmp_path, "a", "spark", args + ["train.save_every_epoch=True"])
    assert resumed["loader"] == "native" and resumed["device_feed"]
    # the uninterrupted run also traces its second epoch (train.profile_dir)
    whole = _run(tmp_path, "b", "spark",
                 args + [f"train.profile_dir={tmp_path / 'prof'}"])
    assert os.listdir(tmp_path / "prof") == ["trace_ep1.json"]
    assert sorted(set(calls)) == ([] if run == "plain" else
                                  ["flat_double_conv",
                                   "spark_loss_pallas_trainable"])
    ckpt = resumed["ckpt_dir"]
    assert [r["epoch"] for r in _epochs(ckpt)] == [0, 1, 2, 3]
    a, b = resumed["state"], whole["state"]
    assert a.step == b.step == 8
    for (n, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), n
    for key, xs in a.opt.state_dict().items():
        ys = b.opt.state_dict()[key]
        for x, y in zip(xs if isinstance(xs, list) else [xs],
                        ys if isinstance(ys, list) else [ys]):
            assert torch.equal(x, y), key
    # the checkpoints kept, the exports and the stamp
    assert tck.CheckpointManager(ckpt).all_steps() == [4, 6, 8]
    stamp = json.load(open(resumed["stamp"]))
    with open(resumed["encoder"], "rb") as f:
        assert stamp["encoder_sha256"] == hashlib.sha256(f.read()).hexdigest()
    assert stamp["epochs_run"] == 4 and stamp["final_step"] == 8
    assert os.path.isfile(os.path.join(ckpt, "model.npz"))
    reloaded = tck.load_encoder(resumed["encoder"], _port_spark(11))
    for (n, x), y in zip(reloaded.encoder.state_dict().items(),
                         a.model.encoder.state_dict().values()):
        assert torch.equal(x, y), n


def test_cli_resumes_a_finished_run_to_more_epochs(tmp_path, small_widths):
    """2 epochs with a save each epoch, then the same run asked for 4: it
    resumes at step 4 and logs epochs 2 and 3 after 0 and 1 (its schedules
    now span 4 epochs, so it is not the uninterrupted 4-epoch run)."""
    args = ["data.synthetic_n=12", "optim.name=lamb", "task.augment=False",
            "train.save_every_epoch=True"]
    first = _run(tmp_path, "r", "spark", args + ["train.epochs=2"])
    out = _run(tmp_path, "r", "spark", args + ["train.epochs=4"])
    assert (first["state"].step, out["state"].step) == (4, 8)
    assert [r["epoch"] for r in _epochs(out["ckpt_dir"])] == [0, 1, 2, 3]
    assert json.load(open(out["stamp"]))["epochs_run"] == 4


def test_cli_device_defaults_to_cuda(tmp_path):
    from cmx_torch.cli.pretrain import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--task", "spark", f"train.ckpt_dir={tmp_path}"])
    assert not os.listdir(tmp_path)


def test_cli_refuses_tensorboard_and_unported_tasks(tmp_path, small_widths,
                                                   monkeypatch):
    """The options still to port raise, naming their ROADMAP item: MoCo's
    bank crop. (Runs of more than one process are ported: the 2-rank CLI
    run is in test_torch_port_dp.py; here a WORLD_SIZE without the
    launcher's other variables raises before anything is written.)"""
    with pytest.raises(NotImplementedError, match="MoCo view-pipeline"):
        _run(tmp_path, "bank", "moco", [
            "task.crop_impl=bank", "data.synthetic_n=8",
            "task.num_negatives=16", "task.view_size=24", "train.epochs=1"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        _run(tmp_path, "dp", "spark", ["train.epochs=1"])
    assert not (tmp_path / "dp").exists()


def test_cli_moco_validates_and_stops_early(tmp_path, small_widths):
    """lr 0 and no augmentation: the online and key encoders stay equal, so
    each epoch's validation keys enter the val queue as negatives that equal
    the next epoch's positives, and the val loss rises: with patience 2 the
    run stops at epoch 2 (that epoch is not logged, as in cmx)."""
    out = _run(tmp_path, "m", "moco", [
        "data.synthetic_n=40", "task.num_negatives=16",
        "task.view_size=24", "task.augment=False", "optim.name=sgd",
        "optim.lr=0.0", "train.patience=2", "train.epochs=6"])
    log = _epochs(out["ckpt_dir"])
    assert [r["epoch"] for r in log] == [0, 1]
    assert out["epochs_run"] == 3
    losses = [r["val_loss"] for r in log]
    assert all(np.isfinite(losses)) and losses[1] > losses[0]
    assert all(0.0 <= r["val_acc1"] <= r["val_acc5"] <= 1.0 for r in log)
    assert out["best_val_loss"] == losses[0]
    assert int(out["state"].extra["queue_ptr"]) == (6 * 3 * 4) % 16
    assert os.path.isfile(out["encoder"])


def test_cli_moco_trains_with_views(tmp_path, small_widths):
    """The MoCo views (24^2 crops of 32^2 images) and a moving encoder: the
    validation metrics are logged each epoch and the key encoder is no
    longer the online one."""
    out = _run(tmp_path, "v", "moco", [
        "data.synthetic_n=40", "task.num_negatives=16",
        "task.view_size=24", "optim.name=sgd", "optim.lr=0.05",
        "train.patience=5", "train.epochs=2"])
    log = _epochs(out["ckpt_dir"])
    assert [r["epoch"] for r in log] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"])
               for r in log)
    state = out["state"]
    assert any(not torch.equal(k, p) for k, p in zip(
        state.extra["key_model"].parameters(), state.model.parameters()))


def test_spark_validation_keeps_bn_running_stats():
    from cmx_torch.cli.pretrain import replay_val_loss
    from cmx_torch.ssl.spark import make_spark_task

    model = _port_spark(6)
    task, _ = make_spark_task(model, augment=False, input_size=32)
    state = _state(model)
    model.eval()  # the function sets train mode itself
    before = {n: b.clone() for n, b in model.named_buffers()}
    imgs = torch.from_numpy(np.random.default_rng(2).normal(
        size=(4, 32, 32)).astype(np.float32))
    loss = replay_val_loss(task, state, imgs, torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n
    # the loss is the train-mode forward's: the same draws give the same loss
    model.train()
    with torch.no_grad():
        ref, _ = task.loss_fn(model, imgs, torch.Generator().manual_seed(0))
    assert float(loss) == float(ref)
    with pytest.raises(AssertionError):  # that forward did move the stats
        for n, b in model.named_buffers():
            assert torch.equal(b, before[n]), n
