"""The evaluate slice against cmx on the CPU: the probe's labels, features
and training (cmx's split, inits and dropout masks injected),
spark_reconstruct, apis.inference_model, the evaluate CLI (--probe, --vis;
cmx's encoder.npz), and the pretrain CLI's TensorBoard scalars against its
log.jsonl. Weights cross with cmx_torch.ckpt.checkpoint (to_flax /
from_flax); inputs come from numpy seeds. Tolerances are stated in each
test.
"""

import functools
import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cmx_torch.ckpt.checkpoint import from_flax, to_flax

WIDTHS = (8, 16, 32, 64)
BNECK = 128
CLI_DATA = ["data.synthetic=True", "data.synthetic_n=12", "data.image_size=32",
            "model.dtype=float32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the cores among its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-12)


def _perturb_buffers(model, seed):
    """Running statistics away from (0, 1), so that eval-mode BN matters."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, b in model.named_buffers():
            noise = torch.rand(b.shape, generator=g)
            b.copy_(0.5 + noise if name.endswith("var") else noise - 0.5)
    return model


@pytest.fixture
def small_widths(monkeypatch):
    """The CLIs' models at reduced widths."""
    import cmx_torch.models.unet as unet
    import cmx_torch.ssl.spark as spark

    monkeypatch.setattr(spark, "SparKModel", functools.partial(
        spark.SparKModel, widths=WIDTHS, bottleneck_width=BNECK))
    monkeypatch.setattr(unet, "UNetEncoderGAP", functools.partial(
        unet.UNetEncoderGAP, widths=WIDTHS, bottleneck=BNECK))
    monkeypatch.setattr(unet, "UNet", functools.partial(
        unet.UNet, widths=WIDTHS, bottleneck=BNECK))


# ------------------------------------------------------------------ probe


@pytest.mark.parametrize("n,buckets,layout", [
    (12, 4, "onehot"), (7, 3, "onehot"), (20, 5, "onehot"), (9, 4, "plain")])
def test_fg_fraction_labels_equal_cmx(n, buckets, layout):
    """Bit for bit: the port's one-hot masks are (N, C, H, W), cmx's
    (N, H, W, C); a plain (N, H, W) mask is read as it is in both."""
    from cmx.ssl.linear_probe import fg_fraction_labels as jlabels
    from cmx_torch.ssl.linear_probe import fg_fraction_labels

    rng = np.random.default_rng(n)
    fg = rng.random((n, 24, 24)) < rng.random((n, 1, 1)) * 0.5
    if layout == "plain":
        masks = fg.astype(np.float32)
        ours = fg_fraction_labels(masks, buckets)
    else:
        masks = np.stack([~fg, fg], -1).astype(np.float32)
        ours = fg_fraction_labels(masks.transpose(0, 3, 1, 2), buckets)
    ref = jlabels(masks, buckets)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


def cmx_probe_draws(seed, d, hidden, n_train, steps, dropout):
    """cmx's probe draws: split(key(seed)) -> the MLP's two normal inits;
    step i: split(fold_in(key(seed), i), 2) -> the two dropout keep masks
    (bernoulli(1 - p) over (n_train, d) and (n_train, hidden))."""
    k_init = jax.random.key(seed)
    draws = {}
    width = hidden or 1
    if hidden:
        k1, k2 = jax.random.split(k_init)
        draws["w_hidden"] = np.array(jax.random.normal(k1, (d, hidden)))
        draws["w_out"] = np.array(jax.random.normal(k2, (hidden, 4)))

    def keeps(i):
        k0, k1 = jax.random.split(jax.random.fold_in(k_init, i), 2)
        return (jax.random.bernoulli(k0, 1.0 - dropout, (n_train, d)),
                jax.random.bernoulli(k1, 1.0 - dropout, (n_train, width)))

    k0, k1 = jax.jit(jax.vmap(keeps))(jnp.arange(steps))
    draws["keep0"] = torch.from_numpy(np.array(k0))
    if hidden:
        draws["keep1"] = torch.from_numpy(np.array(k1))
    return draws


@pytest.mark.parametrize("hidden", [None, 16], ids=["linear", "mlp16"])
def test_probe_matches_cmx(hidden):
    """probe() with cmx's split (numpy's permutation: the same indices),
    inits and dropout masks injected, 500 full-batch Adam steps: train and
    test accuracy equal, the last step's loss within 1e-5 relative."""
    from cmx.ssl.linear_probe import probe as jprobe
    from cmx_torch.ssl.linear_probe import probe

    rng = np.random.default_rng(4)
    n, d = 48, 16
    feats = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    labels[:4] = np.arange(4)  # every class present: 4 classes both ways
    ref = jprobe(feats, labels, hidden_dim=hidden)
    n_train = n - max(1, int(n * 0.25))
    draws = cmx_probe_draws(0, d, hidden, n_train, 500, 0.1)
    got = probe(torch.from_numpy(feats), labels, hidden_dim=hidden,
                draws=draws)
    assert got["train_acc"] == ref["train_acc"]
    assert got["test_acc"] == ref["test_acc"]
    assert abs(got["final_loss"] - ref["final_loss"]) \
        <= 1e-5 * abs(ref["final_loss"]), (got, ref)
    # without injected draws it draws its own, and still trains
    own = probe(feats, labels, hidden_dim=hidden, steps=50)
    assert 0.0 <= own["test_acc"] <= 1.0 and np.isfinite(own["final_loss"])


def test_extract_features_matches_cmx():
    """The eval-mode GAP encoder at full width, fp32, 7 images in batches
    of 4 (the last padded with copies of its first image): within 1e-5 of
    cmx's, relative to the largest feature (summation order of XLA's and
    torch's CPU convs)."""
    from cmx.models.unet import UNetEncoderGAP as JGAP
    from cmx.ssl.linear_probe import extract_features as jextract
    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.linear_probe import extract_features

    gap = UNetEncoderGAP(dtype=torch.float32)
    gap.reset_parameters(torch.Generator().manual_seed(1))
    _perturb_buffers(gap, 1)
    tree = to_flax(gap)
    imgs = np.random.default_rng(5).normal(size=(7, 32, 32)).astype(
        np.float32)
    ref = jextract(tree["params"], tree["batch_stats"], imgs, batch=4,
                   model=JGAP(dtype=jnp.float32))
    got = extract_features(gap, imgs, batch=4)
    assert got.shape == ref.shape == (7, 1024)
    assert _rel(got.numpy(), ref) <= 1e-5


# ------------------------------------------------------ reconstruct, apis


def test_spark_reconstruct_matches_cmx():
    """The triplet (input, masked input, reconstruction-or-input) of a
    reduced-width SparKModel in fp32, its running statistics perturbed:
    each within 1e-5 of cmx's, relative to its largest entry; the model's
    training mode is put back."""
    from cmx.ssl.spark import SparKModel as JSparK, spark_reconstruct as jrec
    from cmx_torch.ops.masking import spark_active_mask
    from cmx_torch.ssl.spark import SparKModel, spark_reconstruct

    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK,
                       dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(2))
    _perturb_buffers(model, 2)
    tree = to_flax(model)
    imgs = np.random.default_rng(6).normal(size=(3, 64, 64)).astype(
        np.float32)
    active = spark_active_mask(torch.Generator().manual_seed(0), 3, 4, 0.6)
    model.train()
    got = spark_reconstruct(model, torch.from_numpy(imgs), active)
    assert model.training
    ref = jrec(JSparK(widths=WIDTHS, bottleneck_width=BNECK,
                      dtype=jnp.float32), tree["params"],
               tree["batch_stats"], jnp.asarray(imgs),
               jnp.asarray(active.numpy()))
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), np.asarray(r)) <= 1e-5
    # masked patches take the reconstruction, visible ones the input
    pix = active.repeat_interleave(16, 1).repeat_interleave(16, 2) > 0
    assert torch.equal(got[2][pix], got[0][pix])
    assert not torch.equal(got[2][~pix], got[0][~pix])


class SmallUNet(fnn.Module):
    """cmx's UNet at reduced widths in eval mode (two classes)."""

    dtype: Any = jnp.float32

    @fnn.compact
    def __call__(self, x):
        from cmx.models.unet import UNetDecoder, UNetEncoder

        h, skips = UNetEncoder(widths=WIDTHS, bottleneck=BNECK,
                               dtype=self.dtype, use_running_average=True,
                               name="encoder")(x)
        return UNetDecoder(out_classes=2, widths=WIDTHS, dtype=self.dtype,
                           use_running_average=True, name="decoder")(h, skips)


@pytest.mark.parametrize("shape", [(2, 24, 24), (2, 48, 40), (48, 48)],
                         ids=["upscale", "downscale", "single"])
def test_inference_model_matches_cmx(shape):
    """Cubic resize (Keys a = -0.5, antialias) to 32^2, the eval-mode
    forward and the softmax of a reduced-width UNet in fp32: within 1e-5 of
    cmx's probabilities, in cmx's class-last layout; they sum to 1."""
    from cmx.apis import inference_model as jinfer
    from cmx_torch.apis import inference_model
    from cmx_torch.models.unet import UNet

    model = UNet(out_classes=2, widths=WIDTHS, bottleneck=BNECK,
                 dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(3))
    _perturb_buffers(model, 3)
    image = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    ref = jinfer(SmallUNet(), to_flax(model), image, size=32)
    got = inference_model(model, image, size=32)
    assert got.shape == ref.shape == shape[:-2] + (32, 32, 2)
    assert np.abs(got - ref).max() <= 1e-5
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_init_model_loads_an_encoder(tmp_path):
    """init_model: an eval-mode UNet on the asked device, seeded decoder,
    the encoder of an encoder.npz loaded over it; the card by default."""
    from cmx_torch.apis import init_model
    from cmx_torch.ckpt.checkpoint import export_encoder
    from cmx_torch.train.state import TrainState

    src = init_model(seed=4, dtype=torch.float32, device="cpu")
    _perturb_buffers(src, 4)
    path = str(tmp_path / "encoder.npz")
    export_encoder(TrainState.create(model=src, tx=None), path)
    model = init_model(path, seed=5, dtype=torch.float32, device="cpu")
    again = init_model(seed=5, dtype=torch.float32, device="cpu")
    assert not model.training
    for (n, a), b in zip(model.state_dict().items(),
                         src.state_dict().values()):
        if n.startswith("encoder."):
            assert torch.equal(a, b), n
    for (n, a), b in zip(model.decoder.state_dict().items(),
                         again.decoder.state_dict().values()):
        assert torch.equal(a, b), n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_model()


# ------------------------------------------------------------- the CLIs


def _pretrain(tmp_path, args):
    from cmx_torch.cli.pretrain import main

    return main(["--device", "cpu", "--task", "spark", "train.batch_size=4",
                 "task.augment=False", f"data.data_dir={tmp_path / 'data'}",
                 f"train.ckpt_dir={tmp_path / 'ckpt'}"] + CLI_DATA + args)


def test_evaluate_cli_probe_and_vis(tmp_path, small_widths, capsys):
    """`cmx_torch.cli.evaluate` on the CPU with --probe 16 and --vis, from a
    port pretrain run (as tests/test_cli_e2e.py drives cmx's): finite test
    metrics, probe accuracies in [0, 1], the reconstruction file written,
    the JSON printed with 4-decimal rounding."""
    from cmx_torch.cli.evaluate import main

    run = _pretrain(tmp_path, ["train.epochs=1"])
    metrics = main(["--device", "cpu", "--encoder", run["encoder"],
                    "--probe", "16", "--vis", run["ckpt_dir"],
                    f"data.data_dir={tmp_path / 'data'}", "data.ratio=0.3"]
                   + CLI_DATA)
    out = capsys.readouterr().out
    printed = json.loads(out[out.index("{"):])
    assert set(printed) == set(metrics)
    for k, v in metrics.items():
        if k == "vis_path":
            assert printed[k] == v and os.path.isfile(v)
            continue
        assert np.isfinite(v) and printed[k] == round(float(v), 4), k
    assert 0.0 <= metrics["probe_train_acc"] <= 1.0
    assert 0.0 <= metrics["probe_test_acc"] <= 1.0
    assert {"dice_loss", "hausdorff", "radius_arteries"} <= set(metrics)


def test_evaluate_cli_on_cmx_encoder(tmp_path, small_widths):
    """cmx's encoder.npz (its export of a SparK state) through the port's
    evaluate CLI: the test metrics equal harness.evaluate on a UNet built by
    from_flax from cmx's load_encoder of the same file. The UNet's other
    weights are random in each package, so the CLI's are injected: its
    reset_parameters loads the tree cmx's load_encoder started from."""
    import optax

    import cmx_torch.models.unet as unet
    from cmx.ckpt.checkpoint import export_encoder as jexport
    from cmx.ckpt.checkpoint import load_encoder as jload
    from cmx.train.state import TrainState as JState
    from cmx_torch.cli.evaluate import main
    from cmx_torch.config.config import Config
    from cmx_torch.data.corpus import load_corpus
    from cmx_torch.data.splits import list_corpus, make_splits
    from cmx_torch.ssl.spark import SparKModel
    from cmx_torch.train.harness import evaluate, upload_set
    from cmx_torch.train.supervised import make_eval_fn

    spark = SparKModel(dtype=torch.float32)  # reduced widths (fixture)
    spark.reset_parameters(torch.Generator().manual_seed(8))
    stree = _np_tree(to_flax(_perturb_buffers(spark, 8)))
    path = str(tmp_path / "cmx_encoder.npz")
    jexport(JState.create(params=stree["params"],
                          batch_stats=stree["batch_stats"],
                          tx=optax.sgd(0.1)), path)
    base = unet.UNet(out_classes=2, dtype=torch.float32)
    base.reset_parameters(torch.Generator().manual_seed(9))
    utree = _np_tree(to_flax(_perturb_buffers(base, 9)))
    unet_cls = type(base)
    orig_reset = unet_cls.reset_parameters
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(unet_cls, "reset_parameters",
                   lambda self, gen: from_flax(self, utree))
        got = main(["--device", "cpu", "--encoder", path,
                    f"data.data_dir={tmp_path / 'data'}"] + CLI_DATA)
    assert unet_cls.reset_parameters is orig_reset

    params, bs = jload(path, utree["params"], utree["batch_stats"])
    ref_model = from_flax(unet.UNet(out_classes=2, dtype=torch.float32),
                          {"params": params, "batch_stats": bs})
    xs, ys = list_corpus(str(tmp_path / "data"))
    splits = make_splits(xs, ys, ratio=Config().data.ratio)
    te = load_corpus(splits.test_x, splits.test_y, size=32)
    ref = evaluate(make_eval_fn(ref_model), *upload_set(*te, "cpu"))
    assert got == ref
    assert not np.array_equal(params["encoder"]["down1"]["double_conv"]
                              ["conv0"]["kernel"],
                              utree["params"]["encoder"]["down1"]
                              ["double_conv"]["conv0"]["kernel"])


def test_evaluate_cli_device_defaults_to_cuda(tmp_path):
    from cmx_torch.cli.evaluate import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([f"data.data_dir={tmp_path / 'data'}"] + CLI_DATA)
    assert not os.path.exists(tmp_path / "data")


def test_pretrain_tensorboard_scalars_equal_log_jsonl(tmp_path, small_widths):
    """train.tensorboard=True: the pretrain CLI writes <ckpt>/tb events
    whose scalars, read back with tensorboard's EventAccumulator, are each
    epoch's log.jsonl metrics (as float32, the events' precision), at the
    epoch as step; validation included."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    out = _pretrain(tmp_path, ["train.epochs=2", "train.tensorboard=True",
                               "train.patience=5", "data.synthetic_n=16"])
    assert out["tensorboard"] and out["val_batches"] > 0
    with open(os.path.join(out["ckpt_dir"], "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    acc = EventAccumulator(os.path.join(out["ckpt_dir"], "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert tags == {"recon", "loss", "grad_norm", "nonfinite", "val_loss"}
    for tag in tags:
        events = acc.Scalars(tag)
        assert [e.step for e in events] == [r["epoch"] for r in log]
        assert [e.value for e in events] == [
            float(np.float32(r[tag])) for r in log], tag
