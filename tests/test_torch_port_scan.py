"""`train.scan` in the port: the train step split into a body and the
host's bookkeeping, the run's one re-seeded generator, and
cmx_torch.train.graph.StepGraph, held on the CPU (where every step runs
eagerly; the card tests in test_torch_port_cuda.py hold the captured graph
against these eager steps).

* A generator re-seeded with `TrainState.step_seed()` draws what a fresh
  `step_generator` draws, bit for bit, at any step and after any number of
  draws in earlier steps.
* The split step (StepGraph's eager path: the gather, the body with the
  run's re-seeded generator, then the step counter) equals the step as it
  was before the split (`_unsplit_step`, its code kept here) bit for bit:
  every parameter, BN buffer, optimizer state, `extra` tensor and metric,
  for SparK (fused flat through K1/K2's and K3's plain versions, bf16),
  MAE, Genesis, MoCo and CM-UNet at reduced widths.
* `make_device_feed(...).scan_run` over segments of 2 and 1 steps equals
  the per-step loop bit for bit (the port's counterpart of cmx's
  tests/test_pretrain_scan.py, which is marked slow); its `fetch` is cmx's
  row gather.
* The pretrain CLI with train.scan=True and train.scan=False writes the
  same encoder.npz and log.jsonl.
* A failed capture names the operation of the port where it broke.
"""

import copy
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmx_torch.ops import fused_conv as tfc
from cmx_torch.train.graph import StepGraph, _culprit, launch_counts
from cmx_torch.train.state import TrainState
from cmx_torch.train.trainer import (extra_buffers, make_train_body,
                                     make_train_step)

WIDTHS, BNECK = (8, 16, 32, 64), 128


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this module's torch work (the tier-1 run
    shares the cores among its workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unsplit_step(task, tx):
    """The train step as it was before the body was split from the host's
    bookkeeping (a fresh generator from (seed, step), the body inline)."""
    from cmx_torch.parallel import mesh
    from cmx_torch.train.optim import global_grad_norm

    def step(state, batch, draws=None):
        model = state.model
        model.train()
        lead = batch[0] if isinstance(batch, (tuple, list)) else batch
        gen = state.step_generator(lead.device)
        buffers = list(model.buffers()) + extra_buffers(state.extra)
        old_buffers = [b.clone() for b in buffers]
        params = tx.params
        loss, aux = task.loss_fn(model, batch, gen, draws, state.extra)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = mesh.all_reduce_tensors(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)])
        gnorm = global_grad_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        tx.step(grads, finite)
        with torch.no_grad():
            for b, old in zip(buffers, old_buffers):
                b.copy_(torch.where(finite, b, old))
            if task.post_update is not None:
                for target, new in task.post_update(state, aux):
                    target.copy_(torch.where(finite, new, target))
        state.step += 1
        metrics = dict(aux.metrics)
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = gnorm
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    return step


def _tensors(state):
    out = {f"model/{n}": t for n, t in state.model.state_dict().items()}
    for k, v in state.opt.state_dict().items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            out[f"opt/{k}/{i}"] = t
    for k, v in (state.extra or {}).items():
        if isinstance(v, torch.nn.Module):
            out.update({f"extra/{k}/{n}": t
                        for n, t in v.state_dict().items()})
        else:
            out[f"extra/{k}"] = v
    return out


def _assert_states_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert list(ta) == list(tb)
    for n, t in ta.items():
        assert torch.equal(t, tb[n]), n
    assert a.step == b.step


def _imgs(n, size, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(n, size, size)).astype(
        np.float32) + 1.0)


def _spark(fused=True):
    """SparK at reduced widths: fused bf16 at 64^2 (K1-K3's plain
    versions), or the plain fp32 model at 32^2."""
    from cmx_torch.ssl.spark import SparKModel, make_spark_task
    from cmx_torch.train.optim import make_optimizer

    size = 64 if fused else 32
    model = SparKModel(widths=WIDTHS, bottleneck_width=BNECK, fused=fused,
                       dtype=torch.bfloat16 if fused else torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(0))
    task, _ = make_spark_task(model, input_size=size, pallas_loss=fused)
    tx = make_optimizer("lamb", 2e-4, 0.04, clip_norm=5.0,
                        named_params=model.named_parameters())
    return TrainState.create(model=model, tx=tx, seed=3), task, tx, \
        _imgs(4, size)


def _unet_task(kind):
    from cmx_torch.models.unet import UNet
    from cmx_torch.ssl.reconstruction import make_genesis_task, make_mae_task
    from cmx_torch.train.optim import make_optimizer

    model = UNet(out_classes=1, widths=WIDTHS, bottleneck=BNECK,
                 dtype=torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(1))
    make = make_mae_task if kind == "mae" else make_genesis_task
    task, _ = make(model)
    tx = make_optimizer("sgd", 1e-2, named_params=model.named_parameters())
    return TrainState.create(model=model, tx=tx, seed=5), task, tx, \
        _imgs(4, 64, 1)


def _moco():
    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.moco import make_moco_task
    from cmx_torch.train.optim import make_optimizer

    model = UNetEncoderGAP(WIDTHS, BNECK, torch.float32)
    model.reset_parameters(torch.Generator().manual_seed(2))
    task, _ = make_moco_task(model, num_negatives=8, view_size=24)
    tx = make_optimizer("sgd", 0.03, 1e-4,
                        named_params=model.named_parameters())
    extra = task.init_extra(torch.Generator().manual_seed(3))
    return TrainState.create(model=model, tx=tx, seed=7, extra=extra), \
        task, tx, _imgs(4, 32, 2)


def _cmunet(monkeypatch):
    import cmx_torch.ssl.cmunet as cm
    from cmx_torch.models.unet import UNetDecoder, UNetEncoder
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.schedules import warmup_cosine

    # narrow encoder and decoders; the bottleneck keeps its 1024 channels
    # (the fixed reduce kernel's input)
    monkeypatch.setattr(cm, "UNetEncoder", functools.partial(
        UNetEncoder, WIDTHS))
    monkeypatch.setattr(cm, "UNetDecoder", functools.partial(
        UNetDecoder, widths=WIDTHS))
    model = cm.CMUNetOnline(torch.float32, 32)
    model.reset_parameters(torch.Generator().manual_seed(4))
    task, _ = cm.make_cmunet_task(model, view_size=32)
    tx = make_optimizer("adamw", warmup_cosine(1e-3, 10, 1), 0.05,
                        clip_norm=5.0, named_params=model.named_parameters())
    extra = task.init_extra(torch.Generator().manual_seed(5))
    return TrainState.create(model=model, tx=tx, seed=9, extra=extra), \
        task, tx, _imgs(4, 64, 3)


TASKS = {"spark": lambda mp: _spark(), "mae": lambda mp: _unet_task("mae"),
         "genesis": lambda mp: _unet_task("genesis"),
         "moco": lambda mp: _moco(), "cmunet": _cmunet}


@pytest.mark.parametrize("step,earlier", [(0, 0), (1, 17), (123456, 5000)])
def test_reseeded_generator_draws_what_a_fresh_one_draws(step, earlier):
    state = TrainState(step=0, model=None, opt=None, seed=2024)
    gen = torch.Generator()
    gen.manual_seed(state.step_seed())
    torch.rand((earlier,), generator=gen)  # an earlier step's draws
    torch.randn((earlier // 2 + 1,), generator=gen)
    state.step = step
    gen.manual_seed(state.step_seed())
    fresh = state.step_generator("cpu")
    for draw in (lambda g: torch.rand((33,), generator=g),
                 lambda g: torch.randn((7, 5), generator=g),
                 lambda g: torch.randint(0, 9, (11,), generator=g),
                 lambda g: torch.randperm(13, generator=g),
                 lambda g: torch.randn((3,), generator=g)):
        assert torch.equal(draw(gen), draw(fresh))


@pytest.mark.parametrize("task", sorted(TASKS))
def test_split_step_equals_the_unsplit_step(task, monkeypatch):
    monkeypatch.setattr(tfc, "FUSED_MIN_HW", 32)  # SparK: 64^2, 32^2 fuse
    a, t, tx_a, corpus = TASKS[task](monkeypatch)
    b = copy.deepcopy(a)  # its optimizer holds its own parameters
    old = _unsplit_step(t, tx_a)
    graph = StepGraph(make_train_body(t, b.opt),
                      lambda idx: corpus.index_select(0, idx), "cpu")
    idxs = [torch.tensor([2, 0, 3, 1]), torch.tensor([1, 1, 0, 2])]
    rows_a, rows_b = [], []
    for idx in idxs:
        m = old(a, corpus.index_select(0, idx))
        rows_a.append(torch.stack([m[k].float() for k in m]))
        rows_b.append(graph.step(b, idx))
        assert graph.names == list(m)
    assert torch.equal(torch.stack(rows_a), torch.stack(rows_b))
    assert float(torch.stack(rows_a)[:, graph.names.index("nonfinite")]
                 .sum()) == 0.0
    _assert_states_equal(a, b)
    rep = dict(graph.report)
    assert rep.pop("eager_s") > 0  # the first eager step's seconds
    assert rep == {"label": "step", "eager_steps": 2,
                   "replays": 0, "capture_calls": {},
                   "capture_collectives": {},
                   "capture_s": None, "pool_bytes": None,
                   "kernel_load_s": 0.0, "first_replay_s": None}


@pytest.mark.parametrize("task", ["spark", "moco"])
def test_scan_run_segments_equal_the_per_step_loop(task, monkeypatch):
    from cmx_torch.cli.pretrain import make_device_feed

    a, t, tx, corpus = (_spark(fused=False) if task == "spark"
                        else TASKS[task](monkeypatch))
    b = copy.deepcopy(a)
    imgs = corpus.numpy()
    corpus_dev, fetch, scan_run = make_device_feed(imgs, "cpu", t, b.opt)
    # cmx's fetch is jnp.take(corpus, idx, axis=0)
    idxs = torch.tensor([[3, 1, 0, 2], [0, 0, 1, 3], [2, 3, 3, 1]])
    assert np.array_equal(fetch(corpus_dev, idxs[1]).numpy(),
                          np.asarray(jnp.take(jnp.asarray(imgs),
                                              jnp.asarray(idxs[1].numpy()),
                                              axis=0)))
    step = make_train_step(t, tx)
    ms = [step(a, fetch(corpus_dev, idx)) for idx in idxs]
    parts = [scan_run(b, idxs[:2]), scan_run(b, idxs[2:])]
    assert [p["loss"].shape for p in parts] == [(2,), (1,)]
    for k in ms[0]:
        assert torch.equal(torch.cat([p[k] for p in parts]),
                           torch.stack([m[k].float() for m in ms])), k
    _assert_states_equal(a, b)
    assert scan_run.graph.report["eager_steps"] == 3
    assert make_device_feed(imgs, "cpu", t, b.opt, scan=False)[2] is None


@pytest.fixture
def small_widths(monkeypatch):
    import cmx_torch.ssl.spark as spark

    monkeypatch.setattr(spark, "SparKModel", functools.partial(
        spark.SparKModel, widths=WIDTHS, bottleneck_width=BNECK))


def test_cli_scan_and_eager_loop_write_the_same_run(tmp_path, small_widths):
    from cmx_torch.cli.pretrain import main

    args = ["--device", "cpu", "--task", "spark", "data.synthetic=True",
            "data.synthetic_n=16", "data.image_size=32",
            "train.batch_size=4", "model.dtype=float32", "optim.name=lamb",
            "train.epochs=2", "train.scan_budget=8",
            f"data.data_dir={tmp_path / 'data'}"]
    outs = {scan: main(args + [f"train.scan={scan}",
                               f"train.ckpt_dir={tmp_path / str(scan)}"])
            for scan in (True, False)}
    assert outs[True]["graph"]["eager_steps"] == outs[True]["state"].step > 2
    assert outs[False]["graph"] is None
    logs = {}
    for scan, out in outs.items():
        with open(os.path.join(out["ckpt_dir"], "log.jsonl")) as f:
            logs[scan] = [{k: v for k, v in json.loads(line).items()
                           if k != "time"} for line in f]
        with np.load(out["encoder"]) as z:
            logs[scan].append({k: z[k] for k in z.files})
    enc = {s: logs[s].pop() for s in logs}
    assert logs[True] == logs[False] and len(logs[True]) == 2
    assert sorted(enc[True]) == sorted(enc[False])
    for k, v in enc[True].items():
        assert np.array_equal(v, enc[False][k]), k


def test_a_failed_capture_names_the_operation():
    from cmx_torch.ops.masking import patchify

    try:
        try:
            patchify(torch.zeros(2), 4)  # not an image batch
        except ValueError:
            raise RuntimeError("the capture was invalidated")
    except RuntimeError as e:
        said = _culprit(e)
    assert "masking.py" in said and "in patchify" in said
    assert said.endswith("(ValueError: not enough values to unpack "
                         "(expected 4, got 1))")


def test_launch_counts_name_every_kernel_wrapper():
    counts = launch_counts()
    assert sorted(counts) == sorted([
        "flat_conv3x3_mask_stats", "flat_bwd_mega", "spark_loss_pallas",
        "spark_loss_bwd", "crop_resize_pallas", "bn_relu_mask_pallas",
        "conv_stem_stats", "conv3x3_mask_stats", "bwd_mega", "span_mark",
        "norm_moments", "norm_apply", "norm_grad_sums", "norm_grad_input",
        "library_conv_channels_last", "library_conv_channels_first",
        "norm_kernel_channels_last", "norm_kernel_channels_first",
        "norm_plain"])
    assert all(isinstance(v, int) for v in counts.values())
