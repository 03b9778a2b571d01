"""The reference against the port at a tiny size on the CPU, and the
comparison failing on the faults a train step can have and on the
control (the reference in float8 in the program's place)."""

import pytest
import torch

from perfbench import check, harness
from perfbench.cells import load_cell
from perfbench.tests import tiny

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


@pytest.fixture
def root(tmp_path, monkeypatch):
    torch.set_num_threads(4)
    tiny.patch_spark_widths(monkeypatch)
    return tiny.make_root(str(tmp_path))


def _run(root, name, seconds=0.3):
    line = harness.run(name, SEED, seconds, False, device="cpu", root=root)
    assert line is not None
    return line


@pytest.mark.parametrize("name", ["spark-tiny", "cmunet-tiny"])
def test_reference_follows_the_program(root, name):
    line = _run(root, name)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"img_per_s", "setup_s"}


def test_eager_runner_is_correct_too(tmp_path, monkeypatch):
    torch.set_num_threads(4)
    tiny.patch_spark_widths(monkeypatch)
    root = tiny.make_root(str(tmp_path), runner="eager")
    assert _run(root, "spark-tiny")["correct"]


def _unchanged(monkeypatch):
    """Plant a step that returns its state unchanged: the body runs, then
    every parameter, buffer, optimizer tensor and `extra` tensor is put
    back."""
    import cmx_torch.train.trainer as trainer

    real = trainer.make_train_body

    def make(task, tx):
        body = real(task, tx)

        def frozen(state, batch, gen, draws=None):
            tensors = (list(state.model.parameters())
                       + list(state.model.buffers())
                       + [t for v in tx.state_dict().values()
                          for t in (v if isinstance(v, list) else [v])]
                       + trainer.extra_buffers(state.extra)
                       + [p for v in (state.extra or {}).values()
                          if isinstance(v, torch.nn.Module)
                          for p in v.parameters()])
            saved = [t.detach().clone() for t in tensors]
            out = body(state, batch, gen, draws)
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            return out

        return frozen

    monkeypatch.setattr(trainer, "make_train_body", make)


def _half_batch(monkeypatch):
    """Plant a step that leaves out half of its batch and takes the mean
    over the rest."""
    import cmx_torch.cli.pretrain as pretrain

    real = pretrain.build_task

    def build(*args, **kwargs):
        task, model = real(*args, **kwargs)
        loss_fn = task.loss_fn

        def half(model, imgs, gen, draws=None, extra=None):
            return loss_fn(model, imgs[: imgs.shape[0] // 2], gen, draws, extra)

        task.loss_fn = half
        return task, model

    monkeypatch.setattr(pretrain, "build_task", build)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
@pytest.mark.parametrize("name", ["spark-tiny", "cmunet-tiny"])
def test_a_broken_step_is_not_correct(root, monkeypatch, name, fault):
    fault(monkeypatch)
    line = _run(root, name)
    assert not line["correct"], line["checks"]


def test_an_unchanged_state_reads_one(root, monkeypatch):
    _unchanged(monkeypatch)
    checks = _run(root, "spark-tiny")["checks"]
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("task,cells", [
    ("spark", ["spark-b128-fused", "spark-b128-unfused"]),
    ("cmunet", ["cmunet-b128"])])
def test_the_control_fails_the_cells_limits(root, task, cells):
    """The reference in float8 in the program's place fails at least one of
    each cell's limits (here at the tiny size; PERF.md gives its readings
    on the card at each cell's own size)."""
    cell = load_cell(f"{task}-tiny", root)
    prog = harness.Program(cell, SEED, "cpu")
    batches = [prog.batch_of(i) for i in range(harness.WARM_STEPS)]
    ref = check.follow(cell["config"], prog.init, batches, SEED, "cpu")
    ctrl = check.follow(cell["config"], prog.init, batches, SEED, "cpu",
                        precision="fp8")
    numbers = check.compare(ctrl, ref)
    for name in cells:
        limits = load_cell(name)["workload"]["limits"]
        assert not check.judge(numbers, limits), (name, numbers, limits)
