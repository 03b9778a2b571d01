"""The harness's reading by optimizer kind and by momentum network, at a
tiny size on the CPU: a SparK cell trained by SGD with momentum follows
the reference, and SGD's trace misread fails; a momentum network is read
whatever key the task's `extra` holds it under; a queue of unit-norm keys
is drawn; an optimizer the harness cannot read gives no result."""

import io
import types

import pytest
import torch

from perfbench import harness, weights
from perfbench.cells import load_cell
from perfbench.tests import tiny

SEED = 2 ** 31 + 4321  # more than 32 signed bits hold
SGD = {"optim.name": "sgd", "optim.momentum": 0.9}


@pytest.fixture
def root(tmp_path, monkeypatch):
    torch.set_num_threads(4)
    tiny.patch_spark_widths(monkeypatch)
    root = tiny.make_root(str(tmp_path))
    for wd in (1e-4, 0.1):
        tiny.add_cell(root, f"spark-tiny-sgd-{wd:g}", "spark-tiny",
                      dict(SGD, **{"optim.weight_decay": wd}))
    tiny.add_cell(root, "spark-tiny-lars", "spark-tiny",
                  {"optim.name": "lars", "optim.momentum": 0.9})
    return root


def _run(root, name, seconds=0.3):
    err = io.StringIO()
    line = harness.run(name, SEED, seconds, False, device="cpu", root=root,
                       err=err)
    return line, err.getvalue()


@pytest.mark.parametrize("wd", [1e-4, 0.1])
def test_an_sgd_cell_follows_the_reference(root, wd):
    """Under the tiny SparK cell's limits; at wd 0.1 the decay term is
    well above the gradients, so only a reading that takes it out holds."""
    line, _ = _run(root, f"spark-tiny-sgd-{wd:g}")
    assert line is not None and line["correct"], line and line["checks"]
    limits = load_cell("spark-tiny", root)["workload"]["limits"]
    assert set(limits) < set(line["checks"])


def _adam_on_trace(tx, now, prev, before):
    """Adam's formula read off SGD's trace, with b1 the momentum."""
    b1 = tx.momentum
    return [(t if prev is None else t - b1 * prev[j]) / (1 - b1)
            for j, t in enumerate(now)]


def _decay_left_in(tx, now, prev, before):
    """The trace less the momentum, the decay term wd p left in."""
    return [t if prev is None else t - tx.momentum * prev[j]
            for j, t in enumerate(now)]


@pytest.mark.parametrize("misread,wd", [
    (_adam_on_trace, 1e-4),
    # wd 0.1: the term wd p left in then reads 16 times a kernel's
    # gradient at the worst leaf; at wd 1e-4 it reads 3e-4, under the
    # tiny cell's limits, and the misreading could not show
    (_decay_left_in, 0.1)])
def test_a_misread_sgd_trace_is_not_correct(root, monkeypatch, misread, wd):
    state, before, _ = harness.READERS["sgd"]
    monkeypatch.setitem(harness.READERS, "sgd", (state, before, misread))
    line, _ = _run(root, f"spark-tiny-sgd-{wd:g}")
    assert line is not None and not line["correct"], line["checks"]


def _target_as_key_model(monkeypatch):
    """CM-UNet's target held in `extra` under "key_model", as MoCo holds
    its key encoder; the task's own functions see it under its own key."""
    import cmx_torch.cli.pretrain as pretrain

    real = pretrain.build_task

    def back(extra):
        return {("target_model" if k == "key_model" else k): v
                for k, v in extra.items()}

    def build(*args, **kwargs):
        task, model = real(*args, **kwargs)
        init, loss_fn, post = task.init_extra, task.loss_fn, task.post_update

        def init_extra(gen):
            return {("key_model" if k == "target_model" else k): v
                    for k, v in init(gen).items()}

        def loss(model, imgs, gen, draws=None, extra=None):
            return loss_fn(model, imgs, gen, draws, back(extra))

        def post_update(state, aux):
            return post(types.SimpleNamespace(model=state.model,
                                              extra=back(state.extra)), aux)

        task.init_extra, task.loss_fn = init_extra, loss
        task.post_update = post_update
        return task, model

    monkeypatch.setattr(pretrain, "build_task", build)


def test_the_momentum_network_is_read_under_any_key(root, monkeypatch):
    as_target, _ = _run(root, "cmunet-tiny")
    _target_as_key_model(monkeypatch)
    as_key, _ = _run(root, "cmunet-tiny")
    assert as_key["correct"], as_key["checks"]
    for k in ("stats_gap", "target_gap"):
        assert as_key["checks"][k] == as_target["checks"][k], k


def test_two_modules_in_extra_are_refused():
    net = torch.nn.Linear(2, 2)
    assert harness.momentum_net({"key_model": net, "queue": torch.ones(2)}) \
        is net
    assert harness.momentum_net({"queue": torch.ones(2)}) is None
    with pytest.raises(harness.Refused, match="2 modules"):
        harness.momentum_net({"a": net, "b": torch.nn.Linear(2, 2)})


def test_an_optimizer_the_harness_cannot_read_gives_no_result(root):
    line, err = _run(root, "spark-tiny-lars")
    assert line is None
    assert "'lars'" in err


def _drawn_as_before(spec, seed):
    """The drawn entries as the weights were made before unit rows: one
    flat normal draw in the spec's order, scaled, "trunc" clamped at two
    deviations."""
    drawn = [(n, s, i) for n, s, i in spec if isinstance(i, tuple)]
    sizes = [int(torch.Size(s).numel()) for _, s, _ in drawn]
    flat = torch.randn(sum(sizes), generator=weights.generator(
        "cpu", seed, 2))
    out = {}
    for (name, shape, (kind, std)), part in zip(drawn, flat.split(sizes)):
        part = part * torch.tensor(std)
        if kind == "trunc":
            part = part.clamp(-2.0 * std, 2.0 * std)
        out[name] = part.view(shape)
    return out


@pytest.mark.parametrize("name", ["spark-tiny", "cmunet-tiny"])
def test_existing_specs_draw_as_before(root, name):
    from perfbench.cells import reference_module

    conf = load_cell(name, root)["config"]
    ref = reference_module(conf["task"])
    spec = sum(ref.param_spec(conf), []) + ref.extra_spec(conf)
    made = weights.make_weights(spec, SEED, "cpu")
    before = _drawn_as_before(spec, SEED)
    assert before
    for k, v in before.items():
        assert torch.equal(made[k], v), k


def test_unit_rows_have_norm_one():
    spec = [("bias", (3,), "zeros"), ("kernel", (4, 5), ("trunc", 0.1)),
            ("queue", (64, 32), ("unit_rows",)),
            ("head", (5,), ("normal", 0.02))]
    made = weights.make_weights(spec, SEED, "cpu")
    norms = torch.linalg.vector_norm(made["queue"], dim=-1)
    assert torch.allclose(norms, torch.ones(64), rtol=0, atol=1e-6)
    # the rows are drawn, not one row repeated
    assert torch.unique(made["queue"][:, 0]).numel() == 64
    # the entries beside the queue are drawn from the same flat draw
    flat = torch.randn(20 + 64 * 32 + 5, generator=weights.generator(
        "cpu", SEED, 2))
    assert torch.equal(made["head"], flat[-5:] * torch.tensor(0.02))
    with pytest.raises(ValueError, match="unknown init"):
        weights.make_weights([("x", (2,), ("uniform", 1.0))], SEED, "cpu")
