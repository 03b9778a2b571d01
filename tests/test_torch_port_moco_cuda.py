"""MoCo v2's step captured as a CUDA graph with the program's spans on, on
the card: its replays run the `momentum` span's markers, paired, as the
benchmark reads them (perfbench/spans.py), and K4 twice a step. It skips,
with a reason, without a CUDA device (decided inside the fixture). On a
machine with the card:

    python -m pytest tests/test_torch_port_moco_cuda.py --noconftest -q
"""

import pytest
import torch


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 and the span markers run only "
                    "there")
    from cmx_torch import resolve_device

    return resolve_device("cuda")


def test_graph_replays_the_momentum_span_and_two_crops_a_step(
        dev, tmp_path, monkeypatch):
    """MoCo at full width in bf16, 80^2 images cut to 64^2 views through K4,
    batch 8, a queue of 64, SGD: the captured step holds two K4 launches
    and the span markers; two profiled replays split by span with the
    `momentum` span's kernels (the key encoder's convolutions) inside it,
    and the views and the contrast in theirs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from cmx_torch.models.unet import UNetEncoderGAP
    from cmx_torch.ssl.moco import make_moco_task
    from cmx_torch.train.graph import StepGraph
    from cmx_torch.train.optim import make_optimizer
    from cmx_torch.train.state import TrainState
    from cmx_torch.train.trainer import make_train_step
    from cmx_torch.utils import profiling
    from perfbench import spans
    from perfbench.devtrace import WINDOW, Trace

    monkeypatch.setattr(profiling, "_spans_on", True)
    model = UNetEncoderGAP(dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev)
    task, _ = make_moco_task(model, num_negatives=64, view_size=64,
                             crop_impl="pallas")
    tx = make_optimizer("sgd", 0.03, 1e-4, momentum=0.9,
                        named_params=model.named_parameters())
    state = TrainState.create(model=model, tx=tx, seed=5, extra=task.init_extra(
        torch.Generator(device=dev).manual_seed(1)))
    step = make_train_step(task, tx)
    g = torch.Generator(device=dev).manual_seed(3)
    corpus = torch.rand((16, 80, 80), generator=g, device=dev)
    graph = StepGraph(step.body, lambda idx: corpus.index_select(0, idx), dev)
    idxs = [torch.randperm(16, generator=g, device=dev)[:8] for _ in range(5)]
    graph.step(state, idxs[0])  # eager
    graph.step(state, idxs[1])  # the capture, then the first replay
    calls = graph.report["capture_calls"]
    assert calls["crop_resize_pallas"] == 2
    assert calls["span_mark"] > 0 and calls["span_mark"] % 2 == 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            torch.cuda.synchronize()
            for idx in idxs[2:4]:
                graph.step(state, idx)
            torch.cuda.synchronize()
    path = str(tmp_path / "moco.json")
    prof.export_chrome_trace(path)
    ctx = {"trace": Trace.load(path, 2), "graph": graph.report}
    split = spans.split(ctx)
    assert split is not None, "the markers do not pair"
    for name in ("momentum", "views", "loss", "norm", "forward", "backward",
                 "optimizer", "guard"):
        assert split.get(name, 0.0) > 0.0, (name, split)
    assert spans.cover_pct(ctx) > 99.0
    assert int(state.extra["queue_ptr"]) == (4 * 8) % 64
