"""The pretrain CLI under data parallel on the CPU: `cmx_torch.cli.pretrain`
in two processes of a gloo group that the CLI makes itself from the
launcher's variables (WORLD_SIZE=2, RANK, MASTER_ADDR, MASTER_PORT), as
torchrun would start it, against one process fed the same global batches
(each step's indices: rank 0's rows, then rank 1's).

SparK at reduced widths (8, 16, 32, 64), bottleneck 128, 32^2, fp32,
global batch 4, SGD (an Adam-type step turns the rounding noise of the
gradients whose true value is 0 into +-lr moves; see test_torch_port_dp.py),
one epoch with validation (patience 5: global validation batches, each rank
its rows). Held: rank 0 alone writes
log.jsonl, the checkpoint, encoder.npz and model.npz (the writes each
process made are recorded); the losses are finite; the two ranks end with
the same state bit for bit; the logged losses within rtol 1e-5 and the
encoder.npz within 2e-5 of the one-process run's (cmx's DP tolerances,
tests/test_distributed_parity.py).
"""

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
ARGS = ["--device", "cpu", "--task", "spark", "data.synthetic=True",
        "data.synthetic_n=16", "data.image_size=32", "train.batch_size=4",
        "model.dtype=float32", "optim.name=sgd", "optim.lr=1e-2",
        "train.epochs=1", "train.patience=5", "train.val_fraction=0.25"]


def _small_widths():
    import cmx_torch.ssl.spark as spark

    spark.SparKModel = functools.partial(spark.SparKModel, widths=WIDTHS,
                                         bottleneck_width=BNECK)


def _digests(state):
    out = {}
    tensors = list(state.model.state_dict().items()) + [
        (f"opt/{k}/{i}", t) for k, v in state.opt.state_dict().items()
        for i, t in enumerate(v if isinstance(v, list) else [v])]
    for k, t in tensors:
        a = t.detach().contiguous().reshape(-1)
        out[k] = hashlib.sha256(a.view(torch.uint8).numpy().tobytes()
                                ).hexdigest()
    return out


def _worker(data_dir, ckpt_dir, out):
    """One rank: the CLI as a user runs it, every file write recorded."""
    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT))
    _small_widths()
    from cmx_torch.cli.pretrain import main
    from cmx_torch.utils.logging import JsonlLogger

    written = []

    def record(name, f):
        @functools.wraps(f)
        def wrapper(*a, **k):
            written.append(name)
            return f(*a, **k)
        return wrapper

    np.savez = record("npz", np.savez)
    torch.save = record("checkpoint", torch.save)
    JsonlLogger._write = record("log.jsonl", JsonlLogger._write)
    res = main(ARGS + [f"data.data_dir={data_dir}",
                       f"train.ckpt_dir={ckpt_dir}"])
    rank = int(os.environ["RANK"])
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump({"written": written, "step": res["state"].step,
                   "digests": _digests(res["state"]),
                   "val_batches": res["val_batches"]}, f)


if __name__ == "__main__":
    _worker(*sys.argv[1:4])
    sys.exit(0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _GlobalBatches:
    """The one-process sampler: each step's indices are the two ranks'
    (InfiniteBatchSampler at world 2), rank 0's first."""

    def __init__(self, n, batch_size, rank=0, world_size=1, seed=0):
        from cmx_torch.parallel.dist import InfiniteBatchSampler

        self.parts = [InfiniteBatchSampler(n, batch_size // 2, r, 2, seed)
                      for r in range(2)]
        self.iters_per_epoch = self.parts[0].iters_per_epoch
        self.epoch = 0

    def __iter__(self):
        for p in self.parts:
            p.epoch = self.epoch
        its = [iter(p) for p in self.parts]
        while True:
            yield np.concatenate([next(i) for i in its])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), PYTHONPATH=str(ROOT),
               OMP_NUM_THREADS="2")
    env.pop("LOCAL_RANK", None)
    procs = []
    for rank in range(2):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(tmp / "data"), str(tmp / "dp"),
             str(tmp / "out")], env=dict(env, RANK=str(rank)), cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    bad = []
    for p, log in procs:
        try:
            p.wait(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.close()
        if p.returncode != 0:
            bad.append(Path(log.name).read_text()[-4000:])
    assert not bad, "a rank failed:\n" + "\n---\n".join(bad)
    ranks = [json.loads((tmp / f"out.{r}.json").read_text())
             for r in range(2)]

    import cmx_torch.cli.pretrain as cli
    import cmx_torch.ssl.spark as spark

    saved = (cli.InfiniteBatchSampler, spark.SparKModel,
             torch.get_num_threads())
    cli.InfiniteBatchSampler = _GlobalBatches
    spark.SparKModel = functools.partial(spark.SparKModel, widths=WIDTHS,
                                         bottleneck_width=BNECK)
    torch.set_num_threads(2)
    try:
        one = cli.main(ARGS + [f"data.data_dir={tmp / 'data'}",
                               f"train.ckpt_dir={tmp / 'one'}"])
    finally:
        cli.InfiniteBatchSampler, spark.SparKModel, threads = saved
        torch.set_num_threads(threads)
    return tmp, ranks, one


def _log(ckpt_dir):
    with open(ckpt_dir / "spark" / "log.jsonl") as f:
        return [json.loads(line) for line in f]


def test_rank_zero_alone_writes_the_run_files(cli_runs):
    tmp, ranks, _ = cli_runs
    assert ranks[1]["written"] == []
    assert sorted(set(ranks[0]["written"])) == ["checkpoint", "log.jsonl",
                                                "npz"]
    assert ranks[0]["written"].count("npz") == 2  # encoder.npz, model.npz
    assert len(_log(tmp / "dp")) == 1  # one epoch, written once
    assert {f for f in os.listdir(tmp / "dp" / "spark")} >= {
        "log.jsonl", "encoder.npz", "model.npz", "encoder.npz.stamp.json"}


def test_two_rank_cli_equals_one_process_fed_the_global_batches(cli_runs):
    tmp, ranks, one = cli_runs
    (row,), (ref,) = _log(tmp / "dp"), _log(tmp / "one")
    for k in ("loss", "recon", "val_loss"):
        assert np.isfinite(row[k])
        assert abs(row[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, row[k], ref[k])
    assert ranks[0]["step"] == ranks[1]["step"] == one["state"].step \
        == one["steps_per_epoch"] >= 2
    assert ranks[0]["val_batches"] == one["val_batches"] == 1
    assert ranks[0]["digests"] == ranks[1]["digests"]
    with np.load(tmp / "dp" / "spark" / "encoder.npz") as a, \
            np.load(tmp / "one" / "spark" / "encoder.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], atol=2e-5, rtol=0,
                                       err_msg=k)
