"""Observability: meters, metric logger, JSON-line logs, stdout tee (a copy
of cmx/utils/logging.py).

Counterparts of the reference's observability stack (SURVEY §5):
  * AverageValueMeter online mean/std (Finetuning/train.py:43-79)
  * SmoothedValue / MetricLogger with iter+data timing
    (Spark/utils/misc.py:192-339) — cross-rank sync is unnecessary here:
    the step's metrics are already the global batch's on every rank
  * JSON-line epoch log (Spark/utils/arg_util.py:74-93), written by rank 0
    alone under data parallel
  * stdout/stderr tee to file (Spark/utils/misc.py:72-86)
"""

from __future__ import annotations

import datetime
import json
import math
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

from cmx_torch.parallel.dist import on_main


class AverageMeter:
    """Online mean/std (Welford) — Finetuning/train.py:43-79 semantics."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.mean = 0.0
        self.m2 = 0.0

    def add(self, value: float, n: int = 1):
        value = float(value)
        self.n += n
        self.sum += value * n
        delta = value - self.mean
        self.mean += delta * n / self.n
        self.m2 += delta * (value - self.mean) * n

    @property
    def std(self) -> float:
        return math.sqrt(self.m2 / self.n) if self.n > 1 else 0.0

    def value(self):
        return self.mean, self.std


class SmoothedValue:
    """Window-smoothed series with global stats (Spark/utils/misc.py:192+)."""

    def __init__(self, window: int = 20, fmt: str = "{median:.4f}"):
        self.deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg
        )


class MetricLogger:
    """Iteration logger with iter/data timing (Spark/utils/misc.py:289-339)."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {v}" for k, v in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if print_freq and (i % print_freq == 0):
                self.print_fn(
                    f"{header} [{i}] {self} iter: {iter_time} data: {data_time}"
                )
        total = time.time() - start
        self.print_fn(f"{header} done in {datetime.timedelta(seconds=int(total))}")


_GIT_INFO = None


def git_info() -> Dict[str, str]:
    """Current commit id + message, cached (arg_util.py:56-57 analog).

    Empty dict outside a git repo or without git."""
    global _GIT_INFO
    if _GIT_INFO is None:
        import subprocess

        try:
            cwd = os.path.dirname(os.path.abspath(__file__))
            cid = subprocess.run(
                ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                cwd=cwd, timeout=5,
            )
            msg = subprocess.run(
                ["git", "log", "-1", "--format=%s"], capture_output=True,
                text=True, cwd=cwd, timeout=5,
            )
            if cid.returncode == 0:
                _GIT_INFO = {
                    "commit_id": cid.stdout.strip(),
                    "commit_msg": msg.stdout.strip(),
                }
            else:
                _GIT_INFO = {}
        except (OSError, subprocess.SubprocessError):
            _GIT_INFO = {}
    return _GIT_INFO


class JsonlLogger:
    """Append-a-JSON-object-per-epoch log (Spark/utils/arg_util.py:74-93).

    The first record of every run carries the git commit id + message
    (arg_util.py:56-57), so results stay traceable to code versions."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._stamped = False

    def write(self, **fields):
        on_main(self._write, fields)

    def _write(self, fields: dict) -> None:
        fields.setdefault("time", datetime.datetime.now().isoformat())
        if not self._stamped:
            for k, v in git_info().items():
                fields.setdefault(k, v)
            self._stamped = True
        with open(self.path, "a") as f:
            f.write(json.dumps(fields, default=str) + "\n")


class Tee:
    """Mirror a stream to a file (Spark/utils/misc.py:72-86)."""

    def __init__(self, stream, path: str):
        self.stream = stream
        self.file = open(path, "a")

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)

    def flush(self):
        self.stream.flush()
        self.file.flush()


def tee_output(log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    sys.stdout = Tee(sys.stdout, os.path.join(log_dir, "stdout.log"))
    sys.stderr = Tee(sys.stderr, os.path.join(log_dir, "stderr.log"))


def timestamped_print(*args, **kwargs):
    """print with timestamp prefix (the misc.py:51-69 monkeypatch, opt-in)."""
    ts = datetime.datetime.now().strftime("%m-%d %H:%M:%S")
    print(f"[{ts}]", *args, **kwargs)
