"""TensorBoard logging (port of cmx/utils/tensorboard.py; SparK's
TensorboardLogger, Spark/utils/misc.py:89-140).

Rank-0 gated with the same step throttling. It writes through
torch.utils.tensorboard's SummaryWriter, else tensorboard.summary's
Writer; with neither importable it does nothing, as cmx's does.
"""

from __future__ import annotations

from cmx_torch.parallel.dist import process_info


class TensorboardLogger:
    def __init__(self, log_dir: str, throttle: int = 0):
        self.throttle = throttle
        self._last: dict = {}
        self.writer = None
        if process_info()[0] != 0:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            try:
                from tensorboard.summary import Writer
            except ImportError:
                return
            self.writer = Writer(log_dir)
            return
        self.writer = SummaryWriter(log_dir)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is None:
            return
        last = self._last.get(tag, -10**18)
        if self.throttle and step - last < self.throttle:
            return
        self._last[tag] = step
        if hasattr(self.writer, "add_scalar"):
            self.writer.add_scalar(tag, float(value), step)
        else:
            self.writer.add_scalar(tag, float(value), step=step)

    def log_dict(self, metrics: dict, step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            self.log_scalar(prefix + k, float(v), step)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
