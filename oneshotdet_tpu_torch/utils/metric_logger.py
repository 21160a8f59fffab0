"""Metric logging (counterpart of ``oneshotdet_tpu/utils/metric_logger.py``):
``SmoothedValue`` (window-20 median and average, global average),
``MetricLogger`` (named smoothed values), ``TensorboardLogger`` (a
``MetricLogger`` that also writes each update's scalars at its iteration,
where tensorboardX or ``torch.utils.tensorboard`` imports) and ``Timer``."""

from __future__ import annotations

import time
from collections import defaultdict, deque

import torch


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        n = len(d)
        if n == 0:
            return 0.0
        return d[n // 2] if n % 2 else 0.5 * (d[n // 2 - 1] + d[n // 2])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})" for name, m in self.meters.items())


class TensorboardLogger(MetricLogger):
    def __init__(self, log_dir: str, start_iter: int = 0, delimiter: str = "  "):
        super().__init__(delimiter)
        self.iteration = start_iter
        self.writer = self._get_writer(log_dir)

    @staticmethod
    def _get_writer(log_dir):
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                return None
        return SummaryWriter(log_dir)

    def update(self, **kwargs):
        super().update(**kwargs)
        if self.writer is not None:
            for k, v in kwargs.items():
                self.writer.add_scalar(k, float(v), self.iteration)
        self.iteration += 1


class Timer:
    """tic/toc accumulator. ``toc`` first waits for the card when this
    process has used it, so a timed span ends with the device work it
    launched."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.start_time = 0.0

    def tic(self):
        self.start_time = time.perf_counter()

    def toc(self):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self.start_time
        self.total_time += dt
        self.calls += 1
        return dt

    @property
    def average_time(self):
        return self.total_time / self.calls if self.calls else 0.0
