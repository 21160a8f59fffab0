"""Wall-clock timer (counterpart of ``Timer`` in
``oneshotdet_tpu/utils/metric_logger.py``)."""

from __future__ import annotations

import time

import torch


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
