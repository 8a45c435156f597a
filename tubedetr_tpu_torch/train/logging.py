"""Smoothed meters and the progress log of an epoch (counterpart of ``tubedetr_tpu/train/logging.py``).

``SmoothedValue`` keeps a window (median, average, max) and a global
average; ``MetricLogger.log_every`` prints progress, ETA, the meters and,
on the card, the peak device memory every ``print_freq`` iterations.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Optional

import torch


class SmoothedValue:
    """A series over a sliding window plus its global sum and count."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

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

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


def device_memory_stats() -> Optional[int]:
    """Peak device memory in bytes on the card, None without one."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.max_memory_allocated()
    return None


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_freq: int = 100):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable: Iterable, header: str = ""):
        """Yield from ``iterable``, printing progress every ``print_freq``
        iterations and at the last."""
        i = 0
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = (str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                       if total else "?")
                meters = self.delimiter.join(f"{name}: {meter}" for name, meter in self.meters.items())
                mem = device_memory_stats()
                mem_s = f"  mem: {mem / 2**20:.0f}MB" if mem else ""
                print(f"{header} [{i}{'/' + str(total) if total else ''}]  eta: {eta}  {meters}  "
                      f"time: {iter_time}  data: {data_time}{mem_s}", flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)
