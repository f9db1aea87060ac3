"""Training-loop observability: windowed metric smoothing, per-step lines.

Counterpart of hnd_ghnd_tpu/utils/logging.py (reference
src/utils/misc_util.py SmoothedValue :10-69 and MetricLogger :142-229):
median/avg over a sliding window and global averages of the logged
scalars, and ``MetricLogger.log_every``, the line every ``print_freq``
iterations (JAX's logging.py:77-109) that ``coco_runner.train_epoch`` and
``ext_runner``'s loop print.  The values it prints are whatever the loop
has given ``update``: the runners give it the lag-1 scalars of
``runners/common.StepMetrics``, so a logged step waits for nothing on the
device.  Neither keeps the reference's cross-rank all_reduce of the meters
(each rank logs its own, and only rank 0 prints).
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.window = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.window.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.window)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.window) if self.window else 0.0

    @property
    def value(self) -> float:
        return self.window[-1] if self.window else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "") -> Iterable:
        """Yield from ``iterable``; every ``print_freq`` items print the
        meters with the iteration and data times and an ETA, and at the end
        the total time."""
        i = 0
        start = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        space = len(str(total)) if total else 6
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                if total:
                    eta = iter_time.global_avg * (total - i)
                    eta_s = str(datetime.timedelta(seconds=int(eta)))
                    print(f"{header} [{i:>{space}}/{total}] eta: {eta_s} "
                          f"{self} time: {iter_time} data: {data_time}",
                          flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}",
                          flush=True)
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(elapsed)))} "
              f"({elapsed / max(i, 1):.4f} s / it)", flush=True)
