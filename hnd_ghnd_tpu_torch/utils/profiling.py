"""Tracing and timing: the profiler trace, named spans, a device fence.

Counterpart of hnd_ghnd_tpu/utils/profiling.py over ``torch.profiler``.
The reference has three hand-rolled timing mechanisms (SURVEY.md §5.1):
MetricLogger iter/data timing, evaluate()'s model/evaluator timing with an
explicit cuda synchronize, and cost_analyzer's latency summaries; the first
two live in utils/logging.py and runners/common.py.  Here:

  * ``trace(log_dir)``: a ``torch.profiler`` trace of the host and (on a
    card) the device, written when the block ends as
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir``: the Chrome trace
    format, which TensorBoard's PyTorch profiler plugin and Perfetto open;
  * ``annotate(name)``: a named span inside that trace
    (``record_function``);
  * ``sync(x)``: a fence on the stream of x's first CUDA tensor (nothing to
    wait for on the CPU);
  * ``StepTimer``: per-step wall time, fenced, the first steps left out;
  * ``StepTrace``: the trace of a loop's iterations 3-6, the runners'
    ``--profile_dir``.
"""
from __future__ import annotations

import contextlib
import glob
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block into ``log_dir`` (a no-op when it is None)."""
    if not log_dir:
        yield
        return
    with _profiler(log_dir):
        yield


def _profiler(log_dir: str) -> torch.profiler.profile:
    """Host and (where there is a card) device activity, saved to log_dir
    when the profiler stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


def trace_files(log_dir: str) -> list:
    """The trace files ``trace`` wrote under ``log_dir``, oldest first."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")),
                  key=os.path.getmtime)


def annotate(name: str):
    """A named span that shows up inside profiler traces."""
    return torch.profiler.record_function(name)


def _first_tensor(x) -> Optional[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return x
    values = x.values() if isinstance(x, dict) else \
        x if isinstance(x, (list, tuple)) else ()
    for v in values:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def sync(x) -> None:
    """Wait for the work queued on the stream of x's first tensor (x a
    tensor or a nest of dicts, lists and tuples) when it is on a card."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


class StepTimer:
    """Per-step wall-clock accumulator with warm-up exclusion."""

    def __init__(self, skip_first: int = 1):
        self.times = []
        self.skip_first = skip_first
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            sync(result)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> dict:
        arr = np.asarray(self.times[self.skip_first:] or self.times)
        return {"mean_s": float(arr.mean()), "std_s": float(arr.std()),
                "steps": int(arr.size)}


class StepTrace:
    """A ``torch.profiler`` trace of loop iterations ``first`` to ``last``
    (counted from 1 over the whole run, as the JAX runners count theirs:
    the first iterations build kernels and warm cuDNN up), written to
    ``log_dir`` when ``last`` ends, or at ``close`` if the run ends first;
    a no-op when ``log_dir`` is None.  ``before()`` and ``after()``
    bracket each iteration."""

    def __init__(self, log_dir: Optional[str], first: int = 3,
                 last: int = 6):
        self.log_dir = log_dir
        self.first, self.last = first, last
        self.count = 0
        self._prof = None

    def before(self) -> None:
        if not self.log_dir:
            return
        self.count += 1
        if self.count == self.first:
            self._prof = _profiler(self.log_dir)
            self._prof.start()

    def after(self) -> None:
        if self._prof is not None and self.count >= self.last:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
            print(f"profiler trace of iterations {self.first}-{self.count} "
                  f"written to {self.log_dir}", flush=True)
            self.log_dir = None
