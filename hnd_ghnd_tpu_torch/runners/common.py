"""The serving loop and the lag-1 read of training scalars.

Counterpart of hnd_ghnd_tpu/runners/common.py: ``eval_forward`` is the
``fwd`` of its JitCache.eval_forward (uint8 pixels become float * 1/255,
as parallel/mesh.py:images_to_compute does), and ``evaluate`` is the lag-1
device loop of its ``evaluate``: batch k's detections are copied to pinned
host memory behind a CUDA event while batch k+1 is dispatched, and only then
turned into numpy.  The CocoEvaluator step of that loop waits for ROADMAP
A6 (the host data and eval modules still import jax).  The forward runs
in float32 whatever the config's compute dtype, as JAX's eval forward does
(runners/common.py:180-184).  ``StepMetrics`` is its counterpart for the
training loops: each step's loss and terms go to pinned host memory behind
a CUDA event and are read one step later.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Iterable, List, Tuple

import torch

from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype_from_config(config: Dict[str, Any]) -> torch.dtype:
    """``tpu.compute_dtype``: bfloat16 (the JAX package's default) or
    float32."""
    name = (config.get("tpu", {}) or {}).get("compute_dtype", "bfloat16")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"tpu.compute_dtype `{name}` is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def configure_precision(compute_dtype: torch.dtype) -> None:
    """Honour the compute dtype.  TF32 stays off: it would compute the
    float32 parts (bfloat16 training's float32 losses and the float32
    eval) as another function."""
    if compute_dtype not in COMPUTE_DTYPES.values():
        raise NotImplementedError(f"compute dtype {compute_dtype}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def eval_forward(model: RCNN, batch: Dict[str, torch.Tensor],
                 use_bottleneck_transformer: bool) -> Dict[str, torch.Tensor]:
    batch = dict(batch, images=images_to_compute(batch["images"],
                                                 torch.float32))
    return model(batch, use_bottleneck_transformer=use_bottleneck_transformer)


def to_device(batch: Dict[str, Any], device: torch.device):
    """A dict of arrays as tensors on ``device``; host arrays go to the
    card through pinned memory, without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def evaluate(model: RCNN, batches: Iterable[Dict[str, Any]],
             use_bottleneck_transformer: bool = False) -> List[Dict[str, Any]]:
    """Serve ``batches`` (dicts of arrays: images [B, H, W, 3] uint8 or
    float in [0, 1], image_sizes, original_sizes) on the model's device.

    Returns one record per batch: ``dets`` (numpy arrays) and ``ms``, the
    time from the batch's dispatch to its detections on the host (CUDA
    events on the card, the host clock on the CPU)."""
    configure_precision(torch.float32)
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    records: List[Dict[str, Any]] = []
    pending = None

    def finish(p):
        host, done, start, t0 = p
        if cuda:
            done.synchronize()
            ms = start.elapsed_time(done)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        records.append({"dets": {k: v.numpy() for k, v in host.items()},
                        "ms": ms})

    for batch in batches:
        t0 = time.perf_counter()
        start = done = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
        dets = eval_forward(model, to_device(batch, device),
                            use_bottleneck_transformer)
        if cuda:
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in dets.items()}
            for k, v in dets.items():
                host[k].copy_(v, non_blocking=True)
            done.record()
        else:
            host = dets
        if pending is not None:
            finish(pending)
        pending = (host, done, start, t0)
    if pending is not None:
        finish(pending)
    return records


class StepMetrics:
    """Delayed reads of step scalars (hnd_ghnd_tpu/runners/common.py
    StepMetrics, with a lag of one step).

    ``push`` starts a copy of the step's loss and terms into pinned host
    memory and records a CUDA event behind it; the host waits on that event
    only when the entry is one step old, by which time the next step is
    already queued.  On the CPU the values are read as they
    are.  Each entry read is (step index, loss, {term: value}, ms), with ms
    the time between the step's start and end events (None on the CPU)."""

    LAG = 1

    def __init__(self):
        self._pending: deque = deque()

    def push(self, step_index: int, loss: torch.Tensor,
             terms: Dict[str, torch.Tensor], start=None) -> List[Tuple]:
        """``start``: a CUDA event recorded before the step was queued."""
        names = list(terms)
        values = torch.stack([loss.float()] + [terms[k].float() for k in names])
        done = None
        if values.is_cuda:
            host = torch.empty(values.shape, dtype=values.dtype,
                               pin_memory=True)
            host.copy_(values, non_blocking=True)
            done = torch.cuda.Event(enable_timing=start is not None)
            done.record()
            values = host
        self._pending.append((step_index, names, values, start, done))
        out = []
        while len(self._pending) > self.LAG:
            out.append(self._read_one())
        return out

    def drain(self) -> List[Tuple]:
        out = []
        while self._pending:
            out.append(self._read_one())
        return out

    def _read_one(self):
        idx, names, values, start, done = self._pending.popleft()
        ms = None
        if done is not None:
            done.synchronize()
            if start is not None:
                ms = start.elapsed_time(done)
        vals = values.tolist()
        return idx, vals[0], dict(zip(names, vals[1:])), ms
