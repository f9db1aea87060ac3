"""The serving loop: eval forward per batch, detections handed to the host.

Counterpart of hnd_ghnd_tpu/runners/common.py: ``eval_forward`` is the
``fwd`` of its JitCache.eval_forward (uint8 pixels become float * 1/255,
as parallel/mesh.py:images_to_compute does), and ``evaluate`` is the lag-1
device loop of its ``evaluate``: batch k's detections are copied to pinned
host memory behind a CUDA event while batch k+1 is dispatched, and only then
turned into numpy.  The CocoEvaluator step of that loop waits for ROADMAP
A6 (the host data and eval modules still import jax).
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List

import torch

from hnd_ghnd_tpu_torch.models.rcnn import RCNN


def configure_precision(compute_dtype: str) -> None:
    """Honour the config's ``tpu.compute_dtype``.  float32 means full f32:
    cuDNN convolutions default to TF32, which computes another function."""
    if compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {compute_dtype}: only float32 serving is ported")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def images_to_compute(images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return images.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    return images.float()


def eval_forward(model: RCNN, batch: Dict[str, torch.Tensor],
                 use_bottleneck_transformer: bool) -> Dict[str, torch.Tensor]:
    batch = dict(batch, images=images_to_compute(batch["images"]))
    return model(batch, use_bottleneck_transformer=use_bottleneck_transformer)


def _to_device(batch: Dict[str, Any], device: torch.device):
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def evaluate(model: RCNN, batches: Iterable[Dict[str, Any]],
             use_bottleneck_transformer: bool = False,
             compute_dtype: str = "float32") -> List[Dict[str, Any]]:
    """Serve ``batches`` (dicts of arrays: images [B, H, W, 3] uint8 or
    float in [0, 1], image_sizes, original_sizes) on the model's device.

    Returns one record per batch: ``dets`` (numpy arrays) and ``ms``, the
    time from the batch's dispatch to its detections on the host (CUDA
    events on the card, the host clock on the CPU)."""
    configure_precision(compute_dtype)
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
        dets = eval_forward(model, _to_device(batch, device),
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
