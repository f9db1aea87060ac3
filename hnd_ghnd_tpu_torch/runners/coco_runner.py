"""Supervised detector training (the ``org`` models).

Counterpart of hnd_ghnd_tpu/runners/coco_runner.py:train (reference
src/coco_runner.py): the loss is the sum of the R-CNN loss dict; the
schedule is the config's with the reference's warmup of
min(1000, steps_per_epoch - 1) steps; the trunk's conv1, bn1 and layer1 are
frozen under ``backbone.params.freeze_layers`` (models/factory.py); a
non-finite loss stops training (coco_runner.py:95-103); after each epoch
the model is evaluated through the serving path in float32, then put back
in train mode.  Step scalars are read one step late (``StepMetrics``), so
the check of a loss fires one step after it was queued.

The compute dtype is ``tpu.compute_dtype`` (bfloat16 unless the config
says float32).  The YAML, the COCO loader, COCOeval and the best-mAP
checkpoint wait for ROADMAP A6: batches come in as (batch, targets) pairs
of arrays, and the eval returns detections.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Tuple

import torch

from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel.train_step import (MAX_WARMUP,
                                                    make_detection_train_step)
from hnd_ghnd_tpu_torch.runners.common import (StepMetrics,
                                               compute_dtype_from_config,
                                               configure_precision, evaluate,
                                               to_device)

Batch = Dict[str, Any]


def train(model: RCNN, config: Dict[str, Any],
          train_batches: Iterable[Tuple[Batch, Batch]],
          val_batches: Iterable[Batch], steps_per_epoch: int,
          seed: int = 0) -> Dict[str, List]:
    """Train ``model`` for ``train.num_epochs`` epochs, each over
    ``train_batches``: (batch, targets) pairs, the batch with images
    [B, H, W, 3] (uint8, or float in [0, 1]), image_sizes and
    original_sizes [B, 2], the targets with boxes [B, G, 4], labels [B, G]
    and boxes_valid [B, G] padded to a fixed G.  The model stays on its
    device (the card unless the caller put it on the CPU) and trains the
    parameters that ``requires_grad``; ``seed`` seeds the samplers.

    Returns {"steps": [(step, loss, {term: value}, ms)], "evals": [the
    records of ``evaluate`` for each epoch]}; ms is the step's time between
    CUDA events (None on the CPU)."""
    train_cfg = config["train"]
    compute_dtype = compute_dtype_from_config(config)
    configure_precision(compute_dtype)
    device = next(model.parameters()).device
    steps_per_epoch = max(int(steps_per_epoch), 1)
    warmup = min(MAX_WARMUP, steps_per_epoch - 1)
    step = make_detection_train_step(
        model, train_cfg["optimizer"], train_cfg.get("scheduler"),
        steps_per_epoch, warmup, compute_dtype, seed=seed)
    cuda = device.type == "cuda"
    history: Dict[str, List] = {"steps": [], "evals": []}

    def record(entries):
        for entry in entries:
            if not math.isfinite(entry[1]):
                raise FloatingPointError(
                    f"loss is {entry[1]} at step {entry[0]} "
                    f"({entry[2]}), stopping training")
            history["steps"].append(entry)

    for _ in range(int(train_cfg["num_epochs"])):
        model.train()
        metrics = StepMetrics()
        for batch, targets in train_batches:
            batch, targets = to_device(batch, device), to_device(targets, device)
            start = None
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            loss, terms = step(batch, targets)
            record(metrics.push(step.step - 1, loss, terms, start))
        record(metrics.drain())
        history["evals"].append(evaluate(model.eval(), val_batches))
    model.train()
    return history
