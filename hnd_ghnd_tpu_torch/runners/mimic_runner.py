"""HND / GHND distillation loop.

Counterpart of hnd_ghnd_tpu/runners/mimic_runner.py:distill (reference
src/mimic_runner.py): the frozen teacher and the student run the distill
step over each epoch's batches, with the reference's warmup of
min(1000, steps_per_epoch - 1) steps and its MultiStepLR; after each epoch
the student is evaluated through the serving path, with the 8-bit
bottleneck round trip only when asked (``use_bottleneck_transformer``, JAX's
``-transform_bottleneck`` flag, off by default), then put back in train
mode.  Step scalars are read one step late (``StepMetrics``), so the loop
never waits on the step it just queued.

The YAML, the COCO loader, COCOeval and the checkpoints wait for ROADMAP
A6: batches come in as dicts of arrays, and the eval returns detections.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch

from hnd_ghnd_tpu_torch.distill.box import DistillationBox
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel.train_step import (MAX_WARMUP,
                                                    make_distill_train_step)
from hnd_ghnd_tpu_torch.runners.common import (StepMetrics,
                                               compute_dtype_from_config,
                                               configure_precision, evaluate,
                                               to_device)


def distill(teacher: RCNN, student: RCNN, config: Dict[str, Any],
            train_batches: Iterable[Dict[str, Any]],
            val_batches: Iterable[Dict[str, Any]],
            steps_per_epoch: int,
            use_bottleneck_transformer: bool = False) -> Dict[str, List]:
    """Distil ``student`` from ``teacher`` for ``train.num_epochs`` epochs,
    each over ``train_batches`` (dicts with ``images`` [B, H, W, 3], uint8
    or float in [0, 1], on the host or on the models' device).  Both models
    are on one device, the card unless the caller put them on the CPU.
    The student trains what its factory left trainable (everything outside
    ``frozen_modules``); the teacher is frozen here.  Each epoch's eval
    quantizes and dequantizes the bottleneck only with
    ``use_bottleneck_transformer`` (JAX's ``-transform_bottleneck``).

    Returns {"steps": [(step, loss, {term: value}, ms)], "evals": [the
    records of ``evaluate`` for each epoch]}; ms is the step's time between
    CUDA events (None on the CPU)."""
    train_cfg = config["train"]
    compute_dtype = compute_dtype_from_config(config)
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"distillation in {compute_dtype} is not ported (ROADMAP A4): "
            "set tpu.compute_dtype: float32")
    configure_precision(compute_dtype)
    device = next(student.parameters()).device
    if next(teacher.parameters()).device != device:
        raise ValueError("distill: teacher and student must share a device")
    teacher.eval().requires_grad_(False)
    steps_per_epoch = max(int(steps_per_epoch), 1)
    warmup = min(MAX_WARMUP, steps_per_epoch - 1)
    box = DistillationBox(teacher, student, train_cfg["criterion"])
    step = make_distill_train_step(box, train_cfg["optimizer"],
                                   train_cfg.get("scheduler"),
                                   steps_per_epoch, warmup)
    cuda = device.type == "cuda"
    history: Dict[str, List] = {"steps": [], "evals": []}
    for _ in range(int(train_cfg["num_epochs"])):
        student.train()
        metrics = StepMetrics()
        for batch in train_batches:
            images = to_device({"images": batch["images"]}, device)["images"]
            start = None
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            loss, terms = step(images)
            history["steps"] += metrics.push(step.step - 1, loss, terms, start)
        history["steps"] += metrics.drain()
        history["evals"].append(evaluate(
            student.eval(), val_batches,
            use_bottleneck_transformer=use_bottleneck_transformer))
        student.train()
    return history
