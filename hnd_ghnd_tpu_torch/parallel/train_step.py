"""Optimizer, schedule and the distill step.

Counterpart of hnd_ghnd_tpu/parallel/mesh.py: ``build_schedule`` and
``build_optimizer`` (the reference's train.optimizer/scheduler schema:
Adam, SGD with momentum and weight decay, MultiStepLR, and the linear
warmup of src/utils/main_util.py), ``images_to_compute`` (the uint8 pixel
wire) and ``make_distill_train_step``.  One card runs the step: there is
no mesh, no ``steps_per_dispatch`` and no buffer donation.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from hnd_ghnd_tpu_torch.distill.box import DistillationBox

WARMUP_FACTOR = 1.0 / 1000.0


def build_schedule(base_lr: float, scheduler_cfg: Optional[dict],
                   steps_per_epoch: int, warmup_iters: int = 0,
                   warmup_factor: float = WARMUP_FACTOR) -> Callable[[int], float]:
    """step (counted from 0) -> learning rate: MultiStepLR by epoch
    milestones turned into step boundaries, times a linear warmup from
    ``warmup_factor`` over the first ``warmup_iters`` steps.  Computed in
    float32, as the JAX schedule is."""
    f32 = np.float32
    boundaries = []
    if scheduler_cfg and scheduler_cfg.get("type") == "MultiStepLR":
        gamma = float(scheduler_cfg["params"].get("gamma", 0.1))
        scale = 1.0
        for ms in scheduler_cfg["params"]["milestones"]:
            scale *= gamma
            boundaries.append((int(ms) * steps_per_epoch, f32(base_lr * scale)))
    elif scheduler_cfg and scheduler_cfg.get("type") is not None:
        raise ValueError(f"unsupported scheduler `{scheduler_cfg.get('type')}`")
    boundaries.sort()

    def schedule(step: int) -> float:
        lr = f32(base_lr)
        for boundary, value in boundaries:
            if step >= boundary:
                lr = value
        if warmup_iters > 0 and step < warmup_iters:
            alpha = min(max(f32(step) / f32(warmup_iters), f32(0)), f32(1))
            lr = lr * (f32(warmup_factor) * (f32(1) - alpha) + alpha)
        return float(lr)

    return schedule


def build_optimizer(params, optimizer_cfg: dict,
                    scheduler_cfg: Optional[dict] = None,
                    steps_per_epoch: int = 1, warmup_iters: int = 0):
    """torch.optim.<type>(params, **cfg) for the types the reference configs
    use, Adam(lr) and SGD(lr, momentum, weight_decay), and the schedule the
    step sets before each update.  Returns (optimizer, schedule)."""
    otype = optimizer_cfg["type"]
    p = dict(optimizer_cfg.get("params", {}) or {})
    lr = float(p.pop("lr"))
    schedule = build_schedule(lr, scheduler_cfg, steps_per_epoch, warmup_iters)
    params = list(params)
    if otype == "Adam":
        return torch.optim.Adam(params, lr=lr, **p), schedule
    if otype == "SGD":
        return torch.optim.SGD(params, lr=lr,
                               momentum=float(p.pop("momentum", 0.0)),
                               weight_decay=float(p.pop("weight_decay", 0.0)),
                               **p), schedule
    raise ValueError(f"unsupported optimizer `{otype}`")


def images_to_compute(images: torch.Tensor) -> torch.Tensor:
    """uint8 pixels (the loader's ``pixel_dtype: uint8`` wire) become
    float * 1/255; float pixels are already in [0, 1]."""
    if images.dtype == torch.uint8:
        return images.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32)
    return images.float()


class DistillStep:
    """One HND/GHND step on the student's trainable parameters:
    zero grads, loss, backward, lr = schedule(step), optimizer step.

    ``__call__`` returns the loss and its terms as device tensors and never
    waits for the device.  ``step`` counts the updates from 0, as optax's
    count does."""

    def __init__(self, box: DistillationBox, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.box = box
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0

    def apply_update(self) -> None:
        """The optimizer update from the gradients in ``.grad``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def __call__(self, images: torch.Tensor):
        self.optimizer.zero_grad(set_to_none=True)
        loss, terms = self.box.loss(images_to_compute(images))
        loss.backward()
        self.apply_update()
        return loss.detach(), {k: v.detach() for k, v in terms.items()}


def make_distill_train_step(box: DistillationBox, optimizer_cfg: dict,
                            scheduler_cfg: Optional[dict] = None,
                            steps_per_epoch: int = 1,
                            warmup_iters: int = 0) -> DistillStep:
    """The step over the student's parameters that ``requires_grad`` (its
    ``frozen_modules`` are off)."""
    trainable = [p for p in box.student.parameters() if p.requires_grad]
    optimizer, schedule = build_optimizer(trainable, optimizer_cfg,
                                          scheduler_cfg, steps_per_epoch,
                                          warmup_iters)
    return DistillStep(box, optimizer, schedule)
