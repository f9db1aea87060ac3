"""Optimizer, schedule, the distill step and the detection step.

Counterpart of hnd_ghnd_tpu/parallel/mesh.py: ``build_schedule`` and
``build_optimizer`` (the reference's train.optimizer/scheduler schema:
Adam, SGD with momentum and weight decay, MultiStepLR, and the linear
warmup of src/utils/main_util.py), ``images_to_compute`` (the pixel cast to
the compute dtype), ``make_distill_train_step`` and
``make_detection_train_step`` (mesh.py:168-406).  A rank runs the step on
one device: there is no mesh, no ``steps_per_dispatch`` and no buffer
donation.  With a process group of N > 1 ranks up (parallel/multihost.py),
each rank runs its shard of the global batch and the steps keep the JAX
package's semantics (ROADMAP C2):

  * ``DistillStep`` without the org term (GSPMD, the loss an MSE sum over
    the global batch): the gradients and the logged loss and terms are
    summed over the ranks, and the trainable BNs take the global batch's
    statistics, so N ranks compute one process's step on the
    concatenated batch;
  * ``DetectionStep``, and ``DistillStep`` with ``org_loss_factor != 0``
    (``shard_map``, DDP, mesh.py:298-307): each rank's own loss, BN
    statistics of its own shard (``per_process_batch_norm``), the
    gradients, loss, terms and float buffers averaged (``lax.pmean``), and
    rank r's sampler draws from ``fold_in(seed, r)``.  The distill terms
    of such a step are each rank's MSE sum over its own shard, averaged:
    1/N of what the GSPMD step logs, as in the JAX package (ROADMAP C2).

The reduced gradients, scalars and buffers go in one all-reduce per dtype,
queued behind the backward: the step adds no host wait of its own.

The optimizer holds only the parameters that ``requires_grad``: frozen
ones have no gradient and stay bit-identical, as in the reference.  The
JAX package instead zeroes their gradients and its SGD chain still decays
them by lr * weight_decay * p per step (ROADMAP C7).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hnd_ghnd_tpu_torch.distill.box import DistillationBox
from hnd_ghnd_tpu_torch.models.layers import per_process_batch_norm
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.models.rpn import Draw
from hnd_ghnd_tpu_torch.parallel import multihost

WARMUP_FACTOR = 1.0 / 1000.0
# the reference's warmup: min(MAX_WARMUP, steps_per_epoch - 1) steps
MAX_WARMUP = 1000


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


def images_to_compute(images: torch.Tensor,
                      compute_dtype: torch.dtype) -> torch.Tensor:
    """uint8 pixels (the loader's ``pixel_dtype: uint8`` wire) become
    ``compute_dtype`` * 1/255 (in that dtype, as mesh.py:168-176 does);
    float pixels, already in [0, 1], are cast."""
    if images.dtype == torch.uint8:
        return images.to(compute_dtype) * torch.tensor(1.0 / 255.0,
                                                       dtype=compute_dtype)
    return images.to(compute_dtype)


class _Step:
    """Shared by the steps: lr = schedule(step) before each optimizer
    update.  ``step`` counts the updates from 0, as optax's count does."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.schedule = schedule
        self.step = 0

    def all_reduce(self, loss: torch.Tensor, terms: Dict[str, torch.Tensor],
                   op: str, buffers: Sequence[torch.Tensor] = ()
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The gradients of the optimizer's parameters, ``loss``, ``terms``
        and ``buffers`` (in place) reduced over the ranks by ``op`` ("sum"
        or "avg", parallel/multihost.py).  Returns the loss and terms
        detached: at one rank, as they are; else the reduced float32
        values."""
        if multihost.get_world_size() == 1:
            return loss.detach(), {k: v.detach() for k, v in terms.items()}
        names = list(terms)
        scalars = torch.stack([loss.detach().float()]
                              + [terms[k].detach().float() for k in names])
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        multihost.all_reduce_grads(params, op, [scalars, *buffers])
        return scalars[0], dict(zip(names, scalars[1:]))

    def apply_update(self) -> None:
        """The optimizer update from the gradients in ``.grad``."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


class DistillStep(_Step):
    """One HND/GHND step on the student's trainable parameters in
    ``compute_dtype``: zero grads, loss, backward, lr = schedule(step),
    optimizer step.  With the org term (``box.use_org_loss``) the step
    takes the batch's targets and ``draw`` gives the samplers' uniform
    draws.

    ``__call__`` returns the loss and its terms as device tensors and never
    waits for the device."""

    def __init__(self, box: DistillationBox, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float],
                 compute_dtype: torch.dtype = torch.bfloat16,
                 draw: Optional[Draw] = None):
        super().__init__(optimizer, schedule)
        self.box = box
        self.compute_dtype = compute_dtype
        self.draw = draw

    def __call__(self, batch: Dict[str, torch.Tensor],
                 targets: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``batch``: {"images": [B, H, W, 3] (uint8, or float in [0, 1])};
        with the org term also image_sizes [B, 2], and ``targets`` as the
        loader pads them."""
        self.optimizer.zero_grad(set_to_none=True)
        images = images_to_compute(batch["images"], self.compute_dtype)
        if not self.box.use_org_loss:
            loss, terms = self.box.loss(images)
            loss.backward()
            loss, terms = self.all_reduce(loss, terms, "sum")
        else:
            with per_process_batch_norm():
                loss, terms = self.box.loss(images, targets, self.draw,
                                            batch.get("image_sizes"))
            loss.backward()
            buffers = [b for b in self.box.student.buffers()
                       if b.is_floating_point()]
            loss, terms = self.all_reduce(loss, terms, "avg", buffers)
        self.apply_update()
        return loss, terms


class DetectionStep(_Step):
    """One supervised detector step (the coco_runner path): zero grads, the
    model's loss dict in ``compute_dtype`` (four terms, five with the mask
    or keypoint loss), their sum, backward, lr = schedule(step), optimizer
    step.  ``draw`` gives the samplers' uniform draws.  Returns the loss
    and its terms as device tensors, without waiting for the device."""

    def __init__(self, model: RCNN, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], compute_dtype: torch.dtype,
                 draw: Draw):
        super().__init__(optimizer, schedule)
        self.model = model
        self.compute_dtype = compute_dtype
        self.draw = draw

    def __call__(self, batch: Dict[str, torch.Tensor],
                 targets: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        self.optimizer.zero_grad(set_to_none=True)
        images = images_to_compute(batch["images"], self.compute_dtype)
        with per_process_batch_norm():
            losses = self.model(dict(batch, images=images), targets,
                                self.draw)
        loss = sum(losses.values())
        loss.backward()
        buffers = [b for b in self.model.buffers() if b.is_floating_point()]
        loss, losses = self.all_reduce(loss, losses, "avg", buffers)
        self.apply_update()
        return loss, losses


def make_distill_train_step(box: DistillationBox, optimizer_cfg: dict,
                            scheduler_cfg: Optional[dict] = None,
                            steps_per_epoch: int = 1,
                            warmup_iters: int = 0,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            draw: Optional[Draw] = None,
                            seed: int = 0) -> DistillStep:
    """The step over the student's parameters that ``requires_grad`` (its
    ``frozen_modules`` are off).  With the org term the samplers draw as
    ``make_detection_train_step``'s do (``seeded_draw``)."""
    trainable = [p for p in box.student.parameters() if p.requires_grad]
    optimizer, schedule = build_optimizer(trainable, optimizer_cfg,
                                          scheduler_cfg, steps_per_epoch,
                                          warmup_iters)
    if draw is None and box.use_org_loss:
        draw = seeded_draw(box.student, seed)
    return DistillStep(box, optimizer, schedule, compute_dtype, draw)


def uniform_draw(generator: torch.Generator) -> Draw:
    """The samplers' uniform draws from ``generator``, on its device."""
    return lambda shape: torch.rand(shape, generator=generator,
                                    device=generator.device)


def seeded_draw(model: torch.nn.Module, seed: int) -> Draw:
    """Draws from a ``torch.Generator`` on the model's device, seeded with
    ``seed`` (one rank) or with ``multihost.fold_in(seed, rank)``."""
    device = next(model.parameters()).device
    if multihost.get_world_size() > 1:
        seed = multihost.fold_in(seed, multihost.get_rank())
    return uniform_draw(torch.Generator(device=device).manual_seed(seed))


def make_detection_train_step(model: RCNN, optimizer_cfg: dict,
                              scheduler_cfg: Optional[dict] = None,
                              steps_per_epoch: int = 1,
                              warmup_iters: int = 0,
                              compute_dtype: torch.dtype = torch.bfloat16,
                              draw: Optional[Draw] = None,
                              seed: int = 0) -> DetectionStep:
    """The step over the model's parameters that ``requires_grad``; the
    samplers draw from a ``torch.Generator`` on the model's device unless
    ``draw`` is given, seeded with ``seed`` (one rank) or with
    ``multihost.fold_in(seed, rank)``."""
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer, schedule = build_optimizer(trainable, optimizer_cfg,
                                          scheduler_cfg, steps_per_epoch,
                                          warmup_iters)
    if draw is None:
        draw = seeded_draw(model, seed)
    return DetectionStep(model, optimizer, schedule, compute_dtype, draw)
