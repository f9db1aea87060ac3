"""Box primitives in corner format (x1, y1, x2, y2).

Counterpart of hnd_ghnd_tpu/ops/boxes.py (torchvision 0.4.2 BoxCoder and
box_iou semantics), operation for operation.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

# torchvision BoxCoder clamp: log(1000 / 16)
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., M, 4] -> [..., N, M]; zero where the union is 0."""
    a1 = area(boxes1)
    a2 = area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode(reference_boxes: torch.Tensor, proposals: torch.Tensor,
           weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
           ) -> torch.Tensor:
    """Regression targets [..., 4] (dx, dy, dw, dh) of ``reference_boxes``
    relative to ``proposals``; degenerate widths and heights (padding)
    divide by 1 and are masked downstream."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0]
    ex_h = proposals[..., 3] - proposals[..., 1]
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0]
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1]
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    one = torch.ones((), dtype=ex_w.dtype, device=ex_w.device)
    safe_w = torch.where(ex_w > 0, ex_w, one)
    safe_h = torch.where(ex_h > 0, ex_h, one)
    safe_gw = torch.where(gt_w > 0, gt_w, one)
    safe_gh = torch.where(gt_h > 0, gt_h, one)

    dx = wx * (gt_cx - ex_cx) / safe_w
    dy = wy * (gt_cy - ex_cy) / safe_h
    dw = ww * torch.log(safe_gw / safe_w)
    dh = wh * torch.log(safe_gh / safe_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode(deltas: torch.Tensor, boxes: torch.Tensor,
           weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
           ) -> torch.Tensor:
    """Apply regression deltas [..., 4] to boxes [..., 4]; dw/dh clamp at
    log(1000/16)."""
    wx, wy, ww, wh = weights
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(deltas[..., 3] / wh, max=BBOX_XFORM_CLIP)

    pred_cx = dx * w + cx
    pred_cy = dy * h + cy
    pred_w = torch.exp(dw) * w
    pred_h = torch.exp(dh) * h
    return torch.stack([pred_cx - 0.5 * pred_w, pred_cy - 0.5 * pred_h,
                        pred_cx + 0.5 * pred_w, pred_cy + 0.5 * pred_h], dim=-1)


def clip_to_image(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Clip to [0, W] x [0, H]; image_size [..., 2] as (h, w), broadcastable
    against the box batch dims."""
    h = image_size[..., 0].to(boxes.dtype)
    w = image_size[..., 1].to(boxes.dtype)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes: torch.Tensor, min_size: float) -> torch.Tensor:
    """True where width AND height are >= min_size."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w >= min_size) & (h >= min_size)
