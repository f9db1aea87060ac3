"""Region Proposal Network: proposals, and the losses of training.

Counterpart of hnd_ghnd_tpu/models/rpn.py (torchvision 0.4.2 RPN as the
reference configures it): a shared 3x3 conv with 1x1 objectness and delta
heads over P2..P6; per level the top ``pre_nms_top_n`` anchors by
objectness, decoded, clipped, small boxes masked and NMS'd within the
level; then the top ``post_nms_top_n`` survivors over all levels (1000 and
1000 at eval, 2000 and 2000 in training).  Top-k is a stable sort, so ties
keep the lower index first as jax.lax.top_k does (padded bucket regions
give exactly equal objectness).  Proposals carry no gradient.

``loss`` is the JAX package's (rpn.py:159-201): anchors matched at IoU
0.7/0.3 with the best anchors of each GT forced to foreground, 256 anchors
sampled per image at <= 50% positive, BCE-with-logits on the sampled
objectness and smooth-L1 (beta 1/9) on the positive regressions, both over
the sampled count of the whole batch.  The sampler's uniform draws are
inputs (``draw``), so a test can hand it JAX's.  Dtypes promote as in JAX:
bfloat16 logits against float32 labels and targets give float32 losses.
The BCE of bfloat16 objectness is computed in float32: inside JAX's jitted
step XLA keeps the whole fused BCE and its sum in float32 (excess
precision), where op-by-op bfloat16 rounding of log1p(exp(-|x|)) moves the
loss by ~1e-3 of its value on the near-zero logits of a seeded model.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import Conv2d
from hnd_ghnd_tpu_torch.ops import boxes as box_ops
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.ops.anchors import (DEFAULT_ANCHOR_SIZES,
                                            DEFAULT_ASPECT_RATIOS, grid_anchors)


# the reference's settings (torchvision 0.4.2 RPN as rcnn.py builds it):
# proposal counts at eval and in training
PRE_NMS_TOP_N = 1000
POST_NMS_TOP_N = 1000
PRE_NMS_TOP_N_TRAIN = 2000
POST_NMS_TOP_N_TRAIN = 2000
NMS_THRESH = 0.7
MIN_SIZE = 1e-3
FG_IOU_THRESH = 0.7
BG_IOU_THRESH = 0.3
BATCH_SIZE_PER_IMAGE = 256
POSITIVE_FRACTION = 0.5
BOX_BETA = 1.0 / 9.0

# uniform [0, 1) draws of a given shape (float32, on the model's device)
Draw = Callable[[Tuple[int, ...]], torch.Tensor]


@functools.lru_cache(maxsize=16)
def _anchors(grid_sizes: Tuple[Tuple[int, int], ...],
             image_shape: Tuple[int, int], device: torch.device):
    """Per-level anchors on ``device``, made once per bucket: a copy from
    pageable host memory would block the host on every forward."""
    return [torch.as_tensor(a, device=device) for a in grid_anchors(
        grid_sizes, image_shape, DEFAULT_ANCHOR_SIZES, DEFAULT_ASPECT_RATIOS)]


class RPNHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.num_anchors = num_anchors
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = Conv2d(in_channels, 4 * num_anchors, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level: objectness [B, HWA] and deltas [B, HWA, 4], position-
        major / anchor-minor like ops.anchors.grid_anchors."""
        obj, deltas = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            b = f.shape[0]
            obj.append(self.cls_logits(t).permute(0, 2, 3, 1).reshape(b, -1))
            deltas.append(
                self.bbox_pred(t).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return obj, deltas


class RPN(nn.Module):
    def __init__(self):
        super().__init__()
        self.head = RPNHead(num_anchors=len(DEFAULT_ASPECT_RATIOS[0]))

    def propose(self, feats: Sequence[torch.Tensor], image_sizes: torch.Tensor,
                image_shape: Tuple[int, int], training: bool = False):
        """-> (proposals [B, post_nms, 4], proposal_valid [B, post_nms],
        (objectness, deltas, anchors) per level for ``loss``)."""
        pre_nms = PRE_NMS_TOP_N_TRAIN if training else PRE_NMS_TOP_N
        post_nms = POST_NMS_TOP_N_TRAIN if training else POST_NMS_TOP_N
        obj_lvls, delta_lvls = self.head(feats)
        anchors = _anchors(tuple(tuple(f.shape[-2:]) for f in feats),
                           tuple(image_shape), image_sizes.device)
        boxes, scores, valid = [], [], []
        for o, d, anc in zip(obj_lvls, delta_lvls, anchors):
            o, d = o.detach(), d.detach()
            k = min(pre_nms, o.shape[1])
            top_s, idx = nms_ops.stable_topk(o, k)
            sel_anchors = anc[idx]
            sel_deltas = torch.gather(d, 1, idx[..., None].expand(-1, -1, 4))
            bx = box_ops.clip_to_image(box_ops.decode(sel_deltas, sel_anchors),
                                       image_sizes[:, None, :])
            boxes.append(bx)
            scores.append(top_s)
            valid.append(box_ops.small_box_mask(bx, MIN_SIZE))
        # per-level NMS, all levels in one call: levels never suppress
        # each other
        sizes = [bx.shape[1] for bx in boxes]
        boxes = torch.cat(boxes, dim=1)
        scores = torch.cat(scores, dim=1)
        keep = nms_ops.nms_keep_levels(boxes, scores, NMS_THRESH,
                                       torch.cat(valid, dim=1), sizes)
        neg_inf = torch.finfo(scores.dtype).min
        masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
        top_s, top_idx = nms_ops.stable_topk(masked, post_nms)
        proposals = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        return proposals, top_s > neg_inf, (obj_lvls, delta_lvls, anchors)

    def loss(self, raw, targets: Dict[str, torch.Tensor],
             draw: Draw) -> Dict[str, torch.Tensor]:
        """{loss_objectness, loss_rpn_box_reg} from ``propose``'s raw
        outputs; targets: boxes [B, G, 4], boxes_valid [B, G]."""
        obj_lvls, delta_lvls, anchors = raw
        objectness = torch.cat(obj_lvls, dim=1)    # [B, N]
        deltas = torch.cat(delta_lvls, dim=1)      # [B, N, 4]
        anchors = torch.cat(anchors, dim=0)        # [N, 4]
        labels, matched = match_anchors(
            anchors, targets["boxes"], targets["boxes_valid"], FG_IOU_THRESH,
            BG_IOU_THRESH, allow_low_quality=True)
        pos, neg = balanced_sample(labels, BATCH_SIZE_PER_IMAGE,
                                   POSITIVE_FRACTION, draw(labels.shape),
                                   draw(labels.shape))
        reg_targets = box_ops.encode(matched, anchors)
        box_sum = (smooth_l1(deltas, reg_targets, BOX_BETA).sum(-1)
                   * pos).sum()
        sampled = pos + neg
        obj = objectness.to(torch.promote_types(objectness.dtype,
                                                torch.float32))
        obj_sum = (bce_logits(obj, labels) * sampled).sum()
        n_total = torch.clamp(sampled.sum(), min=1.0)
        return {"loss_objectness": obj_sum / n_total,
                "loss_rpn_box_reg": box_sum / n_total}


def match_anchors(anchors: torch.Tensor, gt: torch.Tensor,
                  gt_valid: torch.Tensor, fg_thresh: float, bg_thresh: float,
                  allow_low_quality: bool):
    """torchvision Matcher semantics as masks, batched: anchors [N, 4] or
    [B, N, 4], gt [B, G, 4] -> (labels [B, N] float32: 1 fg, 0 bg, -1
    ignored; matched GT boxes [B, N, 4]).  Ties take the first GT, as
    ``jnp.argmax`` does; an image without a valid GT is all background."""
    iou = box_ops.pairwise_iou(gt, anchors)                # [B, G, N]
    neg_one = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
    iou = torch.where(gt_valid[:, :, None], iou, neg_one)
    best_iou, _ = iou.max(dim=1)
    best_gt = iou.argmax(dim=1)                            # [B, N]
    one = torch.ones_like(best_iou)
    labels = torch.where(best_iou >= fg_thresh, one,
                         torch.where(best_iou < bg_thresh,
                                     torch.zeros_like(one), -one))
    if allow_low_quality:
        best_per_gt = iou.amax(dim=2, keepdim=True)         # [B, G, 1]
        is_best = (iou == best_per_gt) & gt_valid[:, :, None] & (best_per_gt > 0)
        labels = torch.where(is_best.any(dim=1), one, labels)
    labels = torch.where(gt_valid.any(dim=1, keepdim=True), labels,
                         torch.zeros_like(labels))
    matched = torch.gather(
        gt, 1, best_gt.clamp(0, gt.shape[1] - 1)[..., None].expand(-1, -1, 4))
    return labels, matched


def balanced_sample(labels: torch.Tensor, batch_size: int,
                    pos_fraction: float, r_pos: torch.Tensor,
                    r_neg: torch.Tensor):
    """BalancedPositiveNegativeSampler as masks, per row of labels [B, N]:
    up to ``batch_size * pos_fraction`` positives and the rest negatives,
    each set the entries with the smallest uniform draws ``r_pos`` /
    ``r_neg`` [B, N] (a stable sort, like ``jnp.argsort``).  Returns
    (positive, negative) float32 masks [B, N]."""
    n = labels.shape[1]
    is_pos = labels == 1.0
    is_neg = labels == 0.0
    num_pos = torch.clamp(is_pos.sum(1, keepdim=True),
                          max=int(batch_size * pos_fraction))
    num_neg = torch.minimum(is_neg.sum(1, keepdim=True), batch_size - num_pos)

    def pick(mask, count, r):
        r = torch.where(mask, r, torch.full_like(r, 2.0))  # invalid sort last
        order = torch.argsort(r, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=r.device).expand_as(order))
        return ((rank < count) & mask).float()

    return pick(is_pos, num_pos, r_pos), pick(is_neg, num_neg, r_neg)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, in JAX's operation order."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """jax.nn.log_softmax's operations, each in ``x``'s dtype (bfloat16
    logits round after every one, as JAX's do; torch.log_softmax rounds
    once): the max without a gradient, the shift, exp, sum, log."""
    shifted = x - x.amax(dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim, keepdim=True))
