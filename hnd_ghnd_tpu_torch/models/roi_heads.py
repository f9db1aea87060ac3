"""RoI heads, box branch: eval and training.

Counterpart of hnd_ghnd_tpu/models/roi_heads.py (torchvision 0.4.2
RoIHeads as the reference configures it): 7x7 RoIAlign over P2..P5,
TwoMLPHead 12544 -> 1024 -> 1024 on the channel-major flatten, the
FastRCNNPredictor, then per image softmax, box decode (10, 10, 5, 5),
clip, score > 0.05 and small-box masks, a stable top-4096 trim, per-class
NMS at 0.5 and the top 100 detections.

Training (roi_heads.py:332-421): the GT boxes are appended to the
proposals, matched at IoU 0.5/0.5, 512 sampled per image at 25% positive
and gathered sampled-first by a stable sort; the pooled samples go through
``roi_align_train`` (the forward and backward kernels on the card), and
the classification and box losses are normalised by the sampled count of
the whole batch, as torchvision's fastrcnn_loss is.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import Linear
from hnd_ghnd_tpu_torch.models.rpn import Draw, balanced_sample, smooth_l1
from hnd_ghnd_tpu_torch.ops import boxes as box_ops
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.ops.roi_align_kernels import roi_align, roi_align_train

# the reference's eval settings (torchvision 0.4.2 RoIHeads, rcnn.py)
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCORE_THRESH = 0.05
NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
BOX_POOL_SIZE = 7
# candidates kept before the O(N^2) class NMS (as in the JAX package)
NMS_CANDIDATES = 4096
# the reference's training settings (rcnn.py:152-158)
FG_IOU_THRESH = 0.5
BG_IOU_THRESH = 0.5
BATCH_SIZE_PER_IMAGE = 512
POSITIVE_FRACTION = 0.25


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, rep_size: int = 1024):
        super().__init__()
        self.fc6 = Linear(in_features, rep_size)
        self.fc7 = Linear(rep_size, rep_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [R, P, P, C] -> [R, rep], flattened channel-major (torch order)."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes)
        self.bbox_pred = Linear(in_features, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class RoIHeads(nn.Module):
    def __init__(self, num_classes: int = 91, out_channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.box_head = TwoMLPHead(out_channels * BOX_POOL_SIZE ** 2)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)

    def box_logits(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
                   prop_valid: torch.Tensor, image_shape: Tuple[int, int],
                   pool=roi_align):
        """Pool P2..P5 (NCHW maps) at the proposals with ``pool`` and run
        the box head: (class logits [B, R, K], box deltas [B, R, 4K])."""
        b, r = proposals.shape[:2]
        # NHWC for the kernel: one copy per NCHW map
        levels = [f.permute(0, 2, 3, 1).contiguous() for f in feats[:4]]
        pooled = pool(levels, proposals, image_shape, BOX_POOL_SIZE,
                      boxes_valid=prop_valid)
        rep = self.box_head(pooled.reshape((b * r,) + pooled.shape[2:]))
        cls, deltas = self.box_predictor(rep)
        return cls.reshape(b, r, -1), deltas.reshape(b, r, -1)

    def infer(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
              prop_valid: torch.Tensor, image_sizes: torch.Tensor,
              image_shape: Tuple[int, int]):
        """Fixed-shape detections: boxes [B, D, 4], scores [B, D],
        labels [B, D], valid [B, D]."""
        b, r = proposals.shape[:2]
        ncls = self.num_classes
        all_cls, all_deltas = self.box_logits(feats, proposals, prop_valid,
                                              image_shape)
        scores = torch.softmax(all_cls, dim=-1)  # [B, R, K]
        boxes = box_ops.decode(all_deltas.reshape(b, r, ncls, 4),
                               proposals[:, :, None, :], BOX_CODER_WEIGHTS)
        boxes = box_ops.clip_to_image(boxes, image_sizes[:, None, None, :])

        # drop the background column; flatten [R, K-1] per image
        fg_boxes = boxes[:, :, 1:, :].reshape(b, -1, 4)
        fg_scores = scores[:, :, 1:].reshape(b, -1)
        fg_labels = torch.arange(1, ncls, dtype=torch.int64,
                                 device=boxes.device).repeat(r)
        cand_valid = (prop_valid[:, :, None]
                      & (scores[:, :, 1:] > SCORE_THRESH)
                      & box_ops.small_box_mask(boxes[:, :, 1:, :], 1e-2)
                      ).reshape(b, -1)

        cap = min(NMS_CANDIDATES, fg_scores.shape[1])
        neg_inf = torch.finfo(fg_scores.dtype).min
        trim_scores, trim_idx = nms_ops.stable_topk(
            torch.where(cand_valid, fg_scores,
                        torch.full_like(fg_scores, neg_inf)), cap)
        t_boxes = torch.gather(fg_boxes, 1, trim_idx[..., None].expand(-1, -1, 4))
        t_labels = fg_labels[trim_idx]
        t_valid = trim_scores > neg_inf

        keep_idx, keep_ok = nms_ops.batched_nms(
            t_boxes, trim_scores, t_labels, NMS_THRESH, DETECTIONS_PER_IMG,
            t_valid)
        det_boxes = torch.gather(t_boxes, 1, keep_idx[..., None].expand(-1, -1, 4))
        det_scores = torch.where(keep_ok, torch.gather(trim_scores, 1, keep_idx),
                                 torch.zeros_like(keep_ok, dtype=trim_scores.dtype))
        det_labels = torch.where(keep_ok, torch.gather(t_labels, 1, keep_idx),
                                 torch.zeros_like(keep_idx))
        return {"boxes": det_boxes, "scores": det_scores,
                "labels": det_labels.to(torch.int32), "valid": keep_ok}

    def select_training_samples(self, proposals: torch.Tensor,
                                prop_valid: torch.Tensor,
                                targets: Dict[str, torch.Tensor], draw: Draw):
        """(boxes [B, S, 4], labels [B, S] int64, regression targets
        [B, S, 4], positive [B, S], sampled [B, S], matched GT [B, S]) for
        S = 512: the sampled slots first, in proposal order."""
        gt_boxes = targets["boxes"]
        gt_valid = targets["boxes_valid"]
        all_boxes = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
        all_valid = torch.cat([prop_valid, gt_valid], dim=1)
        iou = box_ops.pairwise_iou(gt_boxes, all_boxes)          # [B, G, M]
        neg_one = torch.full((), -1.0, dtype=iou.dtype, device=iou.device)
        iou = torch.where(gt_valid[:, :, None], iou, neg_one)
        iou = torch.where(all_valid[:, None, :], iou, neg_one)
        best_iou, _ = iou.max(dim=1)
        best_gt = iou.argmax(dim=1)                               # [B, M]
        is_fg = best_iou >= FG_IOU_THRESH
        is_bg = (best_iou < BG_IOU_THRESH) & all_valid
        one = torch.ones_like(best_iou)
        labels01 = torch.where(is_fg, one, torch.where(
            is_bg, torch.zeros_like(one), -one))
        pos, neg = balanced_sample(labels01, BATCH_SIZE_PER_IMAGE,
                                   POSITIVE_FRACTION, draw(labels01.shape),
                                   draw(labels01.shape))
        sampled = (pos + neg) > 0
        # sampled first, stable (jnp.argsort(~sampled))
        _, order = torch.sort((~sampled).to(torch.uint8), dim=1, stable=True)
        sel = order[:, :BATCH_SIZE_PER_IMAGE]
        sel_boxes = torch.gather(all_boxes, 1, sel[..., None].expand(-1, -1, 4))
        sel_pos = torch.gather(pos, 1, sel) > 0
        sel_on = torch.gather(sampled, 1, sel)
        sel_gt = torch.gather(best_gt, 1, sel)
        cls = torch.where(sel_pos, torch.gather(targets["labels"].long(), 1,
                                                sel_gt),
                          torch.zeros_like(sel_gt))
        matched = torch.gather(gt_boxes, 1, sel_gt[..., None].expand(-1, -1, 4))
        reg = box_ops.encode(matched, sel_boxes, BOX_CODER_WEIGHTS)
        return sel_boxes, cls, reg, sel_pos, sel_on, sel_gt

    def loss(self, feats: Sequence[torch.Tensor], image_shape: Tuple[int, int],
             sampled) -> Dict[str, torch.Tensor]:
        """{loss_classifier, loss_box_reg}: cross-entropy summed over the
        sampled slots and smooth-L1 (beta 1) over the positive ones, both
        over the sampled count of the whole batch."""
        sel_boxes, cls, reg, sel_pos, sel_on, _ = sampled
        b, r = sel_boxes.shape[:2]
        all_cls, all_deltas = self.box_logits(feats, sel_boxes, sel_on,
                                              image_shape, roi_align_train)
        logp = torch.log_softmax(all_cls, dim=-1)
        ce = -torch.gather(logp, 2, cls[..., None])[..., 0]
        on = sel_on.float()
        deltas = all_deltas.reshape(b, r, self.num_classes, 4)
        sel_deltas = torch.gather(
            deltas, 2, cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        l1 = smooth_l1(sel_deltas, reg, 1.0).sum(-1)
        n_total = torch.clamp(on.sum(), min=1.0)
        return {"loss_classifier": (ce * on).sum() / n_total,
                "loss_box_reg": (l1 * sel_pos.float()).sum() / n_total}
