"""RoI heads, box branch, eval path.

Counterpart of hnd_ghnd_tpu/models/roi_heads.py (torchvision 0.4.2
RoIHeads as the reference configures it): 7x7 RoIAlign over P2..P5,
TwoMLPHead 12544 -> 1024 -> 1024 on the channel-major flatten, the
FastRCNNPredictor, then per image softmax, box decode (10, 10, 5, 5),
clip, score > 0.05 and small-box masks, a stable top-4096 trim, per-class
NMS at 0.5 and the top 100 detections.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.ops import boxes as box_ops
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.ops.roi_align_kernels import roi_align

# the reference's eval settings (torchvision 0.4.2 RoIHeads, rcnn.py)
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCORE_THRESH = 0.05
NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
BOX_POOL_SIZE = 7
# candidates kept before the O(N^2) class NMS (as in the JAX package)
NMS_CANDIDATES = 4096


class TwoMLPHead(nn.Module):
    def __init__(self, in_features: int, rep_size: int = 1024):
        super().__init__()
        self.fc6 = nn.Linear(in_features, rep_size)
        self.fc7 = nn.Linear(rep_size, rep_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [R, P, P, C] -> [R, rep], flattened channel-major (torch order)."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FastRCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(in_features, num_classes)
        self.bbox_pred = nn.Linear(in_features, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class RoIHeads(nn.Module):
    def __init__(self, num_classes: int = 91, out_channels: int = 256):
        super().__init__()
        self.num_classes = num_classes
        self.box_head = TwoMLPHead(out_channels * BOX_POOL_SIZE ** 2)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)

    def box_logits(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
                   prop_valid: torch.Tensor, image_shape: Tuple[int, int]):
        """Pool P2..P5 (NCHW maps) at the proposals and run the box head:
        (class logits [B, R, K], box deltas [B, R, 4K])."""
        b, r = proposals.shape[:2]
        # NHWC for the kernel: one copy per NCHW map
        levels = [f.permute(0, 2, 3, 1).contiguous() for f in feats[:4]]
        pooled = roi_align(levels, proposals, image_shape, BOX_POOL_SIZE,
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
