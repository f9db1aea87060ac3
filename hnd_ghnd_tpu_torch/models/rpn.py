"""Region Proposal Network, eval path.

Counterpart of hnd_ghnd_tpu/models/rpn.py (torchvision 0.4.2 RPN as the
reference configures it): a shared 3x3 conv with 1x1 objectness and delta
heads over P2..P6; per level the top ``pre_nms_top_n`` anchors by
objectness, decoded, clipped, small boxes masked and NMS'd within the
level; then the top ``post_nms_top_n`` survivors over all levels.  Top-k
is a stable sort, so ties keep the lower index first as jax.lax.top_k does
(padded bucket regions give exactly equal objectness).
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.ops import boxes as box_ops
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.ops.anchors import (DEFAULT_ANCHOR_SIZES,
                                            DEFAULT_ASPECT_RATIOS, grid_anchors)


# the reference's eval settings (torchvision 0.4.2 RPN as rcnn.py builds it)
PRE_NMS_TOP_N = 1000
POST_NMS_TOP_N = 1000
NMS_THRESH = 0.7
MIN_SIZE = 1e-3


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
        self.conv = nn.Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = nn.Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = nn.Conv2d(in_channels, 4 * num_anchors, 1)

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
                image_shape: Tuple[int, int]):
        """-> (proposals [B, post_nms, 4], proposal_valid [B, post_nms])."""
        obj_lvls, delta_lvls = self.head(feats)
        anchors = _anchors(tuple(tuple(f.shape[-2:]) for f in feats),
                           tuple(image_shape), image_sizes.device)
        boxes, scores, valid = [], [], []
        for o, d, anc in zip(obj_lvls, delta_lvls, anchors):
            k = min(PRE_NMS_TOP_N, o.shape[1])
            top_s, idx = nms_ops.stable_topk(o, k)
            sel_anchors = anc[idx]
            sel_deltas = torch.gather(d, 1, idx[..., None].expand(-1, -1, 4))
            bx = box_ops.clip_to_image(box_ops.decode(sel_deltas, sel_anchors),
                                       image_sizes[:, None, :])
            boxes.append(bx)
            scores.append(top_s)
            valid.append(box_ops.small_box_mask(bx, MIN_SIZE))
        # per-level NMS is exactly the level-categorized batched NMS
        keep = torch.cat(nms_ops.nms_keep_masks(boxes, scores, NMS_THRESH,
                                                valid), dim=1)
        boxes = torch.cat(boxes, dim=1)
        scores = torch.cat(scores, dim=1)
        neg_inf = torch.finfo(scores.dtype).min
        masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
        top_s, top_idx = nms_ops.stable_topk(masked, POST_NMS_TOP_N)
        proposals = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
        return proposals, top_s > neg_inf
