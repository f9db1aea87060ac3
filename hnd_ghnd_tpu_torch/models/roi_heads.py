"""RoI heads: the box, mask and keypoint branches, for eval and training.

Counterpart of hnd_ghnd_tpu/models/roi_heads.py (torchvision 0.4.2
RoIHeads as the reference configures it): 7x7 RoIAlign over P2..P5,
TwoMLPHead 12544 -> 1024 -> 1024 on the channel-major flatten, the
FastRCNNPredictor, then per image softmax, box decode (10, 10, 5, 5),
clip, score > 0.05 and small-box masks, a stable top-4096 trim, per-class
NMS at 0.5 and the top 100 detections.

Mask R-CNN and Keypoint R-CNN (roi_heads.py:122-189, 298-327) pool the top
100 detections at 14x14 (invalid slots weighted 0) and run their heads
NCHW on cuDNN: the mask head's 4x (3x3 conv 256 + ReLU), deconv 2x2/2 +
ReLU and 1x1 conv give ``mask_probs`` [B, 100, 28, 28], the sigmoid of
each detection's label channel; the keypoint head's 8x (3x3 conv 512 +
ReLU), deconv 4x4/2 and a 2x bilinear resize give ``keypoint_logits``
[B, 100, 56, 56, K] for the host decode, or with ``kp_decode`` "device"
the argmax of each heatmap's cubic surface on a ``kp_decode_grid`` grid
(ops/kp_decode.py: ``kp_u``, ``kp_v``, ``kp_score`` [B, 100, K]).  With
``int8_pool`` the levels are quantized once per forward and every pooling
call shares those tables (roi_heads.py:242).

Training (roi_heads.py:332-421): the GT boxes are appended to the
proposals, matched at IoU 0.5/0.5, 512 sampled per image at 25% positive
and gathered sampled-first by a stable sort; the pooled samples go through
``roi_align_train`` (the forward and backward kernels on the card), and
the classification and box losses are normalised by the sampled count of
the whole batch, as torchvision's fastrcnn_loss is.  The mask and keypoint
losses (roi_heads.py:424-574) take the first 128 positives of each image,
pool them at 14x14 over the same NHWC tables (one copy of P2-P5 per
step), and normalise by the batch's positive count (the BCE of each RoI's
28x28 mask at its class channel against its GT mask projected from the
box-aligned 114x114 raster of the loader) or its count of visible
keypoints inside their box (the cross-entropy over the 56x56 grid), as
torchvision's maskrcnn_loss and keypointrcnn_loss are.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import Conv2d, ConvTranspose2d, Linear
from hnd_ghnd_tpu_torch.models.rpn import (Draw, balanced_sample, bce_logits,
                                           log_softmax, smooth_l1)
from hnd_ghnd_tpu_torch.ops import boxes as box_ops
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.ops.kp_decode import device_keypoint_argmax
from hnd_ghnd_tpu_torch.ops.roi_align import _bilinear_params
from hnd_ghnd_tpu_torch.ops.roi_align_kernels import (quantize_levels,
                                                      roi_align,
                                                      roi_align_train)

# the reference's eval settings (torchvision 0.4.2 RoIHeads, rcnn.py)
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
SCORE_THRESH = 0.05
NMS_THRESH = 0.5
DETECTIONS_PER_IMG = 100
BOX_POOL_SIZE = 7
MASK_POOL_SIZE = 14
KEYPOINT_POOL_SIZE = 14
# candidates kept before the O(N^2) class NMS (as in the JAX package)
NMS_CANDIDATES = 4096
# the reference's training settings (rcnn.py:152-158)
FG_IOU_THRESH = 0.5
BG_IOU_THRESH = 0.5
BATCH_SIZE_PER_IMAGE = 512
POSITIVE_FRACTION = 0.25
# positives per image that the mask and keypoint losses pool: at least the
# sampler's cap of 512 * 0.25
MAX_POSITIVES = 128


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


class MaskHead(nn.Module):
    """roi_heads.mask_head: 4x (3x3 conv 256 + ReLU)."""

    def __init__(self, in_channels: int):
        super().__init__()
        for i in range(4):
            self.add_module(f"mask_fcn{i + 1}",
                            Conv2d(in_channels if i == 0 else 256, 256, 3,
                                   padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.children():
            x = F.relu(conv(x))
        return x


class MaskPredictor(nn.Module):
    """roi_heads.mask_predictor: deconv 2x2/2 + ReLU, then a 1x1 conv to
    the classes: [R, 256, 14, 14] -> [R, K, 28, 28]."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(256, 256, 2, stride=2)
        self.mask_fcn_logits = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(F.relu(self.conv5_mask(x)))


def keypoint_head(in_channels: int) -> nn.Sequential:
    """roi_heads.keypoint_head: 8x (3x3 conv 512 + ReLU), the convs at the
    even indices of one Sequential, as torchvision's KeypointRCNNHeads."""
    mods = []
    for i in range(8):
        mods += [Conv2d(in_channels if i == 0 else 512, 512, 3, padding=1),
                 nn.ReLU()]
    return nn.Sequential(*mods)


class KeypointPredictor(nn.Module):
    """roi_heads.keypoint_predictor: deconv 4x4/2 pad 1 to the keypoints,
    then a 2x bilinear resize (align_corners=False): [R, 512, 14, 14] ->
    [R, K, 56, 56]."""

    def __init__(self, num_keypoints: int):
        super().__init__()
        self.kps_score_lowres = ConvTranspose2d(512, num_keypoints, 4,
                                                stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(self.kps_score_lowres(x), scale_factor=2,
                             mode="bilinear", align_corners=False)


class RoIHeads(nn.Module):
    """``kind`` faster_rcnn, mask_rcnn or keypoint_rcnn; ``int8_pool``:
    the eval pools int8 tables of P2-P5 (``params.int8_roi_pool``);
    ``kp_decode`` "host" (the heatmaps) or "device" (their argmax on a
    ``kp_decode_grid`` grid)."""

    def __init__(self, num_classes: int = 91, out_channels: int = 256,
                 kind: str = "faster_rcnn", num_keypoints: int = 17,
                 int8_pool: bool = False, kp_decode: str = "host",
                 kp_decode_grid: int = 224):
        super().__init__()
        if kp_decode not in ("host", "device"):
            raise ValueError(f"kp_decode `{kp_decode}` is not host or device")
        self.num_classes = num_classes
        self.kind = kind
        self.int8_pool = int8_pool
        self.kp_decode = kp_decode
        self.kp_decode_grid = int(kp_decode_grid)
        self.box_head = TwoMLPHead(out_channels * BOX_POOL_SIZE ** 2)
        self.box_predictor = FastRCNNPredictor(1024, num_classes)
        if kind == "mask_rcnn":
            self.mask_head = MaskHead(out_channels)
            self.mask_predictor = MaskPredictor(num_classes)
        elif kind == "keypoint_rcnn":
            self.keypoint_head = keypoint_head(out_channels)
            self.keypoint_predictor = KeypointPredictor(num_keypoints)
        elif kind != "faster_rcnn":
            raise KeyError(f"model name `{kind}` is not expected")

    def pool_tables(self, feats: Sequence[torch.Tensor], int8: bool):
        """(levels, quant) for pooling P2..P5 (NCHW maps): the levels as
        NHWC, one copy per map, and quant None; with ``int8`` the NHWC
        views uncopied (the pooling reads only their dtype) and the int8
        tables quantized from them."""
        views = [f.permute(0, 2, 3, 1) for f in feats[:4]]
        if int8:
            return views, quantize_levels(views)
        return [v.contiguous() for v in views], None

    def box_logits(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
                   prop_valid: torch.Tensor, image_shape: Tuple[int, int],
                   pool=roi_align, tables=None):
        """Pool P2..P5 (NCHW maps; or ``tables`` made of them by
        ``pool_tables``) at the proposals with ``pool`` and run the box
        head: (class logits [B, R, K], box deltas [B, R, 4K])."""
        b, r = proposals.shape[:2]
        levels, quant = (self.pool_tables(feats, int8=False) if tables is None
                         else tables)
        kw = {} if quant is None else {"quant": quant}
        pooled = pool(levels, proposals, image_shape, BOX_POOL_SIZE,
                      boxes_valid=prop_valid, **kw)
        rep = self.box_head(pooled.reshape((b * r,) + pooled.shape[2:]))
        cls, deltas = self.box_predictor(rep)
        return cls.reshape(b, r, -1), deltas.reshape(b, r, -1)

    def head_outputs(self, tables, boxes: torch.Tensor, valid: torch.Tensor,
                     labels: torch.Tensor, image_shape: Tuple[int, int]
                     ) -> Dict[str, torch.Tensor]:
        """The mask or keypoint branch on detections ``boxes`` [B, D, 4]
        (``valid`` [B, D], ``labels`` [B, D]) over ``pool_tables``:
        {mask_probs [B, D, 28, 28]}, {keypoint_logits [B, D, 56, 56, K]}
        or with ``kp_decode`` "device" {kp_u, kp_v, kp_score [B, D, K]};
        {} for a Faster R-CNN."""
        if self.kind == "faster_rcnn":
            return {}
        levels, quant = tables
        b, d = boxes.shape[:2]
        size = (MASK_POOL_SIZE if self.kind == "mask_rcnn"
                else KEYPOINT_POOL_SIZE)
        pooled = roi_align(levels, boxes, image_shape, size,
                           boxes_valid=valid, quant=quant)
        # one NCHW copy of the pooled RoIs for cuDNN
        x = pooled.reshape((b * d,) + pooled.shape[2:]).permute(0, 3, 1, 2)
        x = x.contiguous()
        if self.kind == "mask_rcnn":
            logits = self.mask_predictor(self.mask_head(x))  # [BD, K, 28, 28]
            idx = labels.reshape(-1).long()[:, None, None, None].expand(
                -1, 1, *logits.shape[2:])
            sel = torch.gather(logits, 1, idx)[:, 0]
            return {"mask_probs": torch.sigmoid(sel).reshape(
                (b, d) + sel.shape[1:])}
        kp = self.keypoint_predictor(self.keypoint_head(x))  # [BD, K, 56, 56]
        logits = kp.permute(0, 2, 3, 1).reshape(
            (b, d) + kp.shape[2:] + kp.shape[1:2])
        if self.kp_decode == "device":
            u, v, score = device_keypoint_argmax(logits, self.kp_decode_grid)
            return {"kp_u": u, "kp_v": v, "kp_score": score}
        return {"keypoint_logits": logits}

    def infer(self, feats: Sequence[torch.Tensor], proposals: torch.Tensor,
              prop_valid: torch.Tensor, image_sizes: torch.Tensor,
              image_shape: Tuple[int, int]):
        """Fixed-shape detections: boxes [B, D, 4], scores [B, D],
        labels [B, D], valid [B, D], and ``head_outputs``."""
        b, r = proposals.shape[:2]
        ncls = self.num_classes
        # the int8 tables are quantized once and shared by every pooling
        tables = self.pool_tables(feats, self.int8_pool)
        all_cls, all_deltas = self.box_logits(feats, proposals, prop_valid,
                                              image_shape, tables=tables)
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
        det_labels = det_labels.to(torch.int32)
        return {"boxes": det_boxes, "scores": det_scores,
                "labels": det_labels, "valid": keep_ok,
                **self.head_outputs(tables, det_boxes, keep_ok, det_labels,
                                    image_shape)}

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
             sampled, tables=None) -> Dict[str, torch.Tensor]:
        """{loss_classifier, loss_box_reg}: cross-entropy summed over the
        sampled slots and smooth-L1 (beta 1) over the positive ones, both
        over the sampled count of the whole batch.  ``tables``: the
        ``pool_tables`` of ``feats``, made here when None."""
        sel_boxes, cls, reg, sel_pos, sel_on, _ = sampled
        b, r = sel_boxes.shape[:2]
        all_cls, all_deltas = self.box_logits(feats, sel_boxes, sel_on,
                                              image_shape, roi_align_train,
                                              tables)
        logp = log_softmax(all_cls)
        ce = -torch.gather(logp, 2, cls[..., None])[..., 0]
        on = sel_on.float()
        deltas = all_deltas.reshape(b, r, self.num_classes, 4)
        sel_deltas = torch.gather(
            deltas, 2, cls[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
        l1 = smooth_l1(sel_deltas, reg, 1.0).sum(-1)
        n_total = torch.clamp(on.sum(), min=1.0)
        return {"loss_classifier": (ce * on).sum() / n_total,
                "loss_box_reg": (l1 * sel_pos.float()).sum() / n_total}

    @staticmethod
    def select_positives(sampled, max_pos: int = MAX_POSITIVES):
        """(boxes [B, P, 4], labels [B, P], positive [B, P], matched GT
        [B, P]) of the first ``max_pos`` sample slots of each image, the
        positives first (stable, jnp.argsort(~pos))."""
        sel_boxes, cls, _, sel_pos, _, sel_gt = sampled
        _, order = torch.sort((~sel_pos).to(torch.uint8), dim=1, stable=True)
        idx = order[:, :max_pos]
        return (torch.gather(sel_boxes, 1, idx[..., None].expand(-1, -1, 4)),
                torch.gather(cls, 1, idx), torch.gather(sel_pos, 1, idx),
                torch.gather(sel_gt, 1, idx))

    def _pool_positives(self, feats, image_shape, sampled, tables, size):
        """The positives' 14x14 pooling (invalid slots weighted 0) as one
        NCHW batch for cuDNN: (x [B*P, C, 14, 14], boxes, labels, positive,
        matched GT)."""
        boxes, labels, pos, gt_idx = self.select_positives(sampled)
        levels, _ = (self.pool_tables(feats, int8=False) if tables is None
                     else tables)
        pooled = roi_align_train(levels, boxes, image_shape, size,
                                 boxes_valid=pos)
        b, p = boxes.shape[:2]
        x = pooled.reshape((b * p,) + pooled.shape[2:]).permute(0, 3, 1, 2)
        return x.contiguous(), boxes, labels, pos, gt_idx

    def mask_loss(self, feats: Sequence[torch.Tensor],
                  image_shape: Tuple[int, int], sampled,
                  gt_boxes: torch.Tensor, gt_mask_crops: torch.Tensor,
                  tables=None) -> Dict[str, torch.Tensor]:
        """{loss_mask}: the BCE of each positive's 28x28 mask logits at its
        class channel against its GT mask projected onto the proposal
        (``project_boxes_on_crops`` of ``gt_mask_crops`` [B, G, 114, 114],
        the loader's box-aligned rasters), averaged over the 28x28 cells,
        summed over the positives and divided by the batch's positive count
        (torchvision maskrcnn_loss).  The BCE is in the logits' dtype where
        JAX's is (rpn.bce_logits), promoted by the float32 targets."""
        x, boxes, labels, pos, gt_idx = self._pool_positives(
            feats, image_shape, sampled, tables, MASK_POOL_SIZE)
        b = boxes.shape[0]
        logits = self.mask_predictor(self.mask_head(x))  # [BP, K, 28, 28]
        m = logits.shape[-1]
        idx = labels.reshape(-1)[:, None, None, None].expand(-1, 1, m, m)
        sel = torch.gather(logits, 1, idx)[:, 0]          # [BP, 28, 28]
        g = gt_mask_crops.shape[1]
        own = (torch.arange(b, device=gt_idx.device)[:, None] * g
               + gt_idx).reshape(-1)
        crops = gt_mask_crops.reshape((b * g,) + gt_mask_crops.shape[2:])
        targets = project_boxes_on_crops(crops[own].to(torch.float32),
                                         gt_boxes.reshape(-1, 4)[own],
                                         boxes.reshape(-1, 4), m)
        per_roi = bce_logits(sel, targets).mean(dim=(1, 2))
        posf = pos.reshape(-1).to(torch.float32)
        return {"loss_mask": (per_roi * posf).sum()
                / torch.clamp(posf.sum(), min=1.0)}

    def keypoint_loss(self, feats: Sequence[torch.Tensor],
                      image_shape: Tuple[int, int], sampled,
                      gt_keypoints: torch.Tensor, tables=None
                      ) -> Dict[str, torch.Tensor]:
        """{loss_keypoint}: the cross-entropy over each positive's 56x56
        heatmap at each visible GT keypoint (``gt_keypoints`` [B, G, K, 3])
        inside the proposal, over the batch's count of such keypoints
        (torchvision keypointrcnn_loss).  The log-softmax is in the logits'
        dtype, as JAX's."""
        x, boxes, _, pos, gt_idx = self._pool_positives(
            feats, image_shape, sampled, tables, KEYPOINT_POOL_SIZE)
        b, p = boxes.shape[:2]
        kp = self.keypoint_predictor(self.keypoint_head(x))  # [BP, K, 56, 56]
        hm = kp.shape[-1]
        logits = kp.reshape(b, p, kp.shape[1], hm * hm)
        own = torch.gather(gt_keypoints, 1, gt_idx[..., None, None].expand(
            -1, -1, *gt_keypoints.shape[2:]))                  # [B, P, K, 3]
        x1, y1 = boxes[..., 0:1], boxes[..., 1:2]
        w = torch.clamp(boxes[..., 2:3] - x1, min=1e-6)
        h = torch.clamp(boxes[..., 3:4] - y1, min=1e-6)
        gx = torch.floor((own[..., 0] - x1) * hm / w)
        gy = torch.floor((own[..., 1] - y1) * hm / h)
        inside = (gx >= 0) & (gx < hm) & (gy >= 0) & (gy < hm)
        # the boundary snap of torchvision keypoints_to_heatmap, after the
        # inside test
        gx = gx.clamp(0, hm - 1)
        gy = gy.clamp(0, hm - 1)
        valid = inside & (own[..., 2] > 0) & pos[..., None]
        target = (gy * hm + gx).long()                         # [B, P, K]
        logp = log_softmax(logits)
        ce = -torch.gather(logp, 3, target[..., None])[..., 0]
        vf = valid.to(torch.float32)
        return {"loss_keypoint": (ce * vf).sum()
                / torch.clamp(vf.sum(), min=1.0)}


def project_boxes_on_crops(crops: torch.Tensor, gt_boxes: torch.Tensor,
                           boxes: torch.Tensor, out_size: int,
                           sampling_ratio: int = 2) -> torch.Tensor:
    """The [P, out, out] mask targets of proposals ``boxes`` [P, 4] on
    their GTs' box-aligned rasters ``crops`` [P, R+2, R+2] (each GT's mask
    resampled into an R x R grid over its box ``gt_boxes`` [P, 4], pixel
    centres at gy1 + (u + 0.5) * gh / R, with a 1px zero border): the
    RoIAlign sample points of torchvision's project_masks_on_boxes,
    ``sampling_ratio`` squared per bin, evaluated on the raster.  JAX's
    ``_project_boxes_on_crops``, over all P at once."""
    p, rp, _ = crops.shape
    r = rp - 2
    s = sampling_ratio
    dev = crops.device
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = torch.clamp(x2 - x1, min=1.0) / out_size
    bin_h = torch.clamp(y2 - y1, min=1.0) / out_size
    bins = torch.arange(out_size, dtype=torch.float32, device=dev)
    samp = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    ys = (y1[:, None, None] + bins[None, :, None] * bin_h[:, None, None]
          + samp[None, None, :] * bin_h[:, None, None])      # [P, out, s]
    xs = (x1[:, None, None] + bins[None, :, None] * bin_w[:, None, None]
          + samp[None, None, :] * bin_w[:, None, None])
    gw = torch.clamp(gt_boxes[:, 2] - gt_boxes[:, 0], min=1.0)
    gh = torch.clamp(gt_boxes[:, 3] - gt_boxes[:, 1], min=1.0)
    # image point -> padded-raster coordinate (crop[u + 1] sits at image
    # y = gy1 + (u + 0.5) * gh / R)
    u = (ys - gt_boxes[:, 1, None, None]) * r / gh[:, None, None] + 0.5
    v = (xs - gt_boxes[:, 0, None, None]) * r / gw[:, None, None] + 0.5
    size = torch.tensor(float(rp), device=dev)
    y_lo, y_hi, wy_lo, wy_hi, y_ok = _bilinear_params(u, size)
    x_lo, x_hi, wx_lo, wx_hi, x_ok = _bilinear_params(v, size)
    ok = (y_ok.to(torch.float32)[:, :, :, None, None]
          * x_ok.to(torch.float32)[:, None, None, :, :])
    flat = crops.reshape(p, rp * rp)
    acc = None
    for yi, wy in ((y_lo, wy_lo), (y_hi, wy_hi)):
        for xi, wx in ((x_lo, wx_lo), (x_hi, wx_hi)):
            idx = (yi[:, :, :, None, None] * rp
                   + xi[:, None, None, :, :]).reshape(p, -1)
            vals = torch.gather(flat, 1, idx).reshape(idx.shape[:1]
                                                      + yi.shape[1:]
                                                      + xi.shape[1:])
            wgt = wy[:, :, :, None, None] * wx[:, None, None, :, :] * ok
            acc = vals * wgt if acc is None else acc + vals * wgt
    return acc.mean(dim=(2, 4))  # the s x s samples of each bin
