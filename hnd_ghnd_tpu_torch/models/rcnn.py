"""Faster, Mask and Keypoint R-CNN meta-architecture: eval forward and the
training losses.

Counterpart of hnd_ghnd_tpu/models/rcnn.py (the reference's CustomRCNN):
normalize -> trunk (with the bottleneck as layer1) -> FPN -> RPN -> RoI
heads (with the mask or keypoint branch) -> boxes rescaled from the padded
bucket to each image's original size, ``boxes_model`` keeping the bucket's
coordinates for the host keypoint decode; in train mode (rcnn.py:156-178)
RPN proposals, the RPN loss, the RoI sampling and the RoI losses instead:
the box loss, and the mask or keypoint loss when the targets hold
``masks_crop`` or ``keypoints``, all three pooling one NHWC copy of P2-P5.
With the ext filter in the bottleneck, ``ext_training`` returns its output
alone, and ``ext_threshold`` gates the detections (JAX's
rcnn.py:187-193): an image whose probability of holding something is
below it keeps its detections' shapes with every ``valid`` off and every
score 0.
The batch keeps the JAX package's layout: images [B, H, W, 3] in [0, 1], in
the compute dtype.  The trunk runs contiguous NCHW: float32 cuDNN
convolutions have NCHW kernels only, and a channels_last trunk spends more
in their layout transposes than the NHWC copy of P2-P5 for the RoIAlign
kernel costs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from hnd_ghnd_tpu_torch.models.bottleneck import Bottleneck4LargeResNet
from hnd_ghnd_tpu_torch.models.fpn import FPN
from hnd_ghnd_tpu_torch.models.resnet import ResNetBody
from hnd_ghnd_tpu_torch.models.roi_heads import RoIHeads
from hnd_ghnd_tpu_torch.models.rpn import RPN, Draw

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@functools.lru_cache(maxsize=8)
def _mean_std(dtype: torch.dtype, device: torch.device):
    """Made once per device: a copy from host memory on every forward would
    block the host until the stream drains."""
    return (torch.tensor(IMAGE_MEAN, dtype=dtype, device=device),
            torch.tensor(IMAGE_STD, dtype=dtype, device=device))


class Backbone(nn.Module):
    def __init__(self, bottleneck: Optional[Bottleneck4LargeResNet]):
        super().__init__()
        self.body = ResNetBody(bottleneck)
        self.fpn = FPN(self.body.out_channels, 256)


class RCNN(nn.Module):
    """Module paths are the reference's: backbone.body.*, backbone.fpn.*,
    rpn.head.*, roi_heads.box_head.*, roi_heads.box_predictor.*, and
    roi_heads.mask_head.* with roi_heads.mask_predictor.* (``kind``
    mask_rcnn) or roi_heads.keypoint_head.* with
    roi_heads.keypoint_predictor.* (keypoint_rcnn).  A student has the
    bottleneck as layer1, a teacher (``bottleneck`` None) the stock
    ResNet-50 layer1.  ``int8_pool``: the eval pools int8 tables;
    ``kp_decode``/``kp_decode_grid``: the keypoint decode (RoIHeads);
    ``ext_threshold``: the gate of the bottleneck's ext filter (None: no
    gate)."""

    def __init__(self, bottleneck: Optional[Bottleneck4LargeResNet],
                 num_classes: int = 91, kind: str = "faster_rcnn",
                 num_keypoints: int = 17, int8_pool: bool = False,
                 kp_decode: str = "host", kp_decode_grid: int = 224,
                 ext_threshold: Optional[float] = None):
        super().__init__()
        self.kind = kind
        self.ext_threshold = ext_threshold
        self.backbone = Backbone(bottleneck)
        self.rpn = RPN()
        self.roi_heads = RoIHeads(num_classes, kind=kind,
                                  num_keypoints=num_keypoints,
                                  int8_pool=int8_pool, kp_decode=kp_decode,
                                  kp_decode_grid=kp_decode_grid)

    @staticmethod
    def normalize(images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] in [0, 1] -> standardized, contiguous NCHW."""
        mean, std = _mean_std(images.dtype, images.device)
        return ((images - mean) / std).permute(0, 3, 1, 2).contiguous()

    def backbone_features(self, images: torch.Tensor,
                          use_bottleneck_transformer: bool = False):
        """-> (body feats {layer1..layer4}, FPN maps [P2..P6]), NCHW."""
        body = self.backbone.body(self.normalize(images),
                                  use_bottleneck_transformer)
        fpn = self.backbone.fpn([body[f"layer{i}"] for i in (1, 2, 3, 4)])
        return body, fpn

    def ext_logits(self, images: torch.Tensor) -> torch.Tensor:
        """The ext filter on ``images`` [B, H, W, 3]: logits [B, 2] in train
        mode (its BNs on batch statistics), probabilities in eval mode; the
        trunk stops after the stem."""
        body = self.backbone.body(self.normalize(images), ext_training=True)
        if "ext_logits" not in body:
            raise ValueError("ext_training: the model has no ext filter")
        return body["ext_logits"]

    def forward(self, batch: Dict[str, torch.Tensor],
                targets: Optional[Dict[str, torch.Tensor]] = None,
                draw: Optional[Draw] = None,
                use_bottleneck_transformer: bool = False,
                ext_training: bool = False) -> Dict[str, torch.Tensor]:
        """batch: images [B, H, W, 3] in [0, 1], image_sizes [B, 2] valid
        (h, w) inside the bucket, original_sizes [B, 2].

        In eval mode: fixed-shape detections in original-image coordinates
        (``boxes``) and bucket coordinates (``boxes_model``), with
        ``mask_probs``, or ``keypoint_logits`` (``kp_u``, ``kp_v`` and
        ``kp_score`` with the device decode) for those kinds, without
        autograd.  In train mode: the loss dict {loss_classifier,
        loss_box_reg, loss_objectness, loss_rpn_box_reg}, with loss_mask
        (a Mask R-CNN given ``masks_crop``) or loss_keypoint (a Keypoint
        R-CNN given ``keypoints``); ``targets`` holds boxes [B, G, 4],
        labels [B, G] and boxes_valid [B, G] (padded to a fixed G), and
        masks_crop [B, G, 114, 114] or keypoints [B, G, K, 3] as the loader
        makes them; ``draw`` gives the samplers' uniform draws.

        ``ext_training``: the ext filter's logits [B, 2] (train mode) or,
        without autograd, its probabilities (eval mode), the trunk cut
        after the stem."""
        if ext_training:
            if self.training:
                return self.ext_logits(batch["images"])
            with torch.no_grad():
                return self.ext_logits(batch["images"])
        if self.training:
            if targets is None or draw is None:
                raise ValueError("training forward needs targets and draw")
            return self.losses(batch, targets, draw)
        with torch.no_grad():
            return self.detect(batch, use_bottleneck_transformer)

    def losses(self, batch: Dict[str, torch.Tensor],
               targets: Dict[str, torch.Tensor],
               draw: Draw) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        _, feats = self.backbone_features(images)
        return self.feature_losses(feats, batch["image_sizes"],
                                   (images.shape[1], images.shape[2]),
                                   targets, draw)

    def feature_losses(self, feats: Sequence[torch.Tensor],
                       image_sizes: torch.Tensor,
                       image_shape: Tuple[int, int],
                       targets: Dict[str, torch.Tensor],
                       draw: Draw) -> Dict[str, torch.Tensor]:
        """The training losses of ``losses`` from the FPN maps ``feats`` of
        a train-mode trunk: the distill step's org term computes them from
        the trunk pass its feature terms take (distill/box.py)."""
        proposals, prop_valid, raw = self.rpn.propose(
            feats, image_sizes, image_shape, training=True)
        rpn_losses = self.rpn.loss(raw, targets, draw)
        sampled = self.roi_heads.select_training_samples(
            proposals, prop_valid, targets, draw)
        return {**self.roi_losses(feats, image_shape, sampled, targets),
                **rpn_losses}

    def roi_losses(self, feats: Sequence[torch.Tensor],
                   image_shape: Tuple[int, int], sampled: tuple,
                   targets: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """The RoI heads' losses of ``select_training_samples``' output:
        the box loss, with the mask loss (a Mask R-CNN given
        ``masks_crop``) or the keypoint loss (a Keypoint R-CNN given
        ``keypoints``), every pooling from one NHWC copy of P2-P5."""
        heads = self.roi_heads
        tables = heads.pool_tables(feats, int8=False)
        losses = heads.loss(feats, image_shape, sampled, tables)
        if self.kind == "mask_rcnn" and "masks_crop" in targets:
            losses.update(heads.mask_loss(
                feats, image_shape, sampled, targets["boxes"],
                targets["masks_crop"], tables))
        if self.kind == "keypoint_rcnn" and "keypoints" in targets:
            losses.update(heads.keypoint_loss(
                feats, image_shape, sampled, targets["keypoints"], tables))
        return losses

    def detect(self, batch: Dict[str, torch.Tensor],
               use_bottleneck_transformer: bool) -> Dict[str, torch.Tensor]:
        images = batch["images"]
        image_shape = (images.shape[1], images.shape[2])
        body, feats = self.backbone_features(images, use_bottleneck_transformer)
        proposals, prop_valid, _ = self.rpn.propose(
            feats, batch["image_sizes"], image_shape)
        dets = self.roi_heads.infer(feats, proposals, prop_valid,
                                    batch["image_sizes"], image_shape)
        if self.ext_threshold is not None and "ext_logits" in body:
            probs = body["ext_logits"]
            passed = probs[:, 1] >= self.ext_threshold            # [B]
            dets["valid"] = dets["valid"] & passed[:, None]
            dets["scores"] = dets["scores"] * passed[:, None].to(
                dets["scores"].dtype)
            dets["ext_logits"] = probs
        scale = (batch["original_sizes"].float()
                 / batch["image_sizes"].float())  # [B, 2] (h, w)
        sy = scale[:, 0][:, None]
        sx = scale[:, 1][:, None]
        b = dets["boxes"]
        dets["boxes_model"] = b
        dets["boxes"] = torch.stack([b[..., 0] * sx, b[..., 1] * sy,
                                     b[..., 2] * sx, b[..., 3] * sy], dim=-1)
        return dets
