"""Faster R-CNN meta-architecture, eval forward.

Counterpart of hnd_ghnd_tpu/models/rcnn.py (the reference's CustomRCNN):
normalize -> trunk (with the bottleneck as layer1) -> FPN -> RPN -> RoI
heads -> boxes rescaled from the padded bucket to each image's original
size.  The batch keeps the JAX package's layout: images [B, H, W, 3] in
[0, 1].  The trunk runs contiguous NCHW: float32 cuDNN convolutions have
NCHW kernels only, and a channels_last trunk spends more in their layout
transposes than the NHWC copy of P2-P5 for the RoIAlign kernel costs.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from hnd_ghnd_tpu_torch.models.bottleneck import Bottleneck4LargeResNet
from hnd_ghnd_tpu_torch.models.fpn import FPN
from hnd_ghnd_tpu_torch.models.resnet import ResNetBody
from hnd_ghnd_tpu_torch.models.roi_heads import RoIHeads
from hnd_ghnd_tpu_torch.models.rpn import RPN

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
    rpn.head.*, roi_heads.box_head.*, roi_heads.box_predictor.*.  A
    student has the bottleneck as layer1, a teacher (``bottleneck`` None)
    the stock ResNet-50 layer1."""

    def __init__(self, bottleneck: Optional[Bottleneck4LargeResNet],
                 num_classes: int = 91):
        super().__init__()
        self.backbone = Backbone(bottleneck)
        self.rpn = RPN()
        self.roi_heads = RoIHeads(num_classes)

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

    @torch.no_grad()
    def forward(self, batch: Dict[str, torch.Tensor],
                use_bottleneck_transformer: bool = False) -> Dict[str, torch.Tensor]:
        """batch: images [B, H, W, 3] in [0, 1], image_sizes [B, 2] valid
        (h, w) inside the bucket, original_sizes [B, 2].  Returns
        fixed-shape detections in original-image coordinates (``boxes``)
        and bucket coordinates (``boxes_model``)."""
        if self.training:
            raise NotImplementedError(
                "the detection losses are not ported yet (ROADMAP A7); "
                "distillation trains through distill.box; call .eval()")
        images = batch["images"]
        image_shape = (images.shape[1], images.shape[2])
        _, feats = self.backbone_features(images, use_bottleneck_transformer)
        proposals, prop_valid = self.rpn.propose(feats, batch["image_sizes"],
                                                 image_shape)
        dets = self.roi_heads.infer(feats, proposals, prop_valid,
                                    batch["image_sizes"], image_shape)
        scale = (batch["original_sizes"].float()
                 / batch["image_sizes"].float())  # [B, 2] (h, w)
        sy = scale[:, 0][:, None]
        sx = scale[:, 1][:, None]
        b = dets["boxes"]
        dets["boxes_model"] = b
        dets["boxes"] = torch.stack([b[..., 0] * sx, b[..., 1] * sy,
                                     b[..., 2] * sx, b[..., 3] * sy], dim=-1)
        return dets
