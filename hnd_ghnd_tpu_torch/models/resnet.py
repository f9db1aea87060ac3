"""ResNet-50 trunk with frozen BN and an optionally injected ``layer1``.

Counterpart of hnd_ghnd_tpu/models/resnet.py (the reference's custom
ResNet): stem (7x7/2 conv, frozen BN, ReLU, 3x3/2 max-pool), ``layer1``
(the Bottleneck4LargeResNet of a student, or three torchvision bottleneck
blocks in a teacher), and torchvision bottleneck blocks in
``layer2..layer4`` (stride on the 3x3 conv).  Module names are the
reference's (``conv1``, ``layer2.0.downsample.0``, ...).

The stem switch of the JAX package (resnet.py:47-57, 179-190): with
``HND_TPU_PALLAS_STEM=1``, read at call time, an input that
``stem_supported`` accepts goes through the fused stem of
ops/stem_kernels.py (the CUDA kernels for a CUDA tensor, their plain
versions for a CPU one).  Without it the stem stays conv1/bn1/ReLU
(cuDNN on the card), as JAX stays with XLA.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import Conv2d, FrozenBatchNorm2d
from hnd_ghnd_tpu_torch.ops import stem_kernels
from hnd_ghnd_tpu_torch.ops.stem import stem_supported

# stage planes and block counts of resnet50
_PLANES = (64, 128, 256, 512)
_COUNTS = (3, 4, 6, 3)
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * EXPANSION)
        self.downsample = (nn.Sequential(
            Conv2d(inplanes, planes * EXPANSION, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * EXPANSION)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _stage(inplanes: int, stage: int) -> nn.Sequential:
    planes = _PLANES[stage]
    stride = 1 if stage == 0 else 2
    blocks = [Bottleneck(inplanes, planes, stride, True)]
    blocks += [Bottleneck(planes * EXPANSION, planes, 1, False)
               for _ in range(_COUNTS[stage] - 1)]
    return nn.Sequential(*blocks)


def use_fused_stem() -> bool:
    """``HND_TPU_PALLAS_STEM=1``: the switch of the JAX package, opt-in."""
    return os.environ.get("HND_TPU_PALLAS_STEM", "0") == "1"


class ResNetBody(nn.Module):
    """stem + layer1 (injected, or stock when ``layer1`` is None) +
    layer2..layer4."""

    def __init__(self, layer1: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.injected = layer1 is not None
        self.layer1 = layer1 if self.injected else _stage(_PLANES[0], 0)
        for stage in (1, 2, 3):
            setattr(self, f"layer{stage + 1}",
                    _stage(_PLANES[stage - 1] * EXPANSION, stage))
        self.out_channels = [p * EXPANSION for p in _PLANES]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if use_fused_stem() and stem_supported(x):
            scale, bias = self.bn1.folded()
            y = stem_kernels.stem_conv_bn_relu(x, self.conv1.weight, scale,
                                               bias)
        else:
            y = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(y, 3, 2, 1)

    def forward(self, x: torch.Tensor, use_bottleneck_transformer: bool = False,
                upto: int = 4, ext_training: bool = False
                ) -> Dict[str, torch.Tensor]:
        """{layer1..layer``upto``}: ``upto`` truncates the trunk, as the
        distill step needs no deeper stage than its loss terms.  A
        bottleneck with the ext filter adds its output as ``ext_logits``;
        under ``ext_training`` that is all the trunk computes
        (hnd_ghnd_tpu/models/resnet.py:212-222)."""
        y = self.stem(x)
        feats = {}
        if self.injected:
            y, ext_out = self.layer1(y, use_bottleneck_transformer,
                                     ext_training)
            if ext_out is not None:
                feats["ext_logits"] = ext_out
            if ext_training:
                return feats
        else:
            y = self.layer1(y)
        feats["layer1"] = y
        for stage in range(2, upto + 1):
            y = getattr(self, f"layer{stage}")(y)
            feats[f"layer{stage}"] = y
        return feats
