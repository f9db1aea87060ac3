"""ResNet-50 trunk with frozen BN and an injected ``layer1``.

Counterpart of hnd_ghnd_tpu/models/resnet.py (the reference's custom
ResNet): stem (7x7/2 conv, frozen BN, ReLU, 3x3/2 max-pool), the
Bottleneck4LargeResNet as ``layer1``, and torchvision bottleneck blocks in
``layer2..layer4`` (stride on the 3x3 conv).  Module names are the
reference's (``conv1``, ``layer2.0.downsample.0``, ...).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import FrozenBatchNorm2d

# stage planes and block counts of resnet50
_PLANES = (64, 128, 256, 512)
_COUNTS = (3, 4, 6, 3)
EXPANSION = 4


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(planes * EXPANSION)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * EXPANSION, 1, stride, bias=False),
            FrozenBatchNorm2d(planes * EXPANSION)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBody(nn.Module):
    """stem + layer1 (injected) + layer2..layer4."""

    def __init__(self, layer1: nn.Module):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.layer1 = layer1
        inplanes = _PLANES[0] * EXPANSION
        for stage in (1, 2, 3):
            planes = _PLANES[stage]
            blocks = [Bottleneck(inplanes, planes, 2, True)]
            inplanes = planes * EXPANSION
            blocks += [Bottleneck(inplanes, planes, 1, False)
                       for _ in range(_COUNTS[stage] - 1)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = [p * EXPANSION for p in _PLANES]

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(y, 3, 2, 1)

    def forward(self, x: torch.Tensor, use_bottleneck_transformer: bool = False
                ) -> Dict[str, torch.Tensor]:
        y = self.layer1(self.stem(x), use_bottleneck_transformer)
        feats = {"layer1": y}
        for stage in (2, 3, 4):
            y = getattr(self, f"layer{stage}")(y)
            feats[f"layer{stage}"] = y
        return feats
