"""The "ext" neural filter: a small CNN on the 64-channel input of the
bottleneck that decides whether an image holds anything of interest.

Counterpart of hnd_ghnd_tpu/models/ext.py (reference
src/models/ext/classifier.py ``Ext4ResNet``): adaptive average pool to
64x64, conv(in -> 64, k4 s2) + BN + ReLU, conv(64 -> 32, k3 s2) + BN +
ReLU, conv(32 -> 16, k2 s1) + BN + ReLU, all with bias and no padding, an
adaptive average pool to 8x8, a channel-major flatten and Linear(1024, 2).
In train mode it returns the logits, in eval mode their softmax.

The Sequential indices are the reference's (pools at 0 and 10, ReLUs at 3,
6 and 9), so the state_dict keys (``extractor.1.weight``,
``extractor.8.running_var``, ``linear.bias``) are the ones
hnd_ghnd_tpu/models/convert.py maps.  The BNs are trainable with running
statistics (``BatchNorm2d``).  The pools are two products each
(layers.adaptive_avg_pool), as the JAX package computes them.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from hnd_ghnd_tpu_torch.models import layers as L

# (cout, kernel, stride) of the three convolutions
_CONVS = ((64, 4, 2), (32, 3, 2), (16, 2, 1))
POOL_IN = (64, 64)
POOL_OUT = (8, 8)


class AdaptiveAvgPool(nn.Module):
    def __init__(self, out_hw: Tuple[int, int]):
        super().__init__()
        self.out_hw = tuple(out_hw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return L.adaptive_avg_pool(x, self.out_hw)


class Ext4ResNet(nn.Module):
    def __init__(self, input_channel: int):
        super().__init__()
        layers = [AdaptiveAvgPool(POOL_IN)]
        prev = input_channel
        for cout, k, s in _CONVS:
            layers += [L.Conv2d(prev, cout, k, stride=s, padding=0, bias=True),
                       L.BatchNorm2d(cout), nn.ReLU(inplace=True)]
            prev = cout
        layers.append(AdaptiveAvgPool(POOL_OUT))
        self.extractor = nn.Sequential(*layers)
        self.linear = L.Linear(prev * POOL_OUT[0] * POOL_OUT[1], 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, C, H, W] -> logits (train mode) or probabilities (eval
        mode) [B, 2]."""
        z = self.extractor(x).flatten(1)
        logits = self.linear(z)
        return logits if self.training else torch.softmax(logits, dim=1)


def init_ext_(ext: Ext4ResNet, generator: torch.Generator) -> Ext4ResNet:
    """Seeded init with the JAX package's distributions
    (hnd_ghnd_tpu/models/ext.py:init): torch's default Conv2d and Linear
    init (kaiming uniform weights, uniform(1 / sqrt(fan_in)) biases) and
    identity BNs."""
    for m in ext.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            L.kaiming_uniform_(m.weight, generator)
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            with torch.no_grad():
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return ext
