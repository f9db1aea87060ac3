"""Feature Pyramid Network over layer1..layer4, plus the max-pool P6.

Counterpart of hnd_ghnd_tpu/models/fpn.py (torchvision FeaturePyramidNetwork
+ LastLevelMaxPool, 256 channels): 1x1 lateral convs, top-down nearest 2x
upsample cropped to the lateral's size, 3x3 output convs, and a
kernel-1/stride-2 max-pool on P5.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.models.layers import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels_list: List[int], out_channels: int = 256):
        super().__init__()
        self.inner_blocks = nn.ModuleList(
            Conv2d(c, out_channels, 1) for c in in_channels_list)
        self.layer_blocks = nn.ModuleList(
            Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in in_channels_list)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """[layer1..layer4] -> [P2, P3, P4, P5, P6]."""
        inners = [blk(f) for blk, f in zip(self.inner_blocks, feats)]
        n = len(inners)
        outs: List[torch.Tensor] = [None] * n
        last = inners[-1]
        outs[-1] = self.layer_blocks[n - 1](last)
        for i in range(n - 2, -1, -1):
            th, tw = inners[i].shape[-2:]
            # an exact 2x repeat, then a crop to the ceil-halved lateral
            up = F.interpolate(last, scale_factor=2.0, mode="nearest")
            last = inners[i] + up[..., :th, :tw]
            outs[i] = self.layer_blocks[i](last)
        outs.append(F.max_pool2d(outs[-1], 1, 2, 0))
        return outs
