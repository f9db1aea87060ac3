"""The compressive bottleneck that replaces ResNet ``layer1``.

Counterpart of hnd_ghnd_tpu/models/bottleneck.py (reference
Bottleneck4LargeResNet): a 4-conv encoder 64 -> 64 -> 256 -> 64 -> b and a
decoder b -> 64 -> 128 -> 256 -> 256, all kernel 2 and bias-free.  The
encoder convs pad by 1 and grow the map by +1 each; the decoder's unpadded
convs shrink it back.  The Sequential indices are the reference's, so the
state_dict keys (``encoder.encoder.0.weight``, ``decoder.10.running_var``)
are the ones hnd_ghnd_tpu/models/convert.py maps.

At eval, ``use_bottleneck_transformer`` puts the 8-bit quantize/dequantize
round trip between encoder and decoder (the CUDA kernels on the card).  In
train mode (the distill step) the BNs use batch statistics and update
their running ones, and the round trip is never applied, as in the JAX
package (bottleneck.py:161).
"""
from __future__ import annotations

import torch
from torch import nn

from hnd_ghnd_tpu_torch.codec.quantizer import roundtrip
from hnd_ghnd_tpu_torch.models.layers import BatchNorm2d, Conv2d


def _conv(cin: int, cout: int, padding: int) -> Conv2d:
    return Conv2d(cin, cout, 2, stride=1, padding=padding, bias=False)


class _Encoder(nn.Module):
    """Holds the Sequential as ``.encoder`` (the reference's nesting)."""

    def __init__(self, bottleneck_channel: int):
        super().__init__()
        self.encoder = nn.Sequential(
            _conv(64, 64, 1), BatchNorm2d(64),
            _conv(64, 256, 1), BatchNorm2d(256), nn.ReLU(inplace=True),
            _conv(256, 64, 1), BatchNorm2d(64),
            _conv(64, bottleneck_channel, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class Bottleneck4LargeResNet(nn.Module):
    def __init__(self, bottleneck_channel: int, quant_bits: int = 8):
        super().__init__()
        self.quant_bits = quant_bits
        self.encoder = _Encoder(bottleneck_channel)
        self.decoder = nn.Sequential(
            BatchNorm2d(bottleneck_channel), nn.ReLU(inplace=True),
            _conv(bottleneck_channel, 64, 0), BatchNorm2d(64),
            _conv(64, 128, 0), BatchNorm2d(128), nn.ReLU(inplace=True),
            _conv(128, 256, 0), BatchNorm2d(256),
            _conv(256, 256, 0), BatchNorm2d(256), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor,
                use_bottleneck_transformer: bool = False) -> torch.Tensor:
        z = self.encoder(x)
        if use_bottleneck_transformer and not self.training:
            z = roundtrip(z, self.quant_bits)
        return self.decoder(z)
