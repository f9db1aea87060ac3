"""The compressive bottleneck that replaces ResNet ``layer1``.

Counterpart of hnd_ghnd_tpu/models/bottleneck.py (reference
Bottleneck4LargeResNet): a 4-conv encoder 64 -> 64 -> 256 -> 64 -> b and a
decoder b -> 64 -> 128 -> 256 -> 256, all kernel 2 and bias-free.  The
encoder convs pad by 1 and grow the map by +1 each; the decoder's unpadded
convs shrink it back.  The Sequential indices are the reference's, so the
state_dict keys (``encoder.encoder.0.weight``, ``decoder.10.running_var``)
are the ones hnd_ghnd_tpu/models/convert.py maps.

At eval, ``use_bottleneck_transformer`` puts the 8-bit quantize/dequantize
round trip between encoder and decoder (the CUDA kernels on the card), or,
given a host chain (a ``bottleneck_transformer`` naming a JPEG component,
codec/quantizer.get_bottleneck_transformer), runs that chain on the host,
one NHWC image at a time, as the JAX package's ``_host_roundtrip`` does
(bottleneck.py:61-71, :159-166).  ``encode`` and ``decode`` are the two
halves the split deployment's head and tail call (split/deploy.py).  In
train mode (the distill step) the BNs use batch statistics and update
their running ones, and the round trip is never applied, as in the JAX
package (bottleneck.py:161).

With ``ext`` the encoder holds the ext filter (models/ext.py) as
``encoder.ext_classifier``, the reference's path.  As in the JAX package
(bottleneck.py:138-170) it runs on the 64-channel input, before the
encoder: under ``ext_training`` only the filter runs, otherwise its output
rides along with the decoder's.  Its BNs train only when the module is in
train mode and ``ext_training`` holds; otherwise it returns probabilities.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from hnd_ghnd_tpu_torch.codec.quantizer import roundtrip
from hnd_ghnd_tpu_torch.models.ext import Ext4ResNet
from hnd_ghnd_tpu_torch.models.layers import BatchNorm2d, Conv2d


def _conv(cin: int, cout: int, padding: int) -> Conv2d:
    return Conv2d(cin, cout, 2, stride=1, padding=padding, bias=False)


class _Encoder(nn.Module):
    """Holds the Sequential as ``.encoder`` and the ext filter, if any, as
    ``.ext_classifier`` (the reference's nesting)."""

    def __init__(self, bottleneck_channel: int, ext: bool = False):
        super().__init__()
        self.encoder = nn.Sequential(
            _conv(64, 64, 1), BatchNorm2d(64),
            _conv(64, 256, 1), BatchNorm2d(256), nn.ReLU(inplace=True),
            _conv(256, 64, 1), BatchNorm2d(64),
            _conv(64, bottleneck_channel, 1))
        self.ext_classifier = Ext4ResNet(64) if ext else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class Bottleneck4LargeResNet(nn.Module):
    def __init__(self, bottleneck_channel: int, quant_bits: int = 8,
                 ext: bool = False, host_transformer=None):
        super().__init__()
        self.quant_bits = quant_bits
        self.host_transformer = host_transformer
        self.encoder = _Encoder(bottleneck_channel, ext)
        self.decoder = nn.Sequential(
            BatchNorm2d(bottleneck_channel), nn.ReLU(inplace=True),
            _conv(bottleneck_channel, 64, 0), BatchNorm2d(64),
            _conv(64, 128, 0), BatchNorm2d(128), nn.ReLU(inplace=True),
            _conv(128, 256, 0), BatchNorm2d(256),
            _conv(256, 256, 0), BatchNorm2d(256), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, use_bottleneck_transformer: bool = False,
                ext_training: bool = False
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """-> (layer1's output, None under ``ext_training``; the filter's
        logits or probabilities, None without a filter)."""
        ext = self.encoder.ext_classifier
        ext_out = None
        if ext is not None:
            ext.train(self.training and ext_training)
            ext_out = ext(x)
            if ext_training:
                return None, ext_out
        z = self.encode(x)
        if use_bottleneck_transformer and not self.training:
            z = (roundtrip(z, self.quant_bits) if self.host_transformer is None
                 else self._host_roundtrip(z))
        return self.decode(z), ext_out

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The 64-channel stem output -> the bottleneck tensor, NCHW."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """The bottleneck tensor, NCHW -> layer1's output."""
        return self.decoder(z)

    def _host_roundtrip(self, z: torch.Tensor) -> torch.Tensor:
        """The host chain on each image as NHWC float32 numpy (a JPEG
        component encodes only a [H, W, 3] image), back in ``z``'s shape,
        dtype and device, contiguous NCHW."""
        zn = z.detach().permute(0, 2, 3, 1).float().cpu().numpy()
        out = []
        for i in range(zn.shape[0]):
            r, _ = self.host_transformer(zn[i])
            out.append(np.asarray(r, dtype=zn.dtype).reshape(zn[i].shape))
        back = torch.from_numpy(np.stack(out)).to(device=z.device,
                                                   dtype=z.dtype)
        return back.permute(0, 3, 1, 2).contiguous()
