"""The ResNet stem: 7x7/s2 conv (3 -> 64) + frozen-BN affine + ReLU, plain.

Counterpart of hnd_ghnd_tpu/ops/pallas_stem.py's ``stem_reference`` and
``stem_supported``, in NCHW: ``relu(conv7x7s2(x) * scale + bias)`` with
padding 3.  These are the plain versions of the three stem kernels of
ops/stem_kernels.py (the CPU path, and what the card is held against):

  * ``stem_forward``: the output, and with ``with_conv`` also the
    pre-affine conv (the backward's residual); differentiable by autograd,
    it is also the oracle of the fused ``autograd.Function``;
  * ``stem_weight_grad``: dW = sum over B x OH x OW of the input patches
    times the conv's cotangent.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

STRIDE = 2
PADDING = 3
KERNEL = 7
IN_CHANNELS = 3
OUT_CHANNELS = 64


def stem_supported(x: torch.Tensor) -> bool:
    """The shapes the fused stem takes (pallas_stem.stem_supported in
    NCHW): 3 channels, even H and W, H/2 >= 8 and W/2 >= 16.  Every
    stride-64 training and eval bucket qualifies."""
    return (x.dim() == 4 and x.shape[1] == IN_CHANNELS
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
            and x.shape[2] // 2 >= 8 and x.shape[3] // 2 >= 16)


def stem_conv(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, weight, stride=STRIDE, padding=PADDING)


def stem_forward(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, with_conv: bool = False):
    """x [B, 3, H, W], weight [64, 3, 7, 7], scale/bias [64] ->
    out [B, 64, H/2, W/2] (and the pre-affine conv with ``with_conv``)."""
    conv = stem_conv(x, weight)
    out = torch.relu(conv * scale[None, :, None, None]
                     + bias[None, :, None, None])
    return (out, conv) if with_conv else out


def stem_weight_grad(x: torch.Tensor, g_conv: torch.Tensor) -> torch.Tensor:
    """dW [64, 3, 7, 7] of the stem conv from its input and cotangent."""
    return torch.nn.grad.conv2d_weight(
        x, (g_conv.shape[1], x.shape[1], KERNEL, KERNEL), g_conv,
        stride=STRIDE, padding=PADDING)
