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

In bfloat16 (pallas_stem.py runs in the input's dtype) the weight is
rounded to bf16 (JAX's ``w.astype(x.dtype)``), the products of bf16
operands are summed in float32, the affine and the ReLU run in float32 and
the output and the conv are stored in bf16; dW sums bf16 patches times a
bf16 cotangent in float32 and stays float32.  Every other dtype computes in
its own (float64 on the CPU serves as a reference).
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
    """The conv before the affine: in x's dtype, but for bfloat16 x the
    float32 sum of the bf16 products (not yet rounded)."""
    if x.dtype == torch.bfloat16:
        return F.conv2d(x.float(), weight.to(torch.bfloat16).float(),
                        stride=STRIDE, padding=PADDING)
    return F.conv2d(x, weight, stride=STRIDE, padding=PADDING)


def stem_forward(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, with_conv: bool = False):
    """x [B, 3, H, W], weight [64, 3, 7, 7], scale/bias [64] ->
    out [B, 64, H/2, W/2] (and the pre-affine conv with ``with_conv``),
    both in x's dtype."""
    conv = stem_conv(x, weight)
    out = torch.relu(conv * scale[None, :, None, None]
                     + bias[None, :, None, None])
    out, conv = out.to(x.dtype), conv.to(x.dtype)
    return (out, conv) if with_conv else out


def stem_weight_grad(x: torch.Tensor, g_conv: torch.Tensor) -> torch.Tensor:
    """dW [64, 3, 7, 7] of the stem conv from its input and cotangent
    (float32 from bfloat16 operands)."""
    if x.dtype == torch.bfloat16:
        x, g_conv = x.float(), g_conv.float()
    return torch.nn.grad.conv2d_weight(
        x, (g_conv.shape[1], x.shape[1], KERNEL, KERNEL), g_conv,
        stride=STRIDE, padding=PADDING)
