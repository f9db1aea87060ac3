"""Bottleneck wire codec: affine 8-bit quantization, bit-exact.

Counterpart of hnd_ghnd_tpu/codec/quantizer.py.  ``quantize_tensor`` and
``dequantize_tensor`` are the plain PyTorch formula (the CPU reference the
CUDA kernels are held against); ``roundtrip`` is the in-model eval path and
goes through the kernels of ops/quant_kernels.py for CUDA tensors.

The min/max runs over the whole ``[B, ...]`` tensor, bucket padding
included, exactly like the JAX package (ROADMAP C3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedTensor(NamedTuple):
    tensor: torch.Tensor      # uint8 codes
    scale: torch.Tensor       # 0-d f32
    zero_point: torch.Tensor  # 0-d f32 holding an integer


def quantize_tensor(x: torch.Tensor, num_bits: int = 8) -> QuantizedTensor:
    """scale = (max - min) / (2^bits - 1) (1 where that is 0); zero point =
    int-truncated clip(-min/scale); q = round-half-even(clip(zp + x/scale))."""
    qmin = 0.0
    qmax = 2.0 ** num_bits - 1.0
    min_val = x.min().float()
    max_val = x.max().float()
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the IEEE quotient
    scale = (max_val - min_val) / torch.tensor(qmax - qmin, device=x.device)
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    initial_zp = qmin - min_val / safe_scale
    zero_point = initial_zp.clamp(qmin, qmax).to(torch.int32).float()
    qx = (zero_point + x.float() / safe_scale).clamp(qmin, qmax)
    return QuantizedTensor(torch.round(qx).to(torch.uint8), safe_scale,
                           zero_point)


def dequantize_tensor(q: QuantizedTensor) -> torch.Tensor:
    return q.scale * (q.tensor.float() - q.zero_point)


def roundtrip(z: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Quantize -> dequantize (the eval path between encoder and decoder)."""
    if num_bits == 16:
        return z.half().float()
    from hnd_ghnd_tpu_torch.ops import quant_kernels
    return quant_kernels.dequantize(quant_kernels.quantize(z, num_bits)).to(
        z.dtype)
