"""Quantize / dequantize wrappers over the CUDA kernels of csrc/quant.cu.

Replace hnd_ghnd_tpu/ops/pallas_quant.py (pallas_quantize, pallas_dequantize).
What bounds the kernels and how they stay bit-exact is noted in the CUDA
source.  The plain versions are codec/quantizer.py's ``quantize_tensor`` and
``dequantize_tensor``: a CPU tensor goes to them, a CUDA tensor to the
kernel, and anything the kernel does not take raises.

``scale`` and ``zero_point`` stay on the device as 0-d views of one
``[2]`` buffer, and dequantize reads them there; nothing here waits for
the device.
"""
from __future__ import annotations

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.codec.quantizer import (QuantizedTensor,
                                                dequantize_tensor,
                                                quantize_tensor)


def _dense(x: torch.Tensor) -> bool:
    # elementwise kernels take any dense layout, NCHW or channels_last
    return x.is_contiguous() or (
        x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def quantize(x: torch.Tensor, num_bits: int = 8) -> QuantizedTensor:
    """Affine uint8 quantization; bit-exact with ``quantize_tensor``."""
    if x.device.type == "cpu":
        return quantize_tensor(x, num_bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"quantize kernel takes float32, got {x.dtype}")
    if not 1 <= num_bits <= 8:
        raise ValueError(f"quantize kernel takes 1..8 bits, got {num_bits}")
    if not _dense(x) or x.numel() == 0:
        raise ValueError("quantize kernel takes a dense, non-empty tensor")
    lib = _build.load()
    n = x.numel()
    q = torch.empty_like(x, dtype=torch.uint8)
    partials = torch.empty(lib.hnd_quantize_partials_size(n),
                           dtype=torch.float32, device=x.device)
    meta = torch.empty(2, dtype=torch.float32, device=x.device)
    _build.check(lib.hnd_quantize_u8(x.data_ptr(), q.data_ptr(),
                                     partials.data_ptr(), meta.data_ptr(), n,
                                     num_bits, _stream(x.device)),
                 "hnd_quantize_u8")
    quantize.launches += 1
    return QuantizedTensor(q, meta[0], meta[1])


quantize.launches = 0


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """scale * (q - zero_point) as float32; exact."""
    codes = q.tensor
    if codes.device.type == "cpu":
        return dequantize_tensor(q)
    if codes.device.type != "cuda":
        raise ValueError(f"dequantize: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or not _dense(codes) or codes.numel() == 0:
        raise ValueError("dequantize kernel takes dense, non-empty uint8 codes")
    for t in (q.scale, q.zero_point):
        if t.device != codes.device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("dequantize: scale and zero_point must be "
                             "one-element float32 tensors on the codes' device")
    lib = _build.load()
    out = torch.empty_like(codes, dtype=torch.float32)
    _build.check(lib.hnd_dequantize_u8(codes.data_ptr(), q.scale.data_ptr(),
                                       q.zero_point.data_ptr(), out.data_ptr(),
                                       codes.numel(), _stream(codes.device)),
                 "hnd_dequantize_u8")
    dequantize.launches += 1
    return out


dequantize.launches = 0
