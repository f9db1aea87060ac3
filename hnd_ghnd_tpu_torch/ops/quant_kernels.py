"""Quantize / dequantize wrappers over the CUDA kernels of csrc/quant.cu.

Replace hnd_ghnd_tpu/ops/pallas_quant.py (pallas_quantize, pallas_dequantize).
What bounds the kernels and how they stay bit-exact is noted in the CUDA
source.  ``quantize`` and ``dequantize`` call the ``hnd_ghnd::quantize`` /
``dequantize`` ops defined here (ops/library.py): on a CPU tensor their
plain versions, codec/quantizer.py's ``quantize_tensor`` and
``dequantize_tensor``; on a CUDA tensor ``launch_quantize`` /
``launch_dequantize``, which raise on anything the kernels do not take.

Quantize is one cooperative launch; its work buffer (the scale and zero
point, then one (min, max) pair per block of the kernel's largest grid) is
one allocation, sized once per device.  The op returns its first two
floats, and ``scale`` and ``zero_point`` stay on the device as 0-d views of
them, where dequantize reads them; nothing here waits for the device.
"""
from __future__ import annotations

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.codec.quantizer import (QuantizedTensor,
                                                dequantize_tensor,
                                                quantize_tensor)
from hnd_ghnd_tpu_torch.ops._oplib import check_device, define, on_card


def _dense(x: torch.Tensor) -> bool:
    # elementwise kernels take any dense layout, NCHW or channels_last
    return x.is_contiguous() or (
        x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last))


def _stream(device: torch.device) -> int:
    # the handle alone, without building a torch.cuda.Stream object
    return torch._C._cuda_getCurrentRawStream(device.index)


# device index -> floats of hnd_quantize_u8's work buffer there
_work_floats: dict = {}


def _work_size(lib, device: torch.device) -> int:
    n = _work_floats.get(device.index)
    if n is None:
        with on_card(device):
            n = lib.hnd_quantize_work_floats()
        if n <= 0:
            _build.check(-n, "hnd_quantize_work_floats")
        _work_floats[device.index] = n
    return n


def quantize(x: torch.Tensor, num_bits: int = 8) -> QuantizedTensor:
    """Affine uint8 quantization; bit-exact with ``quantize_tensor``."""
    check_device(x, "quantize")
    codes, params = quantize_op(x, num_bits)
    return QuantizedTensor(codes, *params.unbind(0))


quantize.launches = 0


def launch_quantize(x: torch.Tensor, num_bits: int):
    """The kernel: (codes, the work buffer's [scale, zero_point] view)."""
    if x.dtype != torch.float32:
        raise TypeError(f"quantize kernel takes float32, got {x.dtype}")
    if not 1 <= num_bits <= 8:
        raise ValueError(f"quantize kernel takes 1..8 bits, got {num_bits}")
    if not _dense(x) or x.numel() == 0:
        raise ValueError("quantize kernel takes a dense, non-empty tensor")
    lib = _build.load()
    q = torch.empty_like(x, dtype=torch.uint8)
    work = torch.empty(_work_size(lib, x.device), dtype=torch.float32,
                       device=x.device)
    with on_card(x.device):
        _build.check(lib.hnd_quantize_u8(x.data_ptr(), q.data_ptr(),
                                         work.data_ptr(), x.numel(),
                                         num_bits, _stream(x.device)),
                     "hnd_quantize_u8")
    quantize.launches += 1
    return q, work[:2]


def dequantize(q: QuantizedTensor) -> torch.Tensor:
    """scale * (q - zero_point) as float32; exact."""
    check_device(q.tensor, "dequantize")
    return dequantize_op(q.tensor, q.scale, q.zero_point)


dequantize.launches = 0


def launch_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                      zero_point: torch.Tensor) -> torch.Tensor:
    if codes.dtype != torch.uint8 or not _dense(codes) or codes.numel() == 0:
        raise ValueError("dequantize kernel takes dense, non-empty uint8 codes")
    for t in (scale, zero_point):
        if t.device != codes.device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError("dequantize: scale and zero_point must be "
                             "one-element float32 tensors on the codes' device")
    lib = _build.load()
    out = torch.empty_like(codes, dtype=torch.float32)
    with on_card(codes.device):
        _build.check(lib.hnd_dequantize_u8(
            codes.data_ptr(), scale.data_ptr(), zero_point.data_ptr(),
            out.data_ptr(), codes.numel(), _stream(codes.device)),
            "hnd_dequantize_u8")
    dequantize.launches += 1
    return out


def _quantize_cpu(x, num_bits):
    q = quantize_tensor(x, num_bits)
    return q.tensor, torch.stack([q.scale, q.zero_point])


def _quantize_fake(x, num_bits):
    return (torch.empty_like(x, dtype=torch.uint8),
            x.new_empty(2, dtype=torch.float32))


# affine quantization of x: (uint8 codes shaped like x, [scale, zero_point]
# float32)
quantize_op = define("quantize(Tensor x, int num_bits) -> (Tensor, Tensor)",
                     _quantize_cpu, launch_quantize, _quantize_fake)


def _dequantize_cpu(codes, scale, zero_point):
    return dequantize_tensor(QuantizedTensor(codes, scale, zero_point))


def _dequantize_fake(codes, scale, zero_point):
    return torch.empty_like(codes, dtype=torch.float32)


# scale * (codes - zero_point) as float32
dequantize_op = define(
    "dequantize(Tensor codes, Tensor scale, Tensor zero_point) -> Tensor",
    _dequantize_cpu, launch_dequantize, _dequantize_fake)
