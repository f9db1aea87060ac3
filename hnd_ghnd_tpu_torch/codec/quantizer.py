"""Bottleneck wire codec: affine 8-bit quantization, bit-exact.

Counterpart of hnd_ghnd_tpu/codec/quantizer.py.  ``quantize_tensor`` and
``dequantize_tensor`` are the plain PyTorch formula (the CPU reference the
CUDA kernels are held against); ``roundtrip`` is the in-model eval path and
goes through the kernels of ops/quant_kernels.py for CUDA tensors.

The min/max runs over the whole ``[B, ...]`` tensor, bucket padding
included, exactly like the JAX package (ROADMAP C3).  Non-finite inputs
follow JAX on the CPU (ROADMAP C12): min and max propagate NaN, a NaN
scale becomes 1, and a NaN zero point or code becomes 0.

``Quantizer``, ``Dequantizer``, ``Compose`` and
``get_bottleneck_transformer`` build the reference YAML's
``bottleneck_transformer`` chain (JAX quantizer.py:56-138).  A chain of
quantizers and dequantizers holds these tensor classes (the kernels for a
CUDA tensor); a chain that names a JPEG component is a host chain of
codec/jpeg.py's numpy classes (``host_side``), which the bottleneck runs
per image between its encoder and decoder.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from hnd_ghnd_tpu_torch.codec import jpeg as jpeg_codec


class QuantizedTensor(NamedTuple):
    tensor: torch.Tensor      # uint8 codes
    scale: torch.Tensor       # 0-d f32
    zero_point: torch.Tensor  # 0-d f32 holding an integer


def quantize_tensor(x: torch.Tensor, num_bits: int = 8) -> QuantizedTensor:
    """scale = (max - min) / (2^bits - 1) (1 where that is not > 0, NaN
    included); zero point = int-truncated clip(-min/scale); q =
    round-half-even(clip(zp + x/scale)); a NaN zero point or code is 0."""
    qmin = 0.0
    qmax = 2.0 ** num_bits - 1.0
    min_val = x.min().float()
    max_val = x.max().float()
    # a tensor divisor: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the IEEE quotient
    scale = (max_val - min_val) / torch.tensor(qmax - qmin, device=x.device)
    safe_scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    initial_zp = qmin - min_val / safe_scale
    # NaN (from a NaN or an infinite min) becomes 0 before each cast, as
    # XLA's convert makes it: torch's cast of NaN differs by device
    zero_point = initial_zp.clamp(qmin, qmax).nan_to_num(nan=0.0).to(
        torch.int32).float()
    qx = (zero_point + x.float() / safe_scale).clamp(qmin, qmax)
    return QuantizedTensor(torch.round(qx).nan_to_num(nan=0.0).to(torch.uint8),
                           safe_scale, zero_point)


def dequantize_tensor(q: QuantizedTensor) -> torch.Tensor:
    return q.scale * (q.tensor.float() - q.zero_point)


def roundtrip(z: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Quantize -> dequantize (the eval path between encoder and decoder)."""
    if num_bits == 16:
        return z.half().float()
    from hnd_ghnd_tpu_torch.ops import quant_kernels
    return quant_kernels.dequantize(quant_kernels.quantize(z, num_bits)).to(
        z.dtype)


class Quantizer:
    """num_bits 16: a float16 cast; otherwise the affine quantization (the
    kernel for a CUDA tensor)."""

    def __init__(self, num_bits: int = 8):
        self.num_bits = num_bits

    def __call__(self, z, target=None):
        if self.num_bits == 16:
            return z.half(), target
        from hnd_ghnd_tpu_torch.ops import quant_kernels
        return quant_kernels.quantize(z, self.num_bits), target


class Dequantizer:
    def __init__(self, num_bits: int = 8):
        self.num_bits = num_bits

    def __call__(self, qz, target=None):
        if self.num_bits == 16:
            return qz.float(), target
        from hnd_ghnd_tpu_torch.ops import quant_kernels
        return quant_kernels.dequantize(qz), target


class Compose:
    def __init__(self, components, host_side: bool = False):
        self.components = list(components)
        # a host chain (JPEG components) runs on numpy, one image at a time
        self.host_side = host_side

    def __call__(self, z, target=None):
        for c in self.components:
            z, target = c(z, target)
        return z, target


TRANSFORMER_CLASS_DICT = {
    "quantizer": Quantizer,
    "dequantizer": Dequantizer,
}

HOST_TRANSFORMER_NAMES = ("jpeg_compressor", "jpeg_decompressor")


def get_bottleneck_transformer(transformer_config: Optional[Dict[str, Any]]):
    """The chain of ``bottleneck_transformer: {order, components}`` (the
    reference's quantizer, dequantizer, jpeg_compressor and
    jpeg_decompressor), None without one.  A chain naming a JPEG component
    is built from codec/jpeg.py's host classes, ``host_side=True``.  The
    reference's ``tmp_dir_path`` is dropped: the payload stays in memory."""
    if transformer_config is None:
        return None
    order = list(transformer_config["order"])
    comp_cfg = transformer_config["components"]
    host_side = any(name in HOST_TRANSFORMER_NAMES for name in order)
    if host_side:
        class_dict = {
            "quantizer": jpeg_codec.HostQuantizer,
            "dequantizer": jpeg_codec.HostDequantizer,
            "jpeg_compressor": jpeg_codec.JpegCompressor,
            "jpeg_decompressor": jpeg_codec.JpegDecompressor,
        }
    else:
        class_dict = TRANSFORMER_CLASS_DICT
    components = []
    for name in order:
        if name not in class_dict:
            raise KeyError(f"transformer `{name}` is not expected")
        params = (comp_cfg.get(name, {}) or {}).get("params", {}) or {}
        params = {k: v for k, v in params.items() if k != "tmp_dir_path"}
        components.append(class_dict[name](**params))
    return Compose(components, host_side=host_side) if components else None
