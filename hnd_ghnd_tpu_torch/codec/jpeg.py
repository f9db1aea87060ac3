"""JPEG wire codec for RGB payloads, on the host.

Counterpart of hnd_ghnd_tpu/codec/jpeg.py (reference
src/structure/transformer.py JpegCompressor/JpegDecompressor :94-128):
quantize an RGB tensor to uint8, JPEG-encode it, and rebuild the float
tensor from the decoded bytes with the stored scale and zero point.  The
payload stays in memory (the bytes are the wire format).

These run on the host by design, with numpy and PIL (imported by the
functions that encode and decode): the JAX package hands the bottleneck
tensor to them through ``jax.pure_callback``, and the port's bottleneck
copies it to the host (models/bottleneck.py).  The numbers are the JAX
package's: the same numpy arithmetic on the same arrays.
"""
from __future__ import annotations

import io
from typing import NamedTuple

import numpy as np


class HostQuantizedTensor(NamedTuple):
    """numpy twin of codec.quantizer.QuantizedTensor for host chains."""
    tensor: np.ndarray
    scale: float
    zero_point: float


def _quantize_np(x: np.ndarray, num_bits: int = 8):
    qmin, qmax = np.float32(0.0), np.float32(2.0 ** num_bits - 1.0)
    mn = x.astype(np.float32).min()
    mx = x.astype(np.float32).max()
    scale = np.float32((mx - mn) / (qmax - qmin))
    if not scale > 0:  # constant tensor: scale=1 guard (no NaNs on the wire)
        scale = np.float32(1.0)
    zp = float(int(np.clip(np.float32(-mn / scale), qmin, qmax)))
    q = np.clip(np.float32(zp) + x.astype(np.float32) / scale,
                qmin, qmax).round().astype(np.uint8)
    return q, float(scale), zp


class HostQuantizer:
    """numpy twin of codec.quantizer.Quantizer for host chains that hold a
    JPEG component."""

    def __init__(self, num_bits: int = 8):
        self.num_bits = num_bits

    def __call__(self, z, target=None):
        if self.num_bits == 16:
            return np.asarray(z, np.float16), target
        q, scale, zp = _quantize_np(np.asarray(z), self.num_bits)
        return HostQuantizedTensor(q, scale, zp), target


class HostDequantizer:
    def __init__(self, num_bits: int = 8):
        self.num_bits = num_bits

    def __call__(self, qz, target=None):
        if self.num_bits == 16:
            return np.asarray(qz, np.float32), target
        if not isinstance(qz, HostQuantizedTensor):
            return qz, target
        return (np.float32(qz.scale)
                * (qz.tensor.astype(np.float32) - np.float32(qz.zero_point)),
                target)


class JpegCompressor:
    """RGB [H, W, 3] (or [1, H, W, 3]) float tensor -> (jpeg bytes, scale,
    zero_point).  Anything else passes through untouched (the reference's
    behavior, transformer.py:117-124): a chain must hand it NHWC images."""

    def __init__(self, jpeg_quality: int = 95):
        self.jpeg_quality = jpeg_quality

    def __call__(self, z, target=None):
        if isinstance(z, (tuple, bytes, bytearray)):
            return z, target  # quantized record / encoded payload: untouched
        arr = np.asarray(z)
        if arr.ndim == 4 and arr.shape[0] == 1 and arr.shape[-1] == 3:
            arr = arr[0]
        if not (arr.ndim == 3 and arr.shape[-1] == 3):
            return z, target
        from PIL import Image
        q, scale, zp = _quantize_np(arr)
        buf = io.BytesIO()
        Image.fromarray(q).save(buf, format="jpeg", quality=self.jpeg_quality)
        return (buf.getvalue(), scale, zp), target


class JpegDecompressor:
    """(jpeg bytes, scale, zero_point) -> the rebuilt float tensor."""

    def __init__(self, target_dim: int = 4):
        self.target_dim = target_dim

    def __call__(self, z, target=None):
        if not (isinstance(z, tuple) and len(z) == 3
                and isinstance(z[0], (bytes, bytearray))):
            return z, target
        from PIL import Image
        payload, scale, zp = z
        img = np.asarray(Image.open(io.BytesIO(payload)).convert("RGB"),
                         dtype=np.float32)
        out = scale * (img - zp)
        if self.target_dim == 4:
            out = out[None]
        return out, target
