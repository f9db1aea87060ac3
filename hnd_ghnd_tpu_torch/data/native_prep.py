"""ctypes binding of the native fused image prep (ROADMAP A15).

Counterpart of hnd_ghnd_tpu/data/native_prep.py over the port's copy of
its C source (csrc/prep.cpp, native/pipeline/prep.cpp with the libjpeg
half optional), which the port builds itself with g++
(``_build.load_host("prep")``) instead of loading the JAX package's
``build/libprep.so``.  One C call per image replaces the chain resize ->
flip -> pad -> /255 with one pass from the decoded uint8 image into its
padded slot of the batch (float32 in [0, 1], or uint8 codes), and libjpeg
decodes; both release the GIL, so the loader's thread pool runs them on
several cores.

``HND_TPU_NATIVE_PREP=0`` (the JAX package's switch, read at each call)
keeps the loader on its pure path (PIL decode, cv2 resize).  Where the
library does not build, ``available()`` is False and ``reason()`` says
why; the loader logs which path it took.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from hnd_ghnd_tpu_torch import _build

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
_bound: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """The switch: ``HND_TPU_NATIVE_PREP`` unset or 1."""
    return os.environ.get("HND_TPU_NATIVE_PREP", "1") == "1"


def get_lib() -> Optional[ctypes.CDLL]:
    """The built library with its signatures, or None."""
    global _bound
    lib = _build.load_host("prep")
    if lib is not None and _bound is not lib:
        prep_args = [_U8P, _I64, _I64, _I64, _I64, ctypes.c_int32, _I64, _I64]
        lib.prep_image.restype = None
        lib.prep_image.argtypes = prep_args + [ctypes.POINTER(ctypes.c_float)]
        lib.prep_image_u8.restype = None
        lib.prep_image_u8.argtypes = prep_args + [_U8P]
        lib.prep_has_jpeg.restype = ctypes.c_int
        lib.prep_has_jpeg.argtypes = []
        if lib.prep_has_jpeg():
            lib.jpeg_info.restype = _I64
            lib.jpeg_info.argtypes = [_U8P, _I64, _I64P, _I64P]
            lib.jpeg_decode.restype = _I64
            lib.jpeg_decode.argtypes = [_U8P, _I64, _U8P, _I64, _I64]
        _bound = lib
    return lib


def available() -> bool:
    return enabled() and get_lib() is not None


def has_jpeg() -> bool:
    """The library decodes JPEG itself (libjpeg was there at its build)."""
    return available() and bool(get_lib().prep_has_jpeg())


def supports_u8() -> bool:
    """The uint8-slot entry point: every build of this source has it."""
    return available()


def reason() -> str:
    """Why the loader takes the path it takes, in a few words."""
    if not enabled():
        return "HND_TPU_NATIVE_PREP=0"
    if get_lib() is None:
        return f"libprep did not build: {_build.host_info['prep']['error']}"
    decode = "libjpeg" if has_jpeg() else "PIL (built without libjpeg)"
    return f"resize and pad by {_build.host_info['prep']['path']}, " \
           f"JPEG decode by {decode}"


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """libjpeg decode to RGB uint8 [h, w, 3]; None when the switch is off,
    the library is missing or libjpeg refuses the bytes (the caller then
    decodes with PIL: PNGs, other colour spaces)."""
    if not has_jpeg():
        return None
    lib = get_lib()
    buf = np.frombuffer(data, dtype=np.uint8)
    h, w = _I64(), _I64()
    src = buf.ctypes.data_as(_U8P)
    if lib.jpeg_info(src, len(buf), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.jpeg_decode(src, len(buf), out.ctypes.data_as(_U8P), h.value,
                         w.value)
    return out if rc == 0 else None


def prep_into(src_u8: np.ndarray, nh: int, nw: int, flip: bool,
              out_slot: np.ndarray) -> None:
    """Resize src to nh x nw (bilinear, half-pixel centres), flip it when
    asked and zero-pad it into out_slot ([bh, bw, 3], C-contiguous): a
    float32 slot gets values in [0, 1], a uint8 slot rounded codes."""
    src = np.ascontiguousarray(src_u8, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"prep_into takes [h, w, 3] uint8, got {src.shape}")
    if out_slot.dtype not in (np.float32, np.uint8) \
            or not out_slot.flags.c_contiguous:
        raise ValueError("prep_into writes a C-contiguous float32 or uint8 "
                         "slot")
    bh, bw = out_slot.shape[:2]
    # checked before C: prep.cpp zero-pads with memset(row + nw*3, 0,
    # (bw-nw)*3*4), and a negative (bw-nw) would wrap to a huge size_t
    if not (1 <= nh <= bh and 1 <= nw <= bw):
        raise ValueError(f"resize {nh}x{nw} does not fit the slot {bh}x{bw}")
    lib = get_lib()
    args = (src.ctypes.data_as(_U8P), src.shape[0], src.shape[1], nh, nw,
            int(bool(flip)), bh, bw)
    if out_slot.dtype == np.uint8:
        lib.prep_image_u8(*args, out_slot.ctypes.data_as(_U8P))
    else:
        lib.prep_image(*args, out_slot.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float)))
