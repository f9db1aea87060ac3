"""Multi-level RoIAlign forward over the CUDA kernel of csrc/roi_align.cu.

Replaces hnd_ghnd_tpu/ops/pallas_roi.py (pallas_multiscale_roi_align_batch);
what bounds the kernel and how it is laid out is noted in the CUDA source.
The plain version is ops/roi_align.py's ``multiscale_roi_align_batch``: a
CPU tensor goes to it, a CUDA tensor to the kernel, and anything the kernel
does not take raises.

The kernel reads NHWC levels.  The served trunk runs NCHW, so the caller
pays one copy per level; a channels_last map would hand over for free
(``permute(0, 2, 3, 1)`` of it is already contiguous).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops.roi_align import (assign_levels, level_geometry,
                                              multiscale_roi_align_batch)

# P2-P5: the levels assign_levels routes RoIs to
LEVELS = 4


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              image_size: Tuple[int, int], output_size: int,
              sampling_ratio: int = 2,
              boxes_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Levels [B, Hl, Wl, C], boxes [B, N, 4] -> [B, N, P, P, C]; same
    semantics as ``multiscale_roi_align_batch``."""
    if boxes.device.type == "cpu":
        return multiscale_roi_align_batch(features, boxes, image_size,
                                          output_size, sampling_ratio,
                                          boxes_valid)
    if boxes.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {boxes.device}")
    if len(features) != LEVELS:
        raise ValueError(f"roi_align kernel takes the {LEVELS} levels P2-P5, "
                         f"got {len(features)}")
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.shape[0] == 0 \
            or boxes.shape[1] == 0:
        raise ValueError(f"roi_align: boxes must be [B, N, 4], got "
                         f"{tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    for f in features:
        if f.dtype != torch.float32:
            raise TypeError(f"roi_align kernel takes float32 levels, got "
                            f"{f.dtype} (bf16/int8 tables: ROADMAP B3)")
        if f.device != boxes.device or f.dim() != 4 or f.shape[0] != b \
                or f.shape[-1] != c or not f.is_contiguous():
            raise ValueError("roi_align kernel takes contiguous [B, H, W, C] "
                             "levels on the boxes' device with one B and C")
    if boxes.dtype != torch.float32:
        raise TypeError(f"roi_align kernel takes float32 boxes, got {boxes.dtype}")
    boxes = boxes.contiguous()
    level = assign_levels(boxes.reshape(-1, 4)).contiguous()
    weight = None
    if boxes_valid is not None:
        if tuple(boxes_valid.shape) != (b, n) or boxes_valid.device != boxes.device:
            raise ValueError("roi_align: boxes_valid must be [B, N] on the "
                             "boxes' device")
        weight = boxes_valid.to(torch.float32).contiguous()

    heights, widths, scales, _ = level_geometry(
        [tuple(f.shape[1:3]) for f in features], image_size)
    ptrs = (ctypes.c_void_p * LEVELS)(*[f.data_ptr() for f in features])
    hw = (ctypes.c_int * (2 * LEVELS))(
        *[int(v) for pair in zip(heights, widths) for v in pair])
    lvl_scales = (ctypes.c_float * LEVELS)(*[float(s) for s in scales])
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=torch.float32, device=boxes.device)
    lib = _build.load()
    _build.check(lib.hnd_roi_align_fwd(
        ptrs, hw, lvl_scales, boxes.data_ptr(), level.data_ptr(),
        None if weight is None else weight.data_ptr(), out.data_ptr(),
        b * n, n, c, int(output_size), int(sampling_ratio),
        torch.cuda.current_stream(boxes.device).cuda_stream),
        "hnd_roi_align_fwd")
    roi_align.launches += 1
    return out


roi_align.launches = 0
