"""Multi-level RoIAlign over the CUDA kernels of csrc/roi_align.cu: the
forward on float32 or bfloat16 levels, and the backward of training.

Replaces hnd_ghnd_tpu/ops/pallas_roi.py: ``pallas_multiscale_roi_align_batch``
(f32 and bf16 tables) and ``pallas_multiscale_roi_align_batch_vjp`` (the
forward kernel with the transposed gather program as its backward); what
bounds the kernels and how they are laid out is noted in the CUDA source.
The plain version is ops/roi_align.py's ``multiscale_roi_align_batch``, and
its autograd for the backward: a CPU tensor goes to it, a CUDA tensor to
the kernels, and anything the kernels do not take raises (the int8 tables
are ROADMAP B3).

Launches are counted per kernel: ``roi_align.launches`` (f32 levels),
``roi_align.launches_bf16`` (bf16 levels) and ``roi_align_backward.launches``
(the scatter and, for bf16 levels, its rounding pass: one launch).

The kernels read NHWC levels.  The trunk runs NCHW, so the caller pays one
copy per level; a channels_last map would hand over for free
(``permute(0, 2, 3, 1)`` of it is already contiguous).
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops.roi_align import (assign_levels, level_geometry,
                                              multiscale_roi_align_batch)

# P2-P5: the levels assign_levels routes RoIs to
LEVELS = 4
_DTYPES = (torch.float32, torch.bfloat16)


def checked_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   boxes_valid: torch.Tensor | None):
    """Validate the kernels' inputs; -> (contiguous boxes, box levels [M]
    int32, validity weights [M] f32 or None)."""
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
    dtype = features[0].dtype
    for f in features:
        if f.dtype not in _DTYPES or f.dtype != dtype:
            raise TypeError(f"roi_align kernel takes float32 or bfloat16 "
                            f"levels of one dtype, got {f.dtype} (int8 "
                            f"tables: ROADMAP B3)")
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
    return boxes, level, weight


def _geometry(shapes: Sequence[Tuple[int, int]], image_size: Tuple[int, int]):
    """(level_hw, level_scales) as ctypes arrays for the kernels."""
    heights, widths, scales, _ = level_geometry(shapes, image_size)
    hw = (ctypes.c_int * (2 * LEVELS))(
        *[int(v) for pair in zip(heights, widths) for v in pair])
    return hw, (ctypes.c_float * LEVELS)(*[float(s) for s in scales])


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _forward(features, boxes, level, weight, image_size, output_size,
             sampling_ratio) -> torch.Tensor:
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    bf16 = features[0].dtype == torch.bfloat16
    hw, scales = _geometry([tuple(f.shape[1:3]) for f in features], image_size)
    ptrs = (ctypes.c_void_p * LEVELS)(*[f.data_ptr() for f in features])
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=features[0].dtype, device=boxes.device)
    _build.check(_build.load().hnd_roi_align_fwd(
        ptrs, hw, scales, boxes.data_ptr(), level.data_ptr(),
        None if weight is None else weight.data_ptr(), out.data_ptr(),
        b * n, n, c, int(output_size), int(sampling_ratio), int(bf16),
        _stream(boxes.device)), "hnd_roi_align_fwd")
    if bf16:
        roi_align.launches_bf16 += 1
    else:
        roi_align.launches += 1
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              image_size: Tuple[int, int], output_size: int,
              sampling_ratio: int = 2,
              boxes_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Levels [B, Hl, Wl, C], boxes [B, N, 4] -> [B, N, P, P, C] in the
    levels' dtype; same semantics as ``multiscale_roi_align_batch``."""
    if boxes.device.type == "cpu":
        return multiscale_roi_align_batch(features, boxes, image_size,
                                          output_size, sampling_ratio,
                                          boxes_valid)
    boxes, level, weight = checked_inputs(features, boxes, boxes_valid)
    return _forward(features, boxes, level, weight, image_size, output_size,
                    sampling_ratio)


roi_align.launches = 0
roi_align.launches_bf16 = 0


def roi_align_backward(grad_out: torch.Tensor,
                       shapes: Sequence[Tuple[int, int]], dtype: torch.dtype,
                       boxes: torch.Tensor, level: torch.Tensor,
                       weight: torch.Tensor | None,
                       image_size: Tuple[int, int],
                       sampling_ratio: int) -> List[torch.Tensor]:
    """The levels' gradients [B, Hl, Wl, C] in ``dtype`` from the output's
    cotangent [B, N, P, P, C], for boxes, levels and weights from
    ``checked_inputs``."""
    b, n, p = grad_out.shape[:3]
    c = grad_out.shape[-1]
    if grad_out.dtype != dtype or tuple(grad_out.shape) != (b, n, p, p, c):
        raise TypeError(f"roi_align backward: cotangent {grad_out.dtype} "
                        f"{tuple(grad_out.shape)} for {dtype} levels")
    grad_out = grad_out.contiguous()
    dev = grad_out.device
    sizes = [b * h * w * c for h, w in shapes]
    # f32 levels take the adds straight; bf16 ones through a f32 workspace
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    views = list(torch.split(acc, sizes))
    hw, scales = _geometry(shapes, image_size)
    ptrs = (ctypes.c_void_p * LEVELS)(*[v.data_ptr() for v in views])
    lib = _build.load()
    bf16 = dtype == torch.bfloat16
    _build.check(lib.hnd_roi_align_bwd(
        ptrs, hw, scales, boxes.data_ptr(), level.data_ptr(),
        None if weight is None else weight.data_ptr(), grad_out.data_ptr(),
        b * n, n, c, p, int(sampling_ratio), int(bf16), _stream(dev)),
        "hnd_roi_align_bwd")
    if bf16:
        out = torch.empty(acc.shape, dtype=torch.bfloat16, device=dev)
        _build.check(lib.hnd_f32_to_bf16(acc.data_ptr(), out.data_ptr(),
                                         acc.numel(), _stream(dev)),
                     "hnd_f32_to_bf16")
        views = list(torch.split(out, sizes))
    roi_align_backward.launches += 1
    return [v.view(b, h, w, c) for v, (h, w) in zip(views, shapes)]


roi_align_backward.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient in the
    levels.  Boxes and validity weights get no gradient, as torchvision's
    roi_align has no rois gradient (pallas_roi.py:476-484)."""

    @staticmethod
    def forward(ctx, boxes, boxes_valid, image_size, output_size,
                sampling_ratio, *features):
        boxes, level, weight = checked_inputs(features, boxes, boxes_valid)
        ctx.save_for_backward(boxes, level, weight)
        ctx.shapes = [tuple(f.shape[1:3]) for f in features]
        ctx.dtype = features[0].dtype
        ctx.geom = (image_size, sampling_ratio)
        return _forward(features, boxes, level, weight, image_size,
                        output_size, sampling_ratio)

    @staticmethod
    def backward(ctx, grad_out):
        boxes, level, weight = ctx.saved_tensors
        image_size, sampling_ratio = ctx.geom
        grads = roi_align_backward(grad_out, ctx.shapes, ctx.dtype, boxes,
                                   level, weight, image_size, sampling_ratio)
        return (None, None, None, None, None, *grads)


def roi_align_train(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                    image_size: Tuple[int, int], output_size: int,
                    sampling_ratio: int = 2,
                    boxes_valid: torch.Tensor | None = None) -> torch.Tensor:
    """``roi_align``, differentiable in the levels: the counterpart of
    ``pallas_multiscale_roi_align_batch_vjp``.  On the CPU the plain
    version, whose autograd is the plain backward."""
    boxes = boxes.detach()
    if boxes.device.type == "cpu":
        return multiscale_roi_align_batch(features, boxes, image_size,
                                          output_size, sampling_ratio,
                                          boxes_valid)
    return RoIAlignFunction.apply(boxes, boxes_valid,
                                  tuple(image_size), int(output_size),
                                  int(sampling_ratio), *features)
