"""Multi-level RoIAlign over the CUDA kernels of csrc/roi_align.cu: the
forward on float32, bfloat16 or int8 levels, and the backward of training;
and the int8 level quantizer of csrc/fpn_quant.cu.

Replaces hnd_ghnd_tpu/ops/pallas_roi.py: ``pallas_multiscale_roi_align_batch``
(f32, bf16 and int8 tables) and ``pallas_multiscale_roi_align_batch_vjp``
(the forward kernel with the transposed gather program as its backward),
and hnd_ghnd_tpu/ops/roi_align.py's ``quantize_fpn_levels`` (XLA ops); what
bounds the kernels and how they are laid out is noted in the CUDA sources.
The plain versions are ops/roi_align.py's ``multiscale_roi_align_batch``
(with its autograd for the backward) and ``quantize_fpn_levels``: a CPU
tensor goes to them, a CUDA tensor to the kernels, and anything the kernels
do not take raises.  ``roi_align`` and ``quantize_levels`` call the
``hnd_ghnd::roi_align`` / ``quantize_levels`` ops defined here
(ops/library.py), whose CUDA implementations are ``launch_roi_align`` /
``launch_quantize_levels``; ``roi_align_train`` (autograd) launches the
kernels itself.

Launches are counted per kernel: ``roi_align.launches`` and
``roi_align_backward.launches`` (the scatter and, for bf16 levels, its
rounding pass: one launch) are Counters keyed by (levels' dtype, output
size P), since the train step pools 7x7 for the box loss and 14x14 for the
mask or keypoint loss; ``launch_count`` sums them over the sizes.
``quantize_levels.launches`` counts abs-max and codes as one launch
(``quantize_levels_args`` gives the arguments of its passes, which a
measurement can launch one at a time).

Each thread of the RoIAlign kernels owns a vector of channels of one bin;
``vector_width`` picks its width per call from C, the element size and the
pointers' alignment, and every width is the same kernel.

The RoIAlign kernels read NHWC levels.  The trunk runs NCHW, so the caller
pays one copy per float level; a channels_last map would hand over for free
(``permute(0, 2, 3, 1)`` of it is already contiguous).  The quantizer reads
the NHWC view of the NCHW maps as it is and writes NHWC codes.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import List, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops._oplib import check_device, define, on_card
from hnd_ghnd_tpu_torch.ops.roi_align import (assign_levels, level_geometry,
                                              multiscale_roi_align_batch,
                                              quantize_fpn_levels)

# P2-P5: the levels assign_levels routes RoIs to
LEVELS = 4
# the forward's level types, by hnd_roi_align_fwd's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the RoIAlign kernels' channel vectors in bytes, widest first; after them
# one element
VECTOR_BYTES = (16, 8, 4)


def vector_width(c: int, itemsize: int, addresses: Sequence[int],
                 out_itemsize: int, out_addresses: Sequence[int]) -> int:
    """Channels per thread of the RoIAlign kernels: the widest vector of
    16, 8 or 4 bytes of the tables' type (else one element) whose count of
    elements divides ``c``, with every table address (the levels, or the
    backward's cotangent) aligned to the vector and every output address
    to the pieces of at most 16 bytes the output is written in (the
    forward's bins of ``out_itemsize``-byte elements, the backward's
    float atomics)."""
    for nb in VECTOR_BYTES:
        v = nb // itemsize
        if v >= 1 and c % v == 0 and all(a % nb == 0 for a in addresses) \
                and all(a % min(16, v * out_itemsize) == 0
                        for a in out_addresses):
            return v
    return 1


# the backward adds one float4 per thread and tap, so that the lanes of a
# warp's atomic cover 512 contiguous bytes: 8 channels per thread would put
# them 32 bytes apart, touching twice the sectors (PERF.md)
ATOMIC_FLOATS = 4


def backward_width(c: int, itemsize: int, cot_address: int,
                   grad_addresses: Sequence[int]) -> int:
    """Channels per thread of the backward: ``vector_width`` of the
    cotangent into float32 gradients, at most ``ATOMIC_FLOATS``."""
    return min(vector_width(c, itemsize, [cot_address], 4, grad_addresses),
               ATOMIC_FLOATS)


def checked_inputs(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                   boxes_valid: torch.Tensor | None,
                   table_scale: torch.Tensor | None = None):
    """Validate the kernels' inputs; -> (contiguous boxes, box levels [M]
    int32, validity weights [M] f32 or None).  int8 levels come with their
    [4] float32 scales on the device (``table_scale``), and only they."""
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
        if f.dtype not in _DTYPE_CODES or f.dtype != dtype:
            raise TypeError(f"roi_align kernel takes float32, bfloat16 or "
                            f"int8 levels of one dtype, got {f.dtype}")
        if f.device != boxes.device or f.dim() != 4 or f.shape[0] != b \
                or f.shape[-1] != c or not f.is_contiguous():
            raise ValueError("roi_align kernel takes contiguous [B, H, W, C] "
                             "levels on the boxes' device with one B and C")
    if boxes.dtype != torch.float32:
        raise TypeError(f"roi_align kernel takes float32 boxes, got {boxes.dtype}")
    if (dtype == torch.int8) != (table_scale is not None):
        raise TypeError("roi_align kernel takes int8 levels together with "
                        "their scales, and scales only with int8 levels")
    if table_scale is not None and (
            tuple(table_scale.shape) != (LEVELS,)
            or table_scale.dtype != torch.float32
            or table_scale.device != boxes.device
            or not table_scale.is_contiguous()):
        raise ValueError(f"roi_align: the int8 tables' scales must be "
                         f"[{LEVELS}] float32 on the boxes' device")
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
             sampling_ratio, table_scale=None) -> torch.Tensor:
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dtype = features[0].dtype
    hw, scales = _geometry([tuple(f.shape[1:3]) for f in features], image_size)
    ptrs = (ctypes.c_void_p * LEVELS)(*[f.data_ptr() for f in features])
    out = torch.empty((b, n, output_size, output_size, c),
                      dtype=torch.float32 if dtype == torch.int8 else dtype,
                      device=boxes.device)
    vec = vector_width(c, features[0].element_size(), list(ptrs),
                       out.element_size(), [out.data_ptr()])
    with on_card(boxes.device):
        _build.check(_build.load().hnd_roi_align_fwd(
            ptrs, hw, scales, boxes.data_ptr(), level.data_ptr(),
            None if weight is None else weight.data_ptr(),
            None if table_scale is None else table_scale.data_ptr(),
            out.data_ptr(), b * n, n, c, int(output_size),
            int(sampling_ratio), _DTYPE_CODES[dtype], vec,
            _stream(boxes.device)), "hnd_roi_align_fwd")
    roi_align.launches[(dtype, int(output_size))] += 1
    return out


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              image_size: Tuple[int, int], output_size: int,
              sampling_ratio: int = 2,
              boxes_valid: torch.Tensor | None = None,
              quant: str | tuple | None = None) -> torch.Tensor:
    """Levels [B, Hl, Wl, C], boxes [B, N, 4] -> [B, N, P, P, C] in the
    levels' dtype; same semantics as ``multiscale_roi_align_batch``, the
    ``quant`` modes included ("int8", or the (codes, scales) of
    ``quantize_levels``: int8 tables of float32 levels, pooled into
    float32).  The ``hnd_ghnd::roi_align`` op."""
    check_device(boxes, "roi_align")
    table_scale = None
    if quant is not None:
        if features[0].dtype != torch.float32:
            raise TypeError(f"roi_align pools int8 tables into float32, got "
                            f"{features[0].dtype} levels")
        if quant == "int8":
            quant = quantize_levels(features)
        elif not isinstance(quant, tuple):
            raise ValueError(f"unknown roi-pool quant mode `{quant}`")
        features, table_scale = quant
    return roi_align_op(list(features), boxes, boxes_valid, table_scale,
                        [int(v) for v in image_size], int(output_size),
                        int(sampling_ratio))


def launch_roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                     boxes_valid: torch.Tensor | None,
                     table_scale: torch.Tensor | None,
                     image_size: Tuple[int, int], output_size: int,
                     sampling_ratio: int) -> torch.Tensor:
    """The forward kernel on checked inputs (``checked_inputs``)."""
    boxes, level, weight = checked_inputs(features, boxes, boxes_valid,
                                          table_scale)
    return _forward(features, boxes, level, weight, image_size, output_size,
                    sampling_ratio, table_scale)


roi_align.launches = Counter()


def launch_count(wrapper, dtype: torch.dtype) -> int:
    """The launches of ``roi_align`` or ``roi_align_backward`` on levels of
    ``dtype``, at any output size."""
    return sum(n for (d, _), n in wrapper.launches.items() if d == dtype)


def quantize_levels(levels: Sequence[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Float32 levels [B, Hl, Wl, C] -> (contiguous int8 codes of the same
    shape, scales [4] float32 on the device); bit-exact with
    ``quantize_fpn_levels``.  The levels are contiguous NHWC, or all NHWC
    views of contiguous NCHW maps (``f.permute(0, 2, 3, 1)``).  The
    ``hnd_ghnd::quantize_levels`` op."""
    check_device(levels[0], "quantize_levels")
    return quantize_levels_op(list(levels))


def launch_quantize_levels(levels: Sequence[torch.Tensor]
                           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    args, codes, scales = quantize_levels_args(levels)
    with on_card(levels[0].device):
        _build.check(_build.load().hnd_quantize_levels(*args),
                     "hnd_quantize_levels")
    quantize_levels.launches += 1
    return codes, scales


def quantize_levels_args(levels: Sequence[torch.Tensor]):
    """Check the levels and allocate the outputs of the level quantizer:
    -> (the arguments of ``hnd_quantize_levels``, codes, scales).  Each
    level's codes are an allocation of their own (16-byte aligned, and
    outputs of one op that alias nothing); the abs-max workspace (4 x
    uint32) and the scales (4 x float32) share one 8-word buffer."""
    if len(levels) != LEVELS:
        raise ValueError(f"quantize_levels takes the {LEVELS} levels P2-P5, "
                         f"got {len(levels)}")
    dev = levels[0].device
    b, c = levels[0].shape[0], levels[0].shape[-1]
    for f in levels:
        if f.dtype != torch.float32:
            raise TypeError(f"quantize_levels takes float32 levels, got "
                            f"{f.dtype}")
        if f.device != dev or f.dim() != 4 or f.shape[0] != b \
                or f.shape[-1] != c or f.numel() == 0:
            raise ValueError("quantize_levels takes non-empty [B, H, W, C] "
                             "levels on one device with one B and C")
    if all(f.is_contiguous() for f in levels):
        nchw = False
    elif all(f.permute(0, 3, 1, 2).is_contiguous() for f in levels):
        nchw = True
    else:
        raise ValueError("quantize_levels takes contiguous NHWC levels or "
                         "the NHWC views of contiguous NCHW maps")
    codes = [torch.empty(f.shape, dtype=torch.int8, device=dev)
             for f in levels]
    meta = torch.empty(2 * LEVELS, dtype=torch.int32, device=dev)
    scales = meta[LEVELS:].view(torch.float32)
    hw = (ctypes.c_int * (2 * LEVELS))(
        *[int(v) for f in levels for v in f.shape[1:3]])
    args = ((ctypes.c_void_p * LEVELS)(*[f.data_ptr() for f in levels]),
            (ctypes.c_void_p * LEVELS)(*[q.data_ptr() for q in codes]),
            hw, b, c, int(nchw), meta.data_ptr(), scales.data_ptr(),
            _stream(dev))
    return args, codes, scales


quantize_levels.launches = 0


def _roi_align_cpu(levels, boxes, boxes_valid, table_scale, image_size,
                   output_size, sampling_ratio):
    quant = None if table_scale is None else (levels, table_scale)
    return multiscale_roi_align_batch(levels, boxes, tuple(image_size),
                                      output_size, sampling_ratio,
                                      boxes_valid, quant)


def _roi_align_cuda(levels, boxes, boxes_valid, table_scale, image_size,
                    output_size, sampling_ratio):
    return launch_roi_align(levels, boxes, boxes_valid, table_scale,
                            tuple(image_size), output_size, sampling_ratio)


def _roi_align_fake(levels, boxes, boxes_valid, table_scale, image_size,
                    output_size, sampling_ratio):
    dtype = levels[0].dtype
    b, n = boxes.shape[:2]
    return boxes.new_empty(
        (b, n, output_size, output_size, levels[0].shape[-1]),
        dtype=torch.float32 if dtype == torch.int8 else dtype)


# multi-level RoIAlign: levels [B, Hl, Wl, C] (float32, bfloat16, or int8
# tables with their [4] table_scale), boxes [B, N, 4] -> [B, N, P, P, C] in
# the levels' dtype (float32 from int8 tables)
roi_align_op = define(
    "roi_align(Tensor[] levels, Tensor boxes, Tensor? boxes_valid, "
    "Tensor? table_scale, int[] image_size, int output_size, "
    "int sampling_ratio) -> Tensor",
    _roi_align_cpu, _roi_align_cuda, _roi_align_fake)


def _quantize_levels_fake(levels):
    return ([torch.empty(f.shape, dtype=torch.int8, device=f.device)
             for f in levels],
            levels[0].new_empty(len(levels), dtype=torch.float32))


# float32 levels [B, Hl, Wl, C] -> (contiguous int8 codes of each, the [4]
# float32 scales)
quantize_levels_op = define(
    "quantize_levels(Tensor[] levels) -> (Tensor[], Tensor)",
    quantize_fpn_levels, launch_quantize_levels, _quantize_levels_fake)


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
    vec = backward_width(c, grad_out.element_size(), grad_out.data_ptr(),
                         list(ptrs))
    lib = _build.load()
    bf16 = dtype == torch.bfloat16
    with on_card(dev):
        _build.check(lib.hnd_roi_align_bwd(
            ptrs, hw, scales, boxes.data_ptr(), level.data_ptr(),
            None if weight is None else weight.data_ptr(),
            grad_out.data_ptr(), b * n, n, c, p, int(sampling_ratio),
            int(bf16), vec, _stream(dev)), "hnd_roi_align_bwd")
        if bf16:
            out = torch.empty(acc.shape, dtype=torch.bfloat16, device=dev)
            _build.check(lib.hnd_f32_to_bf16(acc.data_ptr(), out.data_ptr(),
                                             acc.numel(), _stream(dev)),
                         "hnd_f32_to_bf16")
            views = list(torch.split(out, sizes))
    roi_align_backward.launches[(dtype, int(p))] += 1
    return [v.view(b, h, w, c) for v, (h, w) in zip(views, shapes)]


roi_align_backward.launches = Counter()


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
