"""Multi-level RoIAlign, plain PyTorch (the reference for the CUDA kernel).

Counterpart of hnd_ghnd_tpu/ops/roi_align.py (the XLA gather program that
JAX runs on the CPU), operation for operation: torchvision 0.4.2 semantics,
legacy non-aligned sampling, roi size clamped to >= 1, samples outside
[-1, size] contribute 0, the FPN level per RoI by the canonical heuristic.
Layout is the JAX package's: levels [B, H, W, C], boxes [B, N, 4],
output [B, N, P, P, C].

int8 tables (roi_align.py:201-271): ``quantize_fpn_levels`` codes each
level symmetrically with one batch-global scale, and ``quant`` pools those
codes, converted exactly to float32, with the level's scale folded into the
bilinear weights as JAX folds it: ((wy*oky) * (wx*okx)) * (0.25*scale).
The output keeps the dtype of the unquantized levels.

bfloat16 levels are upcast to float32, pooled by the float32 program and
rounded once to bfloat16: the TPU kernel's arithmetic (bf16 windows,
float32 accumulation, one cast at the end, pallas_roi.py:300-304,
335-339).  Both JAX programs also round the bilinear weights to bfloat16
(the kernel for its single-pass MXU dot, the XLA path for all of them,
roi_align.py:168-173); that rounding serves the MXU, so the weights here
stay float32 and the result is closer to the exact one.

The function is differentiable in the levels: its autograd is the plain
backward (a scatter-add of the cotangent through the same weights, one
``index_add_`` a tap, into a float32 table that is rounded once to the
levels' dtype).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

CANONICAL_SCALE = 224.0
CANONICAL_LEVEL = 4
LVL_MIN = 2
LVL_MAX = 5


def assign_levels(boxes: torch.Tensor) -> torch.Tensor:
    """0-based FPN level index per RoI (int32)."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    scale = torch.sqrt((w * h).clamp(min=0.0))
    k = torch.floor(CANONICAL_LEVEL + torch.log2(scale / CANONICAL_SCALE + 1e-6))
    k = k.clamp(LVL_MIN, LVL_MAX)
    return (k - LVL_MIN).to(torch.int32)


def _bilinear_params(coord: torch.Tensor, size: torch.Tensor):
    """(low_idx, high_idx, low_weight, high_weight, in_range) along one axis."""
    in_range = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    low = torch.floor(c)
    snap = low >= size - 1.0
    low = torch.where(snap, size - 1.0, low)
    c = torch.where(snap, low, c)
    high = torch.where(snap, low, low + 1.0)
    l_frac = c - low
    return (low.to(torch.int64), high.to(torch.int64), 1.0 - l_frac, l_frac,
            in_range)


def level_geometry(shapes: Sequence[Tuple[int, int]],
                   image_size: Tuple[int, int]):
    """(heights, widths, scales, row offsets) of the levels, from their
    [H, W] shapes; scales are torchvision's 2^round(log2(feat / image))."""
    heights = np.array([s[0] for s in shapes], dtype=np.float32)
    widths = np.array([s[1] for s in shapes], dtype=np.float32)
    scales = np.array(
        [2.0 ** np.round(np.log2(s[0] / float(image_size[0]))) for s in shapes],
        dtype=np.float32)
    offsets = np.concatenate(
        [[0], np.cumsum([s[0] * s[1] for s in shapes])])[:len(shapes)]
    return heights, widths, scales, offsets.astype(np.int64)


def quantize_fpn_levels(features: Sequence[torch.Tensor]):
    """Symmetric int8 codes per level: (codes [B, Hl, Wl, C] int8, scales
    [L] float32).  s = max|f| / 127 (1 where that max is 0 or NaN) over the
    whole level, batch and padding included (ROADMAP C3); q = clamp(round-
    half-even(f / s), -127, 127), 0 where f / s is NaN."""
    codes, scales = [], []
    for f in features:
        f = f.float()
        amax = f.abs().max()
        # tensor divisors: PyTorch's CUDA division by a Python number
        # multiplies by its reciprocal, not the IEEE quotient (ROADMAP C1)
        s = torch.where(amax > 0, amax / torch.tensor(127.0, device=f.device),
                        torch.ones_like(amax))
        # a NaN quotient (a NaN, or inf / inf) codes 0, as XLA's convert
        # makes it: torch's cast of NaN differs by device (ROADMAP C12)
        codes.append(torch.round(f / s).clamp(-127, 127).nan_to_num(nan=0.0)
                     .to(torch.int8).contiguous())
        scales.append(s)
    return codes, torch.stack(scales)


def multiscale_roi_align_batch(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    image_size: Tuple[int, int],
    output_size: int,
    sampling_ratio: int = 2,
    boxes_valid: torch.Tensor | None = None,
    quant: str | tuple | None = None,
) -> torch.Tensor:
    """Levels [B, Hl, Wl, C], boxes [B, N, 4] -> [B, N, P, P, C].

    ``quant``: None; "int8" to pool int8 codes of ``features``; or the
    (codes, scales) of ``quantize_fpn_levels``, shared by several calls."""
    b, n = boxes.shape[:2]
    c = features[0].shape[-1]
    dev = boxes.device
    # int8 tables pool into float32
    out_dtype = (torch.float32 if features[0].dtype == torch.int8
                 else features[0].dtype)
    table_scale = None
    if quant == "int8":
        features, table_scale = quantize_fpn_levels(features)
    elif isinstance(quant, tuple):
        features, table_scale = quant
    elif quant is not None:
        raise ValueError(f"unknown roi-pool quant mode `{quant}`")
    heights, widths, scales, offsets = (
        torch.as_tensor(a, device=dev) for a in level_geometry(
            [tuple(f.shape[1:3]) for f in features], image_size))
    # bfloat16 and int8 tables accumulate in float32; float64 ones in float64
    cdt = torch.promote_types(out_dtype, torch.float32)
    tables = torch.cat([f.reshape(b, -1, c).to(cdt) for f in features], dim=1)
    hw = tables.shape[1]
    table = tables.reshape(b * hw, c)
    fb = boxes.reshape(-1, 4)
    img_off = torch.arange(b, device=dev).repeat_interleave(n) * hw

    lvl = assign_levels(fb).long()
    lvl_scale = scales[lvl]
    lvl_h = heights[lvl]
    lvl_w = widths[lvl]
    lvl_off = offsets[lvl] + img_off

    x1 = fb[:, 0] * lvl_scale
    y1 = fb[:, 1] * lvl_scale
    x2 = fb[:, 2] * lvl_scale
    y2 = fb[:, 3] * lvl_scale
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    # tensor divisors: PyTorch's CUDA division by a Python number multiplies
    # by its reciprocal, which is not the IEEE quotient the kernel computes
    p_div = torch.tensor(float(output_size), device=dev)
    bin_w = roi_w / p_div
    bin_h = roi_h / p_div

    s = sampling_ratio
    bins = torch.arange(output_size, dtype=torch.float32, device=dev)
    samp = ((torch.arange(s, dtype=torch.float32, device=dev) + 0.5)
            / torch.tensor(float(s), device=dev))
    ys = (y1[:, None, None] + bins[None, :, None] * bin_h[:, None, None]
          + samp[None, None, :] * bin_h[:, None, None])  # [M, P, s]
    xs = (x1[:, None, None] + bins[None, :, None] * bin_w[:, None, None]
          + samp[None, None, :] * bin_w[:, None, None])
    y_lo, y_hi, wy_lo, wy_hi, y_ok = _bilinear_params(ys, lvl_h[:, None, None])
    x_lo, x_hi, wx_lo, wx_hi, x_ok = _bilinear_params(xs, lvl_w[:, None, None])

    ok_y = y_ok.float()
    ok_x = x_ok.float()
    inv = 1.0 / float(s * s)
    if table_scale is not None:
        # the level's dequant scale folds into the sample-mean factor
        inv = inv * table_scale.to(cdt)[lvl][:, None, None]
    w_stride = lvl_w.long()[:, None, None]
    base = lvl_off[:, None, None]
    out = None
    for sy in range(s):
        for sx in range(s):
            for yi, wy in ((y_lo, wy_lo), (y_hi, wy_hi)):
                for xi, wx in ((x_lo, wx_lo), (x_hi, wx_hi)):
                    idx = (base + yi[..., sy][:, :, None] * w_stride
                           + xi[..., sx][:, None, :])  # [M, P, P]
                    # index_select: its backward is one index_add_ a tap
                    # (advanced indexing's, index_put_ with accumulate, was
                    # ~30% of a CPU training step)
                    vals = torch.index_select(table, 0, idx.reshape(-1))
                    w = ((wy[..., sy] * ok_y[..., sy])[:, :, None]
                         * (wx[..., sx] * ok_x[..., sx])[:, None, :] * inv)
                    # in place, the same roundings in the same order: the
                    # gathered rows and the sum are this loop's own (their
                    # backward needs neither), so no [M * P * P, C] buffer
                    # is allocated a tap; never on a view (autograd would
                    # rebase it, and the backward ran 2x longer)
                    contrib = vals.mul_(w.reshape(-1, 1))
                    out = contrib if out is None else out.add_(contrib)
    out = out.reshape(b, n, output_size, output_size, c)
    if boxes_valid is not None:
        out = out * boxes_valid.to(out.dtype)[:, :, None, None, None]
    return out.to(out_dtype)
