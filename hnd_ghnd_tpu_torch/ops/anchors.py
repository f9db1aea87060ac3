"""Anchor generation for FPN R-CNN (numpy; constants per bucket).

A copy of hnd_ghnd_tpu/ops/anchors.py: importing that module runs
hnd_ghnd_tpu/ops/__init__.py, which imports jax, and the GPU host has no
jax.  torchvision 0.4.2 AnchorGenerator semantics: sizes 32..512 over five
levels, aspect ratios (0.5, 1.0, 2.0), position-major / anchor-minor order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

DEFAULT_ANCHOR_SIZES: Tuple[Tuple[int, ...], ...] = ((32,), (64,), (128,), (256,), (512,))
DEFAULT_ASPECT_RATIOS: Tuple[Tuple[float, ...], ...] = ((0.5, 1.0, 2.0),) * 5


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float]) -> np.ndarray:
    """Zero-centred template anchors [A, 4] for one level, rounded like
    torchvision's ``generate_anchors``."""
    scales = np.asarray(sizes, dtype=np.float32)
    ratios = np.asarray(aspect_ratios, dtype=np.float32)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


def grid_anchors(
    grid_sizes: Sequence[Tuple[int, int]],
    image_size: Tuple[int, int],
    sizes: Sequence[Sequence[float]] = DEFAULT_ANCHOR_SIZES,
    aspect_ratios: Sequence[Sequence[float]] = DEFAULT_ASPECT_RATIOS,
) -> List[np.ndarray]:
    """Per-level anchors [h_l * w_l * A, 4] for a padded image of
    ``image_size`` (H, W); strides are float image_size / grid_size."""
    out = []
    for (gh, gw), lvl_sizes, lvl_ratios in zip(grid_sizes, sizes, aspect_ratios):
        base = cell_anchors(lvl_sizes, lvl_ratios)
        stride_h = image_size[0] / gh
        stride_w = image_size[1] / gw
        shifts_x = np.arange(gw, dtype=np.float32) * stride_w
        shifts_y = np.arange(gh, dtype=np.float32) * stride_h
        sx, sy = np.meshgrid(shifts_x, shifts_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        out.append((shifts + base[None, :, :]).reshape(-1, 4).astype(np.float32))
    return out
