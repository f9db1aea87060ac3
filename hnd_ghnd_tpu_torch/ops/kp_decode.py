"""The keypoint decode on the device (``params.kp_decode: device``).

Counterpart of hnd_ghnd_tpu/ops/kp_decode.py.  The reference decodes on
the host inside torchvision (heatmaps_to_keypoints): each detection's
56x56 heatmap is resized bicubically to the box's own pixel size, and the
argmax's grid index mapped to image coordinates (evals/postprocess.py does
the same).  This module samples the same cubic surface (cv2 INTER_CUBIC,
a = -0.75, border-replicating taps) on a static G x G grid with two matrix
products per image, takes its argmax there, and hands the host only the
argmax's position in heatmap source coordinates.  The image mapping
``keypoints_from_device_argmax`` applies is torchvision's,
x = (u + 0.5) * w / S + x1; the two decodes differ only in the grid the
argmax is searched on (spacing S / rw against S / G).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """The cubic convolution kernel (cv2 INTER_CUBIC: a = -0.75)."""
    ax = np.abs(x)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
        np.where(ax < 2.0,
                 a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a,
                 0.0))
    return w.astype(np.float64)


def cubic_resize_matrix(src: int, dst: int, a: float = -0.75) -> np.ndarray:
    """[dst, src] float32 matrix M such that M @ f samples f's cubic
    surface at cv2.resize's sample positions u = (i + 0.5) * src / dst
    - 0.5, the taps past the border replicating it."""
    m = np.zeros((dst, src), np.float64)
    scale = src / dst
    for i in range(dst):
        u = (i + 0.5) * scale - 0.5
        taps = np.arange(math.floor(u) - 1, math.floor(u) + 3)
        for t, wt in zip(taps, _cubic_kernel(taps - u, a)):
            m[i, min(max(t, 0), src - 1)] += wt
    return m.astype(np.float32)


def device_keypoint_argmax(kp_logits: torch.Tensor, grid: int = 224,
                           a: float = -0.75
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """kp_logits [B, D, S, S, K] (any float dtype; the surface is float32)
    -> (u, v, score), each [B, D, K] float32: the argmax of each heatmap's
    cubic surface on the G x G grid, as x (u) and y (v) in heatmap source
    coordinates, and the surface there.

    One image at a time, as JAX's lax.map: one image's surface is
    [D, G, G, K] float32, 340 MB at D = 100, G = 224, K = 17."""
    b, d, s, _, k = kp_logits.shape
    w_mat = torch.from_numpy(cubic_resize_matrix(s, grid, a)).to(
        kp_logits.device)                                   # [G, S]
    pos, score = [], []
    for hm in kp_logits:                                    # [D, S, S, K]
        hm32 = hm.to(torch.float32)
        # y then x: [D, S(y), S(x), K] -> [D, G(y), S(x), K] -> [D, G, G, K]
        t = torch.einsum("gy,dyxk->dgxk", w_mat, hm32)
        up = torch.einsum("hx,dgxk->dghk", w_mat, t)
        flat = up.reshape(d, grid * grid, k)
        p = torch.argmax(flat, dim=1)                       # [D, K]
        pos.append(p)
        score.append(torch.gather(flat, 1, p[:, None, :])[:, 0, :])
    pos = torch.stack(pos)
    iy = torch.div(pos, grid, rounding_mode="floor").to(torch.float32)
    ix = (pos % grid).to(torch.float32)
    scale = s / grid
    u = (ix + 0.5) * scale - 0.5
    v = (iy + 0.5) * scale - 0.5
    return u, v, torch.stack(score)


def keypoints_from_device_argmax(u: np.ndarray, v: np.ndarray,
                                 score: np.ndarray, boxes_model: np.ndarray,
                                 scale_yx: Tuple[float, float], s: int = 56
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The host's finish: source-space argmax positions u, v and their
    scores [N, K] of boxes ``boxes_model`` [N, 4] (xyxy in the padded
    model's coordinates) -> (keypoints [N, K, 3], scores [N, K]) in the
    original image, as evals/postprocess.heatmaps_to_keypoints returns."""
    ry, rx = scale_yx
    x1 = boxes_model[:, 0:1]
    y1 = boxes_model[:, 1:2]
    w = np.maximum(boxes_model[:, 2:3] - x1, 1.0)
    h = np.maximum(boxes_model[:, 3:4] - y1, 1.0)
    x = ((u + 0.5) * (w / s) + x1) * rx
    y = ((v + 0.5) * (h / s) + y1) * ry
    kps = np.stack([x, y, np.ones_like(x)], axis=-1).astype(np.float32)
    return kps, score.astype(np.float32)
