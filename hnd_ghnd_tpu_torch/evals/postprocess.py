"""Host-side prediction postprocessing: mask pasting + keypoint decoding.

Counterpart of hnd_ghnd_tpu/evals/postprocess.py.  The reference does these
inside torchvision (paste_masks_in_image, heatmaps_to_keypoints,
resize_keypoints, invoked from src/models/org/rcnn.py:127-129's
postprocess).  They involve per-detection dynamic shapes, so the device
emits fixed-shape mask probabilities [D, 28, 28] and keypoint heatmaps
[D, 56, 56, K], and this module finishes the job in numpy and cv2 (imported
by the functions that resize) exactly like torchvision 0.4.2 (mask
expand-by-1px trick, bicubic heatmap upsampling); after the device decode
(``kp_decode: device``) the keypoints' argmax positions [D, K] instead.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from hnd_ghnd_tpu_torch.ops.kp_decode import keypoints_from_device_argmax


def paste_masks(mask_probs: np.ndarray, boxes: np.ndarray,
                im_h: int, im_w: int, thresh: float = 0.5) -> np.ndarray:
    """mask_probs: [N, M, M] in [0,1]; boxes xyxy in image coords.
    Returns [N, im_h, im_w] uint8 (torchvision paste_masks_in_image)."""
    import cv2
    n, m, _ = mask_probs.shape
    out = np.zeros((n, im_h, im_w), dtype=np.uint8)
    scale = (m + 2) / m
    for i in range(n):
        # expand mask by 1 px of zeros and the box by the same ratio
        padded = np.zeros((m + 2, m + 2), dtype=np.float32)
        padded[1:-1, 1:-1] = mask_probs[i]
        b = boxes[i]
        cx, cy = (b[0] + b[2]) * 0.5, (b[1] + b[3]) * 0.5
        hw, hh = (b[2] - b[0]) * 0.5 * scale, (b[3] - b[1]) * 0.5 * scale
        # torchvision truncates the expanded box to int before sizing
        x1, y1 = int(cx - hw), int(cy - hh)
        x2, y2 = int(cx + hw), int(cy + hh)
        bw = max(x2 - x1 + 1, 1)
        bh = max(y2 - y1 + 1, 1)
        resized = cv2.resize(padded, (bw, bh), interpolation=cv2.INTER_LINEAR)
        mask = (resized >= thresh).astype(np.uint8) if thresh >= 0 else resized
        ix1, iy1 = max(x1, 0), max(y1, 0)
        ix2, iy2 = min(x2 + 1, im_w), min(y2 + 1, im_h)
        if ix2 <= ix1 or iy2 <= iy1:
            continue
        out[i, iy1:iy2, ix1:ix2] = mask[iy1 - y1:iy2 - y1, ix1 - x1:ix2 - x1]
    return out


def heatmaps_to_keypoints(heatmaps: np.ndarray, boxes_model: np.ndarray,
                          scale_yx: Tuple[float, float]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """heatmaps: [N, S, S, K] logits; boxes_model: xyxy in padded-model
    coords; scale_yx: (orig_h/model_h, orig_w/model_w) resize ratios.

    Returns (keypoints [N, K, 3] in original image coords, scores [N, K]) —
    torchvision heatmaps_to_keypoints + resize_keypoints semantics (bicubic
    per-box upsampling, +0.5 pixel-center correction).
    """
    import cv2
    n, s, _, k = heatmaps.shape
    kps = np.zeros((n, k, 3), dtype=np.float32)
    scores = np.zeros((n, k), dtype=np.float32)
    ry, rx = scale_yx
    for i in range(n):
        x1, y1, x2, y2 = boxes_model[i]
        w = max(x2 - x1, 1.0)
        h = max(y2 - y1, 1.0)
        rw = int(math.ceil(w))
        rh = int(math.ceil(h))
        wc = w / rw
        hc = h / rh
        hm = heatmaps[i]  # [S, S, K]
        roi_map = cv2.resize(hm, (rw, rh), interpolation=cv2.INTER_CUBIC)
        if roi_map.ndim == 2:
            roi_map = roi_map[:, :, None]
        flat = roi_map.reshape(-1, k)
        pos = flat.argmax(axis=0)
        y_int, x_int = pos // rw, pos % rw
        x = (x_int + 0.5) * wc + x1
        y = (y_int + 0.5) * hc + y1
        kps[i, :, 0] = x * rx
        kps[i, :, 1] = y * ry
        kps[i, :, 2] = 1.0
        scores[i] = flat[pos, np.arange(k)]
    return kps, scores


def finalize_predictions(dets: Dict[str, np.ndarray], image_index: int,
                         original_size: Tuple[int, int],
                         image_size: Tuple[int, int]) -> Dict[str, np.ndarray]:
    """Convert one image's fixed-shape device outputs into variable-length
    host predictions for the evaluator / visualizer."""
    valid = np.asarray(dets["valid"][image_index]).astype(bool)

    def _f32(x):
        # cv2's resize takes float32: normalize every float payload here
        a = np.asarray(x)
        return a.astype(np.float32) if a.dtype != np.float32 else a

    out = {
        "boxes": _f32(dets["boxes"][image_index])[valid],
        "scores": _f32(dets["scores"][image_index])[valid],
        "labels": np.asarray(dets["labels"][image_index])[valid],
    }
    oh, ow = original_size
    if "mask_probs" in dets:
        probs = _f32(dets["mask_probs"][image_index])[valid]
        out["masks"] = paste_masks(probs, out["boxes"], oh, ow)
    if "keypoint_logits" in dets:
        hm = _f32(dets["keypoint_logits"][image_index])[valid]
        bm = _f32(dets["boxes_model"][image_index])[valid]
        ih, iw = image_size
        kps, kp_scores = heatmaps_to_keypoints(hm, bm, (oh / ih, ow / iw))
        out["keypoints"] = kps
        out["keypoints_scores"] = kp_scores
    elif "kp_u" in dets:
        # the device decode (ops/kp_decode.py): only the argmax positions
        # [D, K] in heatmap source coordinates reach the host
        bm = _f32(dets["boxes_model"][image_index])[valid]
        ih, iw = image_size
        kps, kp_scores = keypoints_from_device_argmax(
            _f32(dets["kp_u"][image_index])[valid],
            _f32(dets["kp_v"][image_index])[valid],
            _f32(dets["kp_score"][image_index])[valid],
            bm, (oh / ih, ow / iw))
        out["keypoints"] = kps
        out["keypoints_scores"] = kp_scores
    return out
