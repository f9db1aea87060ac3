"""Host-side image transforms: augmentation, resize, static bucketing.

Counterpart of hnd_ghnd_tpu/data/transforms.py, which replaces the
reference's GeneralizedRCNNTransform resize/pad (src/models/org/rcnn.py:
25-82) and train-time augmentation (src/structure/transformer.py:12-55)
with a host pipeline that produces a few static shapes:

  * bilinear resize so the min side hits the target (max side capped at
    1333), half-pixel centers = align_corners=False semantics (cv2,
    imported by the functions that resize);
  * horizontal flip mirrors boxes, masks, and the 17-keypoint left/right map;
  * images are padded bottom/right into one of a small set of aspect-ratio
    buckets, so teacher and student consume the same padded batch.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from hnd_ghnd_tpu_torch.data.coco import COCO_PERSON_KEYPOINT_FLIP_INDS

# (h, w) buckets, stride-64 aligned; landscape + portrait at COCO eval scale
DEFAULT_BUCKETS = ((832, 1344), (1344, 832))


def hflip_targets(target: Dict, w: int) -> Dict:
    """Mirror boxes/masks/keypoints for an image of width ``w`` (the pixels
    are flipped by ``hflip``)."""
    target = dict(target)
    if len(target.get("boxes", ())):
        b = target["boxes"].copy()
        b[:, [0, 2]] = w - target["boxes"][:, [2, 0]]
        target["boxes"] = b
    if "masks" in target and len(target["masks"]):
        target["masks"] = target["masks"][:, :, ::-1].copy()
    if "keypoints" in target and len(target["keypoints"]):
        kp = target["keypoints"][:, COCO_PERSON_KEYPOINT_FLIP_INDS].copy()
        kp[..., 0] = w - kp[..., 0]
        kp[target["keypoints"][:, COCO_PERSON_KEYPOINT_FLIP_INDS][..., 2] == 0] = 0
        target["keypoints"] = kp
    return target


def hflip(img: np.ndarray, target: Dict) -> Tuple[np.ndarray, Dict]:
    target = hflip_targets(target, img.shape[1])
    return np.ascontiguousarray(img[:, ::-1]), target


def resize_geometry(h: int, w: int, min_size: int,
                    max_size: int = 1333) -> Tuple[int, int, float]:
    """Output dims for the min-side resize (floor-rounded, torch
    interpolate(scale_factor) semantics)."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(h * scale), int(w * scale), scale


def resize_targets(target: Optional[Dict], h: int, w: int, nh: int,
                   nw: int) -> Optional[Dict]:
    if target is None:
        return None
    target = dict(target)
    ry, rx = nh / h, nw / w
    if len(target.get("boxes", ())):
        b = target["boxes"] * np.asarray([rx, ry, rx, ry], np.float32)
        target["boxes"] = b.astype(np.float32)
    if "masks" in target and len(target["masks"]):
        import cv2
        ms = np.stack([
            cv2.resize(m, (nw, nh), interpolation=cv2.INTER_LINEAR)
            for m in target["masks"]], axis=0)
        target["masks"] = ms.astype(np.uint8)
    if "keypoints" in target and len(target["keypoints"]):
        kp = target["keypoints"].copy()
        kp[..., 0] *= rx
        kp[..., 1] *= ry
        target["keypoints"] = kp
    return target


def resize(img: np.ndarray, target: Optional[Dict], min_size: int,
           max_size: int = 1333) -> Tuple[np.ndarray, Optional[Dict], float]:
    """Resize so min side == min_size (max side capped).  Floor-rounded output
    dims mirror torch interpolate(scale_factor) semantics."""
    import cv2
    h, w = img.shape[:2]
    nh, nw, scale = resize_geometry(h, w, min_size, max_size)
    out = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    return out, resize_targets(target, h, w, nh, nw), scale


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]] = DEFAULT_BUCKETS
                ) -> Tuple[int, int]:
    """Smallest-area bucket that fits (h, w)."""
    fitting = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fitting:
        raise ValueError(f"no bucket fits image of size {(h, w)}; "
                         f"buckets={list(buckets)}")
    return min(fitting, key=lambda b: b[0] * b[1])


def pad_to(img: np.ndarray, bucket: Tuple[int, int]) -> np.ndarray:
    h, w = img.shape[:2]
    out = np.zeros((bucket[0], bucket[1], img.shape[2]), dtype=img.dtype)
    out[:h, :w] = img
    return out
