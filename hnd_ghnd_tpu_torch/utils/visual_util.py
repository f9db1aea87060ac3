"""Prediction overlay rendering (boxes, masks, keypoint skeletons).

Counterpart of hnd_ghnd_tpu/utils/visual_util.py (reference
src/utils/visual_util.py): OpenCV drawing of detections with per-class
colors, the 91-entry COCO category table, the person-keypoint skeleton and
the 0.7 score threshold (visual_util.py:323).  cv2 is imported by the
functions that draw.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Standard 91-slot COCO category list (index = category id; N/A = unused ids)
COCO_CATEGORIES = [
    "__background__", "person", "bicycle", "car", "motorcycle", "airplane",
    "bus", "train", "truck", "boat", "traffic light", "fire hydrant", "N/A",
    "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
    "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "N/A", "backpack",
    "umbrella", "N/A", "N/A", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
    "skateboard", "surfboard", "tennis racket", "bottle", "N/A", "wine glass",
    "cup", "fork", "knife", "spoon", "bowl", "banana", "apple", "sandwich",
    "orange", "broccoli", "carrot", "hot dog", "pizza", "donut", "cake",
    "chair", "couch", "potted plant", "bed", "N/A", "dining table", "N/A",
    "N/A", "toilet", "N/A", "tv", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator",
    "N/A", "book", "clock", "vase", "scissors", "teddy bear", "hair drier",
    "toothbrush",
]

PERSON_KEYPOINT_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]

# skeleton as keypoint-index pairs (standard COCO person connections)
PERSON_SKELETON = [
    (15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11), (6, 12),
    (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2), (0, 1), (0, 2),
    (1, 3), (2, 4), (3, 5), (4, 6),
]


def _color_for(label: int) -> tuple:
    rng = np.random.RandomState(label * 7919 + 13)
    return tuple(int(c) for c in rng.randint(60, 255, size=3))


def overlay_boxes(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                  scores: Optional[np.ndarray] = None) -> np.ndarray:
    import cv2
    for i, box in enumerate(boxes):
        color = _color_for(int(labels[i]))
        x1, y1, x2, y2 = (int(v) for v in box)
        cv2.rectangle(image, (x1, y1), (x2, y2), color, 2)
        name = (COCO_CATEGORIES[labels[i]]
                if 0 <= labels[i] < len(COCO_CATEGORIES) else str(labels[i]))
        text = name if scores is None else f"{name}: {scores[i]:.2f}"
        cv2.putText(image, text, (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return image


def overlay_masks(image: np.ndarray, masks: np.ndarray,
                  labels: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    import cv2
    for i, mask in enumerate(masks):
        color = np.asarray(_color_for(int(labels[i])), dtype=np.float32)
        m = mask.astype(bool)
        image[m] = (image[m] * (1 - alpha) + color * alpha).astype(np.uint8)
        contours, _ = cv2.findContours(mask.astype(np.uint8),
                                       cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
        cv2.drawContours(image, contours, -1,
                         tuple(int(c) for c in color), 1)
    return image


def overlay_keypoints(image: np.ndarray, keypoints: np.ndarray) -> np.ndarray:
    """keypoints: [N, 17, 3]."""
    import cv2
    for kp in keypoints:
        for a, b in PERSON_SKELETON:
            if kp[a, 2] > 0 and kp[b, 2] > 0:
                cv2.line(image, (int(kp[a, 0]), int(kp[a, 1])),
                         (int(kp[b, 0]), int(kp[b, 1])), (0, 255, 255), 2)
        for x, y, v in kp:
            if v > 0:
                cv2.circle(image, (int(x), int(y)), 2, (0, 0, 255), -1)
    return image


def render_predictions(image: np.ndarray, pred: Dict[str, np.ndarray],
                       score_threshold: float = 0.7) -> np.ndarray:
    """Draw one image's predictions (the reference's 0.7 display threshold,
    visual_util.py:323)."""
    keep = np.asarray(pred["scores"]) >= score_threshold
    out = image.copy()
    out = overlay_boxes(out, np.asarray(pred["boxes"])[keep],
                        np.asarray(pred["labels"])[keep],
                        np.asarray(pred["scores"])[keep])
    if "masks" in pred:
        out = overlay_masks(out, np.asarray(pred["masks"])[keep],
                            np.asarray(pred["labels"])[keep])
    if "keypoints" in pred:
        out = overlay_keypoints(out, np.asarray(pred["keypoints"])[keep])
    return out
