"""Synthetic tiny-COCO fixture: images with axis-aligned coloured
rectangles and a full COCO JSON (bbox, polygon segmentation, person
keypoints), for the demos and benchmarks without the real dataset.

The port's copy of tests/fixtures.py (the JAX package's fixture): the same
arguments, the same draws in the same order, the same files for a seed.
PIL is imported by ``make_coco_fixture`` alone (it writes the JPEGs)."""
from __future__ import annotations

import json
import os

import numpy as np


def make_coco_fixture(root: str, num_images: int = 8, seed: int = 0,
                      size_range=((60, 100), (60, 100)),
                      max_objects: int = 4, num_classes: int = 3,
                      keypoints: bool = False, empty_prob: float = 0.0):
    """Write images/ + annotations.json under ``root``.
    Returns (img_dir, ann_file)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)

    images, annotations = [], []
    ann_id = 1
    for img_id in range(1, num_images + 1):
        h = rng.randint(*size_range[0])
        w = rng.randint(*size_range[1])
        arr = rng.randint(0, 60, size=(h, w, 3), dtype=np.uint8)
        n_obj = (0 if rng.rand() < empty_prob
                 else rng.randint(1, max_objects + 1))
        for _ in range(n_obj):
            bw = rng.randint(8, max(9, w // 2))
            bh = rng.randint(8, max(9, h // 2))
            x = rng.randint(0, w - bw)
            y = rng.randint(0, h - bh)
            color = rng.randint(120, 255, size=3)
            arr[y:y + bh, x:x + bw] = color
            cat = int(rng.randint(1, num_classes + 1))
            ann = {
                "id": ann_id, "image_id": img_id, "category_id": cat,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "segmentation": [[float(x), float(y), float(x + bw), float(y),
                                  float(x + bw), float(y + bh),
                                  float(x), float(y + bh)]],
            }
            if keypoints:
                kps = []
                for k in range(17):
                    kx = x + rng.randint(0, bw)
                    ky = y + rng.randint(0, bh)
                    kps.extend([float(kx), float(ky), 2])
                ann["keypoints"] = kps
                ann["num_keypoints"] = 17
            annotations.append(ann)
            ann_id += 1
        fname = f"{img_id:06d}.jpg"
        Image.fromarray(arr).save(os.path.join(img_dir, fname), quality=95)
        images.append({"id": img_id, "file_name": fname,
                       "height": h, "width": w})

    cats = [{"id": c, "name": f"class{c}", "supercategory": "thing"}
            for c in range(1, num_classes + 1)]
    if keypoints:
        for c in cats:
            c["keypoints"] = [f"kp{i}" for i in range(17)]
    ann_file = os.path.join(root, "annotations.json")
    with open(ann_file, "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": cats}, f)
    return img_dir, ann_file
