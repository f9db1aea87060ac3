"""COCO detection dataset (no pycocotools).

Counterpart of hnd_ghnd_tpu/data/coco.py (the reference's data layer,
src/utils/coco_util.py):
  * COCO JSON loading and per-image annotation indexing;
  * polygon -> binary mask conversion (ConvertCocoPolysToMask, :50-103),
    bit-exact with pycocotools' rasterization (evals/mask_rle.poly_to_rle);
  * filtering of images without valid annotations on the train split
    (:132-144) with the validity rule of the ext filter's ground truth
    (src/models/ext/backbone.py:19-34): non-empty boxes, and >= 10 visible
    keypoints for the keypoint task;
  * optional ``jpeg_quality`` re-encode to simulate lossy input channels
    (coco_util.py:223-226).

Images decode with libjpeg through data/native_prep.py where it is built
(JAX's coco.py:160-165), else with PIL, imported by ``load_image`` alone.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hnd_ghnd_tpu_torch.data import native_prep

# 17 COCO person keypoints; left/right index swap map for horizontal flip
COCO_PERSON_KEYPOINT_FLIP_INDS = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11,
                                  14, 13, 16, 15]


def _decode_rle_counts(counts, h: int, w: int) -> np.ndarray:
    """Decode COCO RLE counts (uncompressed list or compressed LEB128-ish
    string) into a [h, w] uint8 mask (column-major runs)."""
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    if isinstance(counts, (bytes, bytearray)):
        # pycocotools compressed RLE string
        cnts = []
        pos = 0
        while pos < len(counts):
            x = 0
            k = 0
            more = True
            while more:
                c = counts[pos] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                pos += 1
                k += 1
            if x & (1 << (5 * k - 1)):
                x |= -1 << (5 * k)
            if len(cnts) > 2:
                x += cnts[-2]
            cnts.append(x)
        counts = cnts
    flat = np.zeros(h * w, dtype=np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos:pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def rasterize_polygons(polys: Sequence[Sequence[float]], h: int, w: int) -> np.ndarray:
    """Rasterize COCO polygon(s) to a binary mask (union over parts).

    Bit-exact with pycocotools (merge(frPyObjects(...))): each part goes
    through the rleFrPoly boundary semantics (evals/mask_rle.poly_to_rle —
    5x-upsampled boundary walk) and parts union, matching the rasterization
    COCO's published numbers were computed with.
    """
    from hnd_ghnd_tpu_torch.evals import mask_rle
    mask = np.zeros((h, w), dtype=np.uint8)
    for poly in polys:
        if len(poly) < 6:
            continue
        counts = mask_rle.poly_to_rle(list(map(float, poly)), h, w)
        mask |= mask_rle.decode(counts, h, w)
    return mask


def ann_to_mask(ann: Dict[str, Any], h: int, w: int) -> np.ndarray:
    seg = ann.get("segmentation")
    if seg is None:
        return np.zeros((h, w), dtype=np.uint8)
    if isinstance(seg, dict):  # RLE (crowd regions)
        return _decode_rle_counts(seg["counts"], seg["size"][0], seg["size"][1])
    return rasterize_polygons(seg, h, w)


def _has_only_empty_bbox(anns: List[dict]) -> bool:
    return all(any(o <= 1 for o in ann["bbox"][2:]) for ann in anns)


def _count_visible_keypoints(anns: List[dict]) -> int:
    return sum(sum(1 for v in ann["keypoints"][2::3] if v > 0)
               for ann in anns if "keypoints" in ann)


def check_if_valid_target(anns: List[dict], min_keypoints_per_image: int = 10,
                          keypoint_task: Optional[bool] = None) -> bool:
    """The reference's annotation-validity rule (backbone.py:19-34 and
    coco_util.py:114-129): non-empty, non-degenerate boxes; keypoint tasks
    additionally require >= 10 visible keypoints in the image."""
    if len(anns) == 0:
        return False
    if _has_only_empty_bbox(anns):
        return False
    if keypoint_task is None:
        keypoint_task = any("keypoints" in ann for ann in anns)
    if not keypoint_task:
        return True
    return _count_visible_keypoints(anns) >= min_keypoints_per_image


class CocoDataset:
    """Indexed COCO detection dataset returning numpy targets.

    __getitem__ -> (image [H, W, 3] uint8, target dict with 'boxes' (xyxy
    float32), 'labels', 'image_id', 'area', 'iscrowd', and optionally
    'masks' [G, H, W] uint8 / 'keypoints' [G, 17, 3] float32).
    """

    def __init__(self, img_dir: str, ann_file: str, *,
                 remove_non_annotated: bool = False,
                 jpeg_quality: Optional[int] = None,
                 with_masks: bool = False, with_keypoints: bool = False):
        self.img_dir = img_dir
        self.jpeg_quality = jpeg_quality
        self.with_masks = with_masks
        self.with_keypoints = with_keypoints

        with open(ann_file) as f:
            coco = json.load(f)
        self.images = {im["id"]: im for im in coco["images"]}
        self.categories = {c["id"]: c for c in coco.get("categories", [])}
        self.anns_by_img: Dict[int, List[dict]] = {i: [] for i in self.images}
        for ann in coco.get("annotations", []):
            if ann["image_id"] in self.anns_by_img:
                self.anns_by_img[ann["image_id"]].append(ann)

        ids = sorted(self.images.keys())
        if remove_non_annotated:
            ids = [i for i in ids
                   if check_if_valid_target(
                       [a for a in self.anns_by_img[i] if a.get("iscrowd", 0) == 0],
                       keypoint_task=with_keypoints)]
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    def image_size(self, index: int) -> Tuple[int, int]:
        """The (height, width) the annotation file records for image
        ``index``, without decoding it."""
        info = self.images[self.ids[index]]
        return int(info["height"]), int(info["width"])

    def load_image(self, image_id: int) -> np.ndarray:
        from PIL import Image
        info = self.images[image_id]
        path = os.path.join(self.img_dir, info["file_name"])
        if self.jpeg_quality is None:
            # libjpeg when the native prep decodes (GIL released); PIL for
            # the rest (PNGs, other colour spaces, no libjpeg)
            with open(path, "rb") as f:
                data = f.read()
            arr = native_prep.decode_jpeg(data)
            if arr is not None:
                return arr
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"),
                              dtype=np.uint8)
        img = Image.open(path).convert("RGB")
        buf = io.BytesIO()
        img.save(buf, format="jpeg", quality=self.jpeg_quality)
        buf.seek(0)
        img = Image.open(buf).convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    def __getitem__(self, index: int):
        image_id = self.ids[index]
        img = self.load_image(image_id)
        h, w = img.shape[:2]
        # crowd annotations are excluded from training targets
        # (reference coco_util.py:58-60)
        anns = [a for a in self.anns_by_img[image_id]
                if a.get("iscrowd", 0) == 0]

        boxes = np.asarray([a["bbox"] for a in anns],
                           dtype=np.float32).reshape(-1, 4)
        boxes[:, 2:] += boxes[:, :2]  # xywh -> xyxy
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        labels = np.asarray([a["category_id"] for a in anns], dtype=np.int32)

        # drop degenerate boxes (reference coco_util.py:79-83)
        keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
        anns = [a for a, k in zip(anns, keep) if k]
        boxes = boxes[keep]
        labels = labels[keep]

        target: Dict[str, Any] = {
            "image_id": image_id,
            "boxes": boxes,
            "labels": labels,
            "area": np.asarray([a["area"] for a in anns], dtype=np.float32),
            "iscrowd": np.zeros(len(anns), dtype=np.int32),
        }
        if self.with_masks:
            target["masks"] = np.stack(
                [ann_to_mask(a, h, w) for a in anns], axis=0
            ) if anns else np.zeros((0, h, w), dtype=np.uint8)
        if self.with_keypoints:
            kps = [np.asarray(a.get("keypoints", [0] * 51),
                              dtype=np.float32).reshape(-1, 3) for a in anns]
            target["keypoints"] = (np.stack(kps, axis=0) if anns
                                   else np.zeros((0, 17, 3), dtype=np.float32))
        return img, target
