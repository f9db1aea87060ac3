"""Batched detection data loader with static-shape bucketing.

Counterpart of hnd_ghnd_tpu/data/loader.py, which replaces the reference's
DataLoader stack (src/utils/data_util.py:18-48 + GroupedBatchSampler,
src/structure/sampler.py): aspect-ratio grouping makes every batch share
one padded bucket, and a thread pool overlaps JPEG decode/augment with the
device's work.  The per-(seed, epoch, index) random draws are the JAX
loader's, so the batches are bit-identical to its own on either path:

  * native (data/native_prep.py, the default where libprep builds): the
    pixels stay decoded uint8 until the batch is emitted, and one C call
    an image resizes, flips, normalises and pads it into its slot;
  * pure (``HND_TPU_NATIVE_PREP=0``, or no libprep): cv2 resize, numpy
    flip and pad.

The first loader of a process logs which path it took and why.

Batch layout:
  images          [B, H, W, 3] float32 in [0, 1], or uint8 codes under
                  ``pixel_dtype: uint8`` (bucket-padded)
  image_sizes     [B, 2] int32   valid (h, w) inside the bucket
  original_sizes  [B, 2] int32   pre-resize (h, w)
Targets:
  boxes [B, G, 4] f32, labels [B, G] i32, boxes_valid [B, G] bool, and
  masks_crop [B, G, 114, 114] f16 / keypoints [B, G, 17, 3] f32 when the
  dataset has them; G = MAX_GT.
Each batch also carries its per-image host targets (``is_padding`` marks
the rows that repeat an image to fill the last batch of a bucket).

The loader plans each epoch's batches from the image sizes the annotation
file records (``_plan``; each decoded image is checked against its planned
bucket).  ``rows=(k, n)`` makes it device k of an n-device mesh
(parallel/mesh.py): it decodes and yields only rows [k*b/n, (k+1)*b/n) of
each process-level batch, padded to the batch's bucket, as ``put_batch``
gives device k its rows; k >= n yields nothing.
"""
from __future__ import annotations

import random
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from hnd_ghnd_tpu_torch.data import native_prep
from hnd_ghnd_tpu_torch.data import transforms as T
from hnd_ghnd_tpu_torch.data.coco import CocoDataset

MAX_GT = 100
MASK_CROP_SIZE = 112  # box-aligned gt mask raster resolution (+1px border)


def mask_box_crop(mask: np.ndarray, box) -> np.ndarray:
    """Box-aligned gt raster: sample the full-res mask at the pixel centers
    of an R x R grid over the gt box (exact bilinear — the same sample
    points reference project_masks_on_boxes reads from the full-image
    raster), with a 1px zero border so device-side projection decays to
    zero outside the box.  Returns [R+2, R+2] float16."""
    import cv2
    r = MASK_CROP_SIZE
    x1, y1, x2, y2 = [float(v) for v in box]
    gw = max(x2 - x1, 1.0)
    gh = max(y2 - y1, 1.0)
    affine = np.asarray([[gw / r, 0.0, x1 + 0.5 * gw / r],
                         [0.0, gh / r, y1 + 0.5 * gh / r]], np.float32)
    crop = cv2.warpAffine(
        mask.astype(np.float32), affine, (r, r),
        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP,
        borderMode=cv2.BORDER_CONSTANT, borderValue=0.0)
    out = np.zeros((r + 2, r + 2), np.float16)
    out[1:-1, 1:-1] = crop.astype(np.float16)
    return out


def _pad_targets(targets: List[Dict], max_gt: int = MAX_GT,
                 bucket=None) -> Dict[str, np.ndarray]:
    b = len(targets)
    boxes = np.zeros((b, max_gt, 4), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    valid = np.zeros((b, max_gt), bool)
    with_masks = any("masks" in t for t in targets) and bucket is not None
    with_kps = any("keypoints" in t for t in targets)
    if with_masks:
        r = MASK_CROP_SIZE
        masks_crop = np.zeros((b, max_gt, r + 2, r + 2), np.float16)
    if with_kps:
        kps = np.zeros((b, max_gt, 17, 3), np.float32)
    for i, t in enumerate(targets):
        g = min(len(t["boxes"]), max_gt)
        boxes[i, :g] = t["boxes"][:g]
        labels[i, :g] = t["labels"][:g]
        valid[i, :g] = True
        if with_masks and "masks" in t and g:
            for j in range(g):
                masks_crop[i, j] = mask_box_crop(t["masks"][j],
                                                 t["boxes"][j])
        if with_kps and "keypoints" in t and g:
            kps[i, :g] = t["keypoints"][:g]
    out = {"boxes": boxes, "labels": labels, "boxes_valid": valid}
    if with_masks:
        out["masks_crop"] = masks_crop
    if with_kps:
        out["keypoints"] = kps
    return out


class _RawItem:
    """A decoded image not yet resized, with its prep geometry (the native
    path).  ``shape`` is the resized one, so bucket picking and the batch's
    sizes read as on the pure path."""

    __slots__ = ("img", "nh", "nw", "flip")

    def __init__(self, img: np.ndarray, nh: int, nw: int, flip: bool):
        self.img = img
        self.nh = nh
        self.nw = nw
        self.flip = flip

    @property
    def shape(self):
        return (self.nh, self.nw, 3)


_logged_path: Optional[str] = None


def log_prep_path(native: bool) -> str:
    """Print once a process which host path the loaders take, and why;
    -> that line."""
    global _logged_path
    line = f"[loader] host prep path: {'native' if native else 'pure'} " \
           f"({native_prep.reason()})"
    if line != _logged_path:
        print(line, flush=True)
        _logged_path = line
    return line


def _bounded_map(pool: ThreadPoolExecutor, fn, items, window: int):
    """pool.map with a bounded in-flight window (submit-as-you-consume)."""
    it = iter(items)
    futs = deque()
    for _ in range(max(window, 1)):
        try:
            futs.append(pool.submit(fn, next(it)))
        except StopIteration:
            break
    while futs:
        result = futs.popleft().result()
        try:
            futs.append(pool.submit(fn, next(it)))
        except StopIteration:
            pass
        yield result


class DetectionLoader:
    """Iterates (batch, targets, host_targets) tuples."""

    def __init__(self, dataset: CocoDataset, batch_size: int, *,
                 training: bool, min_sizes: Sequence[int] = (800,),
                 max_size: int = 1333,
                 buckets: Sequence[Tuple[int, int]] = T.DEFAULT_BUCKETS,
                 hflip_prob: float = 0.5, seed: int = 0,
                 num_workers: int = 4, shard_index: int = 0,
                 num_shards: int = 1, max_gt: int = MAX_GT,
                 pixel_dtype: str = "float32",
                 rows: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.training = training
        self.min_sizes = tuple(min_sizes)
        self.max_size = max_size
        self.buckets = tuple(buckets)
        self.hflip_prob = hflip_prob if training else 0.0
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.rows = (int(rows[0]), int(rows[1]))
        if self.rows[1] < 1 or batch_size % self.rows[1]:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.rows[1]} devices")
        self.max_gt = max_gt
        # uint8 wire: batch pixels stay rounded u8 codes (4x less host
        # traffic and H2D bytes); the step turns them into float * 1/255
        # (parallel/train_step.images_to_compute)
        if pixel_dtype not in ("float32", "uint8"):
            raise ValueError(f"pixel_dtype `{pixel_dtype}` is not float32 "
                             "or uint8")
        self.pixel_dtype = np.uint8 if pixel_dtype == "uint8" else np.float32
        self.native = native_prep.available()
        log_prep_path(self.native)

    def set_epoch(self, epoch: int) -> None:
        """Shuffle seed bump (DistributedSampler.set_epoch analog,
        reference src/mimic_runner.py:83-84)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        if self.training:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _draws(self, index: int) -> Tuple[bool, int]:
        """(flip, min side) of ``index`` this epoch, from a
        per-(seed, epoch, index) rng: deterministic regardless of the
        thread pool's completion order."""
        rng = random.Random((self.seed * 1_000_003 + self.epoch) * 7919
                            + index)
        flip = self.training and rng.random() < self.hflip_prob
        min_size = (rng.choice(self.min_sizes) if self.training
                    else self.min_sizes[-1])
        return flip, min_size

    def _prepare(self, index: int):
        img, target = self.dataset[index]
        oh, ow = img.shape[:2]
        flip, min_size = self._draws(index)
        if self.native:
            # the pixels stay uint8 until _emit; the targets move here as
            # T.hflip and T.resize move them
            if flip:
                target = T.hflip_targets(target, ow)
            nh, nw, _ = T.resize_geometry(oh, ow, min_size, self.max_size)
            target = T.resize_targets(target, oh, ow, nh, nw)
            target["original_size"] = (oh, ow)
            return _RawItem(img, nh, nw, flip), target
        if flip:
            img, target = T.hflip(img, target)
        img, target, _ = T.resize(img, target, min_size, self.max_size)
        target["original_size"] = (oh, ow)
        return img, target

    def _order(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.training:
            rng = random.Random(self.seed + self.epoch)
            rng.shuffle(idx)
        idx = idx[self.shard_index::self.num_shards]
        return idx

    def _plan(self) -> List[Tuple[Tuple[int, int], List[int], int]]:
        """This epoch's batches as (bucket, dataset indices, real rows),
        from the image sizes the annotation file records, in the order the
        images arrive: aspect-ratio grouping, a bucket's batch when it
        fills, then each remainder padded by repeating its last index, so
        that shapes stay static (the extra rows carry valid=False targets
        and are dropped from eval by image_id bookkeeping)."""
        out, pending = [], {}
        for index in self._order():
            h, w = self.dataset.image_size(index)
            nh, nw, _ = T.resize_geometry(h, w, self._draws(index)[1],
                                          self.max_size)
            bucket = T.pick_bucket(nh, nw, self.buckets)
            pending.setdefault(bucket, []).append(index)
            if len(pending[bucket]) == self.batch_size:
                out.append((bucket, pending.pop(bucket), self.batch_size))
        for bucket, indices in pending.items():
            n_real = len(indices)
            indices += [indices[-1]] * (self.batch_size - n_real)
            out.append((bucket, indices, n_real))
        return out

    def __iter__(self) -> Iterator[Tuple[Dict, Dict, List[Dict]]]:
        """Rows [k*b/n, (k+1)*b/n) of each planned batch, ``rows`` = (k,
        n): the whole batch at (0, 1).  Each image is decoded once (a
        padding row reuses the image it repeats) and checked against its
        planned bucket."""
        k, n = self.rows
        if k >= n:
            return
        lo = k * self.batch_size // n
        hi = (k + 1) * self.batch_size // n
        mine = [(bucket, indices[lo:hi], max(0, min(n_real - lo, hi - lo)))
                for bucket, indices, n_real in self._plan()]
        # a repeat is padding: decode the first of each run only
        decode = [i for _, indices, _ in mine for j, i in enumerate(indices)
                  if j == 0 or i != indices[j - 1]]
        pool = ThreadPoolExecutor(max_workers=max(self.num_workers, 1))
        try:
            # bounded prefetch window: a fixed number of in-flight items,
            # not the whole epoch
            prepared = _bounded_map(pool, self._prepare, decode,
                                    window=max(4 * self.num_workers,
                                               2 * self.batch_size))
            for bucket, indices, real in mine:
                items = []
                for j, index in enumerate(indices):
                    if j and index == indices[j - 1]:
                        im, tg = items[-1]
                        items.append((im, dict(tg)))  # fresh dict: padding
                        continue
                    img, target = next(prepared)
                    got = T.pick_bucket(img.shape[0], img.shape[1],
                                        self.buckets)
                    if got != bucket:
                        raise ValueError(
                            f"image {self.dataset.ids[index]}: decoded to "
                            f"bucket {got}, its recorded size to {bucket}")
                    items.append((img, target))
                yield self._emit(bucket, items,
                                 real if real < len(items) else None)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _emit(self, bucket, items, n_real: Optional[int] = None):
        if self.native:
            imgs = np.empty((len(items),) + tuple(bucket) + (3,),
                            self.pixel_dtype)
            for i, (raw, _) in enumerate(items):
                native_prep.prep_into(raw.img, raw.nh, raw.nw, raw.flip,
                                      imgs[i])
        else:
            imgs = np.stack([T.pad_to(im, bucket) for im, _ in items], axis=0)
            if self.pixel_dtype == np.uint8:
                imgs = imgs.astype(np.uint8)
            else:
                imgs = imgs.astype(np.float32) / 255.0
        sizes = np.asarray([[im.shape[0], im.shape[1]] for im, _ in items],
                           np.int32)
        orig = np.asarray([t["original_size"] for _, t in items], np.int32)
        batch = {"images": imgs, "image_sizes": sizes, "original_sizes": orig}
        host_targets = [t for _, t in items]
        for k, t in enumerate(host_targets):
            t["is_padding"] = n_real is not None and k >= n_real
        tgt = _pad_targets(host_targets, self.max_gt, bucket=bucket)
        return batch, tgt, host_targets


def get_coco_data_loaders(dataset_config: Dict[str, Any], batch_size: int, *,
                          with_masks: bool = False,
                          with_keypoints: bool = False,
                          min_sizes: Sequence[int] = (800,),
                          max_size: int = 1333,
                          buckets: Sequence[Tuple[int, int]] = T.DEFAULT_BUCKETS,
                          shard_index: int = 0, num_shards: int = 1,
                          eval_batch_size: int = 1,
                          val_batch_size: Optional[int] = None,
                          shard_eval: bool = False,
                          pixel_dtype: str = "float32",
                          shards: Optional[Dict[str, Tuple[int, int]]] = None,
                          rows: Optional[Dict[str, Tuple[int, int]]] = None):
    """Build (train, val, test) loaders from the reference dataset YAML block
    (src/utils/data_util.py:18-48).  val/test default to batch_size=1 like
    the reference (data_util.py:44-47); ``eval_batch_size`` raises it
    (remainder batches are padded and unpadded around eval).
    ``val_batch_size`` overrides it for the VAL split only — per-epoch val
    has no reference batch-1 protocol constraint (that applies to the final
    TEST pass), so shipped configs run it batched (``tpu.eval_batch_size``).
    ``shards`` (split -> (index, count)) overrides a split's image shard;
    ``rows`` (split -> (device, devices)) gives its loader's ``rows``."""
    splits = dataset_config["splits"]
    num_workers = int(dataset_config.get("num_workers", 4))
    out = []
    for name in ("train", "val", "test"):
        cfg = splits[name]
        ds = CocoDataset(
            cfg["images"], cfg["annotations"],
            remove_non_annotated=bool(cfg.get("remove_non_annotated_imgs")),
            jpeg_quality=cfg.get("jpeg_quality"),
            with_masks=with_masks, with_keypoints=with_keypoints)
        training = name == "train"
        if training:
            bs = batch_size
        elif name == "val" and val_batch_size is not None:
            bs = val_batch_size
        else:
            bs = eval_batch_size
        shard = (shard_index, num_shards) if (training or shard_eval) \
            else (0, 1)
        shard = (shards or {}).get(name, shard)
        out.append(DetectionLoader(
            ds, bs,
            training=training,
            min_sizes=min_sizes, max_size=max_size, buckets=buckets,
            num_workers=num_workers,
            shard_index=shard[0], num_shards=shard[1],
            pixel_dtype=pixel_dtype,
            rows=(rows or {}).get(name, (0, 1))))
    return tuple(out)
