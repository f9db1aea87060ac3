"""Host data-pipeline throughput: can the input path feed the card?

Counterpart of tools/pipeline_bench.py, over the port's loader.  Host
only: it writes a synthetic COCO-scale JPEG set (420-640 px a side,
quality 95, up to 6 boxes) with ``data/fixtures.make_coco_fixture``, then
streams the port's ``DetectionLoader`` over it at the training batch size
and reports img/s per worker count, and a stage split on one image: the
decode (libjpeg through ``data/native_prep.py`` where the port's library
has it, else PIL) and the fused resize/pad into the batch slot
(``native_prep.prep_into``, where the library builds).

The rate of one worker is a per-core rate: the cores a step rate needs
are step_rate / per_core_rate (decode and prep release the GIL, so worker
threads scale across cores).  ``HND_TPU_NATIVE_PREP=0`` measures the pure
path (PIL decode, cv2 resize).

    python -m hnd_ghnd_tpu_torch.tools.pipeline_bench [--images 96]
        [--batch 24] [--workers 1,2,4] [--epochs 2]
        [--pixel_dtype float32|uint8]

Prints one JSON line per measurement; ``main`` returns the last.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np


def make_cocoscale_jpegs(root: str, n: int, seed: int = 0):
    """COCO-val-like JPEGs (JAX's ``_make_cocoscale_jpegs``)."""
    from hnd_ghnd_tpu_torch.data.fixtures import make_coco_fixture
    return make_coco_fixture(root, num_images=n, seed=seed,
                             size_range=((420, 640), (420, 640)),
                             max_objects=6, num_classes=3)


def _emit(record: Dict[str, Any]) -> Dict[str, Any]:
    print(json.dumps(record), flush=True)
    return record


def stage_split(img_dir: str, min_size: int, reps: int = 50) -> None:
    """decode_ms_per_img and prep_ms_per_img on the first image."""
    from hnd_ghnd_tpu_torch.data import native_prep
    from hnd_ghnd_tpu_torch.data import transforms as T
    with open(os.path.join(img_dir, sorted(os.listdir(img_dir))[0]),
              "rb") as f:
        raw = f.read()
    if native_prep.has_jpeg():
        decoder = "libjpeg"

        def decode():
            return native_prep.decode_jpeg(raw)
    else:
        from PIL import Image
        decoder = "PIL"

        def decode():
            return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"),
                              dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(reps):
        arr = decode()
    t_dec = (time.perf_counter() - t0) / reps
    _emit({"stage": "decode_ms_per_img", "value": round(t_dec * 1000, 2),
           "decoder": decoder})
    if not native_prep.available():
        return
    oh, ow = arr.shape[:2]
    nh, nw, _ = T.resize_geometry(oh, ow, min_size, 1333)
    bh, bw = T.pick_bucket(nh, nw, T.DEFAULT_BUCKETS)
    dst = np.empty((bh, bw, 3), np.float32)
    t0 = time.perf_counter()
    for _ in range(reps):
        native_prep.prep_into(arr, nh, nw, False, dst)
    t_prep = (time.perf_counter() - t0) / reps
    _emit({"stage": "prep_ms_per_img", "value": round(t_prep * 1000, 2),
           "out_hw": [nh, nw]})


def get_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="host pipeline throughput")
    ap.add_argument("--images", type=int, default=96)
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--workers", default="1,2,4")
    ap.add_argument("--epochs", type=int, default=2,
                    help="timed epochs (one more first warms the page "
                         "cache)")
    ap.add_argument("--min_size", type=int, default=800)
    ap.add_argument("--pixel_dtype", choices=("float32", "uint8"),
                    default="float32",
                    help="uint8 = the u8-wire loader mode")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = get_argparser().parse_args(argv)
    from hnd_ghnd_tpu_torch.data import native_prep
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset
    from hnd_ghnd_tpu_torch.data.loader import DetectionLoader

    _emit({"native_prep": native_prep.available(),
           "native_jpeg": native_prep.has_jpeg(),
           "cpu_count": os.cpu_count()})
    with tempfile.TemporaryDirectory() as root:
        img_dir, ann_file = make_cocoscale_jpegs(root, args.images)
        ds = CocoDataset(img_dir, ann_file, remove_non_annotated=True)
        stage_split(img_dir, args.min_size)
        results = {}
        for workers in (int(v) for v in args.workers.split(",")):
            loader = DetectionLoader(
                ds, args.batch, training=True, min_sizes=(args.min_size,),
                num_workers=workers, seed=1, pixel_dtype=args.pixel_dtype)
            for _ in loader:    # warm epoch: page cache
                pass
            t0 = time.perf_counter()
            total = 0
            for ep in range(args.epochs):
                loader.set_epoch(ep + 1)
                for _, _, host in loader:
                    # real images: a remainder's padding repeats are not
                    # throughput
                    total += sum(not t["is_padding"] for t in host)
            dt = time.perf_counter() - t0
            results[workers] = total / dt
            _emit({"workers": workers, "img_s": round(results[workers], 1),
                   "imgs": total, "wall_s": round(dt, 1)})
        best = max(results.values())
        metric = "host_pipeline_img_s_per_core"
        if args.pixel_dtype != "float32":
            metric += f"_{args.pixel_dtype}"
        return _emit({"metric": metric, "value": round(best, 1),
                      "cores_for_98_img_s": round(98.0 / best, 1)})


if __name__ == "__main__":
    main()
