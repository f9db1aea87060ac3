"""Prediction visualizer: one overlay of boxes, masks or keypoints an image.

Counterpart of hnd_ghnd_tpu/runners/visualizer.py (reference
src/visualizer.py): the model of the config (``student_model`` or
``model``, with its ``ckpt``) runs each input image, or each image of an
input directory, through the loader's resize, bucket and pad
(data/transforms.py) and the eval forward (runners/common.eval_forward),
and writes the overlay (utils/visual_util.py) under ``--output`` with the
image's name.  It runs on the card unless ``--device cpu``; PIL and cv2 are
imported by the functions that read and write images.

    python -m hnd_ghnd_tpu_torch.runners.visualizer --config <yaml> \\
        --image <file or directory> [...] --output <dir> [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List

import numpy as np
import torch

from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
from hnd_ghnd_tpu_torch.data import transforms as T
from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.utils.visual_util import render_predictions

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp")


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Prediction visualizer")
    common.add_common_args(parser)
    parser.add_argument("--image", nargs="+", required=True,
                        help="input image path(s) or directories")
    parser.add_argument("--output", default="./visualized",
                        help="output directory")
    parser.add_argument("--score_threshold", type=float, default=0.7)
    parser.add_argument("-transform_bottleneck", action="store_true")
    return parser


def predict(model: RCNN, image: np.ndarray, tpu_cfg: Dict[str, Any],
            use_bottleneck_transformer: bool) -> Dict[str, np.ndarray]:
    """One RGB uint8 image [H, W, 3] -> its predictions in its own
    coordinates (finalize_predictions)."""
    min_size = int(tpu_cfg.get("min_sizes", [800])[-1])
    max_size = int(tpu_cfg.get("max_size", 1333))
    buckets = tuple(tuple(b) for b in
                    tpu_cfg.get("buckets", T.DEFAULT_BUCKETS))
    oh, ow = image.shape[:2]
    resized, _, _ = T.resize(image, None, min_size, max_size)
    bucket = T.pick_bucket(resized.shape[0], resized.shape[1], buckets)
    batch = {
        "images": T.pad_to(resized, bucket)[None].astype(np.float32) / 255.0,
        "image_sizes": np.asarray([[resized.shape[0], resized.shape[1]]],
                                  np.int32),
        "original_sizes": np.asarray([[oh, ow]], np.int32),
    }
    device = next(model.parameters()).device
    dets = common.eval_forward(model, common.to_device(batch, device),
                               use_bottleneck_transformer)
    dets = {k: v.cpu().numpy() for k, v in dets.items()}
    return finalize_predictions(dets, 0, (oh, ow),
                                (resized.shape[0], resized.shape[1]))


def image_paths(inputs: List[str]) -> List[str]:
    """Files as given; a directory's image files in name order (the
    reference's get_file_path_list)."""
    paths = []
    for p in inputs:
        if os.path.isdir(p):
            paths.extend(sorted(
                os.path.join(p, f) for f in os.listdir(p)
                if f.lower().endswith(IMAGE_SUFFIXES)))
        else:
            paths.append(p)
    return paths


def run(config: Dict[str, Any], args: argparse.Namespace) -> List[str]:
    """``main`` after the config is loaded.  Returns the overlays'
    paths."""
    import cv2
    from PIL import Image

    common.configure_precision(torch.float32)
    model_cfg = config.get("student_model", config.get("model"))
    model = get_model(model_cfg, seed=args.seed, device=args.device).eval()
    os.makedirs(args.output, exist_ok=True)
    written = []
    for path in image_paths(args.image):
        img = np.asarray(Image.open(path).convert("RGB"))
        pred = predict(model, img, config.get("tpu", {}) or {},
                       args.transform_bottleneck)
        out = render_predictions(img, pred, args.score_threshold)
        out_path = os.path.join(args.output, os.path.basename(path))
        cv2.imwrite(out_path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        n = int((pred["scores"] >= args.score_threshold).sum())
        print(f"{path}: {n} detections >= {args.score_threshold} "
              f"-> {out_path}")
        written.append(out_path)
    return written


def main(args: argparse.Namespace) -> List[str]:
    config = overwrite_config(load_config(args.config), args.json)
    return run(config, args)


def cli():
    main(get_argparser().parse_args())


if __name__ == "__main__":
    cli()
