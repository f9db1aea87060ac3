"""Offline cost analysis: parameters, payload sizes, split latency and mAP.

Counterpart of hnd_ghnd_tpu/runners/cost_analyzer.py (reference
src/cost_analyzer.py), with its flags and its printed lines:

  * ``-model_params`` (with ``--modules``): parameter counts of the model,
    its parts and the split's head and tail, counted over the JAX-layout
    params tree (models/convert.jax_params_from_state_dict), the tree the
    JAX package counts;
  * ``--data_size`` (with ``-resized``): the dataset's JPEG payloads and a
    communication-delay table over 0.5-10 Mbps, delay = KB * 8 / (Mbps *
    1000) seconds;
  * ``--bottleneck_size``: the bottleneck tensor's payload in float32,
    float16 and 8-bit (codec/datalogger.py);
  * ``--split_model`` (with ``--quantization 8|16|<=0``, ``-skip_tail`` and
    ``--max_images``): the split deployment (split/deploy.py) image by
    image, head -> bytes -> tail, its latencies, wire sizes and COCO mAP;
    with ``--int8_tail`` (an 8-bit wire), the int8 server tail
    (split/int8.py) calibrated on the first ``--calib_images`` images also
    serves every wire, with its latency and its mAP delta against the
    float tail.

The analysis selectors take a split name; a bare flag means ``test``.  The
models run on the card unless ``--device cpu``.

    python -m hnd_ghnd_tpu_torch.runners.cost_analyzer --config <yaml> \\
        -model_params --data_size --bottleneck_size --split_model \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hnd_ghnd_tpu_torch.codec.datalogger import (DataLogger,
                                                 binary_object_size_kb)
from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
from hnd_ghnd_tpu_torch.evals.coco_eval import CocoEvaluator
from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
from hnd_ghnd_tpu_torch.models.factory import get_iou_types, get_model
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.split import int8 as qi
from hnd_ghnd_tpu_torch.split.deploy import (SplitRCNN, _split_head_params,
                                             _split_tail_params)
from hnd_ghnd_tpu_torch.utils.params import count_tree_params, get_by_path

DATA_RATES_MBPS = [0.5 * i for i in range(1, 21)]  # 0.5 .. 10 Mbps


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Cost analyzer")
    common.add_common_args(parser)
    # the reference spells this one single-dash (src/cost_analyzer.py:26)
    parser.add_argument("-model_params", "--model_params",
                        action="store_true")
    parser.add_argument("--modules", nargs="+", default=None,
                        help="dotted module paths to count parameters for")
    parser.add_argument("--data_size", nargs="?", const="test", default=None,
                        help="dataset split name to analyze data size")
    parser.add_argument("--bottleneck_size", nargs="?", const="test",
                        default=None,
                        help="dataset split name to analyze bottleneck size")
    parser.add_argument("--split_model", nargs="?", const="test",
                        default=None,
                        help="dataset split name to measure split inference")
    parser.add_argument("--quantization", "--quantize", type=int, default=8,
                        help="wire bits for --split_model / --bottleneck_size"
                             " (8 or 16; <=0 disables)")
    parser.add_argument("-skip_tail", action="store_true",
                        help="skip measuring inference time for tail model")
    parser.add_argument("--int8_tail", action="store_true",
                        help="also serve with the int8 server tail "
                             "(8-bit wire)")
    parser.add_argument("--calib_images", type=int, default=8,
                        help="calibration images for --int8_tail")
    parser.add_argument("--max_images", type=int, default=None,
                        help="cap analyzed test images")
    parser.add_argument("-resized", action="store_true",
                        help="apply the detector resize rule before the "
                             "--data_size payload study")
    return parser


def summarize_data_sizes(sizes_kb: List[float], label: str) -> None:
    arr = np.asarray([s for s in sizes_kb if s > 0])
    if not len(arr):
        print(f"{label}: no data")
        return
    print(f"{label}: mean {arr.mean():.2f} KB  std {arr.std():.2f}  "
          f"min {arr.min():.2f}  max {arr.max():.2f}")
    print("  comm delay over data rate [Mbps -> sec/image]:")
    row = "  ".join(f"{r:.1f}:{arr.mean() * 8 / (r * 1000):.3f}"
                    for r in DATA_RATES_MBPS)
    print("  " + row)


def analyze_model_params(model: RCNN,
                         module_paths: Optional[List[str]] = None
                         ) -> Dict[str, int]:
    """The parameter table over the JAX-layout params tree; returns its
    counts by name."""
    sd = model.state_dict()
    params, _ = jax_params_from_state_dict(sd)
    counts = {"total": count_tree_params(params)}
    print("parameter counts:")
    for module in ("backbone", "rpn", "roi_heads"):
        counts[module] = count_tree_params(params[module])
        print(f"  {module}: {counts[module]:,}")
    print(f"  total: {counts['total']:,}")
    if module_paths:
        # the reference's --modules table (src/cost_analyzer.py:44-53)
        print("[Specified module(s)]")
        subtotal = 0
        for path in module_paths:
            n = counts[path] = count_tree_params(get_by_path(params, path))
            subtotal += n
            print(f"  {path}: {n:,}")
        print(f"  Total # parameters: {subtotal:,}")
    if model.backbone.body.injected:
        n_head = counts["head"] = count_tree_params(
            jax_params_from_state_dict(_split_head_params(sd))[0])
        n_tail = counts["tail"] = count_tree_params(
            jax_params_from_state_dict(_split_tail_params(sd))[0])
        print(f"  split head (edge): {n_head:,} "
              f"({100 * n_head / counts['total']:.2f}%)")
        print(f"  split tail (server): {n_tail:,}")
    return counts


def summarize_tensor_shape(channels, heights, widths) -> None:
    """mean ± std per tensor dim (reference summarize_tensor_shape,
    src/cost_analyzer.py:71-76)."""
    channels = np.asarray(channels, np.float64)
    heights = np.asarray(heights, np.float64)
    widths = np.asarray(widths, np.float64)
    print("Tensor shape")
    print(f"Channel:\t{channels.mean():.4f} ± {channels.std():.4f}")
    print(f"Height:\t{heights.mean():.4f} ± {heights.std():.4f}")
    print(f"Width:\t{widths.mean():.4f} ± {widths.std():.4f}")


def resize_for_rcnns(img, min_size: int = 800, max_size: int = 1333):
    """The detector's resize rule on a PIL image (reference
    resize_for_rcnns, src/cost_analyzer.py:79-86)."""
    from PIL import Image
    w, h = img.size
    img_min, img_max = float(min(w, h)), float(max(w, h))
    sf = min_size / img_min
    if img_max * sf > max_size:
        sf = max_size / img_max
    return img.resize((int(w * sf), int(h * sf)), resample=Image.BILINEAR)


def analyze_data_size(loader, max_images: Optional[int],
                      resized: bool = False) -> None:
    """The dataset's payloads (reference analyze_data_size,
    src/cost_analyzer.py:89-137): each image re-encoded as JPEG-95, and at
    the dataset's ``jpeg_quality`` when it sets one, the min and max tensor
    shapes, mean ± std per dimension, and the file and decoded sizes."""
    import io

    from PIL import Image

    ds = loader.dataset
    org_sizes, comp_sizes, file_sizes, decoded_sizes = [], [], [], []
    chans, heights, widths = [], [], []
    min_shape = max_shape = None
    min_px = max_px = None
    for n, image_id in enumerate(ds.ids):
        if max_images and n >= max_images:
            break
        info = ds.images[image_id]
        path = os.path.join(ds.img_dir, info["file_name"])
        file_sizes.append(os.path.getsize(path) / 1024.0)
        img = Image.open(path).convert("RGB")
        if resized:
            img = resize_for_rcnns(img)
        w, h = img.size
        chans.append(3)
        heights.append(h)
        widths.append(w)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=95)
        org_sizes.append(buf.tell() / 1024.0)
        if ds.jpeg_quality is not None:
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=ds.jpeg_quality)
            comp_sizes.append(buf.tell() / 1024.0)
        decoded_sizes.append(binary_object_size_kb(
            np.asarray(img, dtype=np.uint8)))
        px = 3 * h * w
        if min_px is None or px < min_px:
            min_px, min_shape = px, [3, h, w]
        if max_px is None or px > max_px:
            max_px, max_shape = px, [3, h, w]
    summarize_data_sizes(org_sizes, "Original")
    print(f"Min tensor shape: {min_shape}")
    print(f"Max tensor shape: {max_shape}")
    if comp_sizes:
        summarize_data_sizes(comp_sizes,
                             f"JPEG quality = {ds.jpeg_quality}")
    summarize_tensor_shape(chans, heights, widths)
    summarize_data_sizes(file_sizes, "on-disk file payload")
    summarize_data_sizes(decoded_sizes, "decoded image payload")


def _live_images(loader, max_images: Optional[int]):
    """(batch, index, host target) of each real image, ``max_images`` at
    most."""
    seen = 0
    for batch, _, host in loader:
        for i, tgt in enumerate(host):
            if tgt.get("is_padding"):
                continue
            if max_images and seen >= max_images:
                return
            yield batch, i, tgt
            seen += 1


def analyze_bottleneck_size(model: RCNN, loader, quant_bits: int,
                            max_images: Optional[int]) -> DataLogger:
    """The bottleneck's payloads: the head without its quantizer, and the
    logger derives the float16 and quantized sizes from the float32
    tensor (the reference's DataLogger, transformer.py:76-91)."""
    head_call, _, _ = SplitRCNN(model, None).build()
    logger = DataLogger(num_bits=quant_bits if quant_bits > 0 else 8)
    for batch, i, _ in _live_images(loader, max_images):
        z, _, _, _ = head_call(batch["images"][i:i + 1])
        logger(np.asarray(z, dtype=np.float32))
    fp32, fp16, q8, shapes = logger.get_data()
    summarize_data_sizes(fp32, "bottleneck fp32")
    summarize_data_sizes(fp16, "bottleneck fp16")
    summarize_data_sizes(q8, f"bottleneck int{logger.num_bits4quant}")
    if shapes:
        print(f"bottleneck tensor shape (C,H,W): {shapes[0]}")
    return logger


def _int8_tail(model: RCNN, loader, calib_images: int):
    """The int8 server tail (split/int8.py) calibrated on the first
    ``calib_images`` real images of ``loader``, as its tail_call."""
    calib = [batch["images"][i:i + 1]
             for batch, i, _ in _live_images(loader, calib_images)]
    scales = qi.calibrate_from_images(model, calib)
    print(f"int8 tail calibrated on {len(calib)} images "
          f"({len(scales)} activation sites)")
    return qi.Int8SplitTail(model, scales).build()


def analyze_split_model_inference(model: RCNN, loader, quant_bits: int,
                                  max_images: Optional[int],
                                  ext_threshold: Optional[float],
                                  skip_tail: bool = False,
                                  int8_tail: bool = False,
                                  calib_images: int = 8) -> Dict[str, Any]:
    """Each image through run_edge -> bytes -> run_server, fed to a
    CocoEvaluator; with ``int8_tail`` each wire also goes through the int8
    tail, fed to a second one.  The latency lines are the mean ± std of the
    host's wall times without the first sample, which carries the first
    calls at a new shape (the kernels' build, cuDNN's first calls), as
    JAX's leaves out its compile.  Returns {"head_s", "tail_s", "wire_kb",
    "evaluator" (None under ``skip_tail``), and under ``int8_tail``
    "int8_tail_s", "int8_evaluator", "int8_map_delta" (by IoU type)}."""
    common.configure_precision(torch.float32)
    split = SplitRCNN(model, quant_bits if quant_bits > 0 else None)
    head_call, tail_call, _ = split.build()
    evaluator = CocoEvaluator(loader.dataset, get_iou_types(model))
    int8_call = int8_evaluator = None
    if int8_tail:
        if quant_bits != 8:
            raise ValueError("--int8_tail requires an 8-bit wire "
                             f"(--quantization 8), not {quant_bits}")
        int8_call = _int8_tail(model, loader, calib_images)
        int8_evaluator = CocoEvaluator(loader.dataset, get_iou_types(model))
    head_times, tail_times, int8_times, wire_kb = [], [], [], []
    for batch, i, tgt in _live_images(loader, max_images):
        bucket = tuple(batch["images"].shape[1:3])
        t0 = time.perf_counter()
        wire = split.run_edge(head_call, batch["images"][i:i + 1],
                              batch["image_sizes"][i:i + 1],
                              batch["original_sizes"][i:i + 1],
                              ext_threshold=ext_threshold)
        head_times.append(time.perf_counter() - t0)
        if wire is None:  # the ext filter stopped it: an empty prediction
            for ev in (evaluator, int8_evaluator):
                if ev is not None:
                    ev.update({tgt["image_id"]: {
                        "boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                        "labels": np.zeros(0, np.int64)}})
            continue
        wire_kb.append(len(wire) / 1024.0)
        if skip_tail:
            # the reference's -skip_tail (src/cost_analyzer.py:104-113):
            # head latency and wire payload only
            continue
        valid = (int(batch["image_sizes"][i][0]),
                 int(batch["image_sizes"][i][1]))
        t0 = time.perf_counter()
        dets = split.run_server(tail_call, wire, bucket)
        tail_times.append(time.perf_counter() - t0)
        evaluator.update({tgt["image_id"]: finalize_predictions(
            dets, 0, tuple(tgt["original_size"]), valid)})
        if int8_call is not None:
            t0 = time.perf_counter()
            dets8 = split.run_server(int8_call, wire, bucket)
            int8_times.append(time.perf_counter() - t0)
            int8_evaluator.update({tgt["image_id"]: finalize_predictions(
                dets8, 0, tuple(tgt["original_size"]), valid)})
    for name, times in (("head", head_times), ("tail", tail_times),
                        ("int8 tail", int8_times)):
        if times:
            arr = np.asarray(times[1:] or times)
            print(f"{name} latency: {arr.mean() * 1000:.2f} ± "
                  f"{arr.std() * 1000:.2f} ms")
    summarize_data_sizes(wire_kb, "wire payload")
    out = {"head_s": head_times, "tail_s": tail_times, "wire_kb": wire_kb,
           "evaluator": None}
    if skip_tail:
        return out
    evaluator.accumulate()
    stats = evaluator.summarize()
    out["evaluator"] = evaluator
    if int8_evaluator is not None:
        print("int8 tail evaluation:")
        int8_evaluator.accumulate()
        stats8 = int8_evaluator.summarize()
        out.update(int8_tail_s=int8_times, int8_evaluator=int8_evaluator,
                   int8_map_delta={})
        for t in stats:
            delta = float(stats8[t][0]) - float(stats[t][0])
            out["int8_map_delta"][t] = delta
            print(f"int8 tail mAP delta [{t}]: {delta:+.4f} "
                  f"(fp {float(stats[t][0]):.4f} -> "
                  f"int8 {float(stats8[t][0]):.4f})")
    return out


def run(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """``main`` after the config is loaded.  Returns each analysis' result
    by its flag's name."""
    model_cfg = config.get("student_model", config.get("model"))
    model = get_model(model_cfg, seed=args.seed, device=args.device).eval()
    loaders = dict(zip(("train", "val", "test"),
                       common.loaders_from_config(config, model.kind, 1)))

    def loader_for(split_name):
        if not isinstance(split_name, str):  # a boolean flag
            split_name = "test"
        if split_name not in loaders:
            raise SystemExit(f"unknown dataset split `{split_name}` "
                             f"(have: {sorted(loaders)})")
        return loaders[split_name]

    bottleneck = model.backbone.body.injected
    ext_threshold = (model_cfg["backbone"].get("ext_config") or {}).get(
        "threshold") if bottleneck and \
        model.backbone.body.layer1.encoder.ext_classifier is not None \
        else None
    out: Dict[str, Any] = {}
    if args.model_params:
        out["model_params"] = analyze_model_params(
            model, getattr(args, "modules", None))
    if args.data_size:
        analyze_data_size(loader_for(args.data_size), args.max_images,
                          resized=getattr(args, "resized", False))
    if args.bottleneck_size:
        if not bottleneck:
            raise ValueError("--bottleneck_size needs a bottleneck model")
        out["bottleneck_size"] = analyze_bottleneck_size(
            model, loader_for(args.bottleneck_size), args.quantization,
            args.max_images)
    if args.split_model:
        if not bottleneck:
            raise ValueError("--split_model needs a bottleneck model")
        out["split_model"] = analyze_split_model_inference(
            model, loader_for(args.split_model), args.quantization,
            args.max_images, ext_threshold,
            skip_tail=getattr(args, "skip_tail", False),
            int8_tail=getattr(args, "int8_tail", False),
            calib_images=getattr(args, "calib_images", 8))
    return out


def main(args: argparse.Namespace) -> Dict[str, Any]:
    config = overwrite_config(load_config(args.config), args.json)
    return run(config, args)


def cli():
    main(get_argparser().parse_args())


if __name__ == "__main__":
    cli()
