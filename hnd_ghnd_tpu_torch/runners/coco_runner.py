"""Supervised detector training entry point (produces the ``org`` teachers).

Counterpart of hnd_ghnd_tpu/runners/coco_runner.py (reference
src/coco_runner.py): the loss is the sum of the R-CNN loss dict; the
schedule is the config's with the reference's warmup of
min(1000, steps_per_epoch - 1) steps; the trunk's conv1, bn1 and layer1 are
frozen under ``backbone.params.freeze_layers`` (models/factory.py); a
non-finite loss stops training (coco_runner.py:95-103); after each epoch
the model is evaluated through the serving path in float32, then put back
in train mode, and the best-mAP checkpoint is kept with its optimizer
state.  The final test eval runs the last model, as the reference's does;
without ``-train`` it runs the model's ``ckpt``.  Step scalars are read one
step late (``StepMetrics``), so the check of a loss fires one step after
it was queued.  The compute dtype is ``tpu.compute_dtype`` (bfloat16
unless the config says float32).

    python -m hnd_ghnd_tpu_torch.runners.coco_runner --config <yaml> \\
        -train [--device cpu]

``train`` is the batch-level loop over given (batch, targets) pairs, whose
evals return raw detections; ``train_coco`` is the runner's loop over the
loaders.  N ranks (``torchrun``, or ``--dist_url env://``) run JAX's
``shard_map`` step (parallel/train_step.py: each rank's loss and BN
statistics, averaged gradients); rank 0 logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict, Iterable, List, Tuple

import torch

from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
from hnd_ghnd_tpu_torch.models.factory import get_model, load_weights
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel import multihost
from hnd_ghnd_tpu_torch.parallel.train_step import (MAX_WARMUP, DetectionStep,
                                                    make_detection_train_step)
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.runners.common import (StepMetrics,
                                               compute_dtype_from_config,
                                               configure_precision, evaluate,
                                               to_device)
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util

Batch = Dict[str, Any]


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="COCO detector trainer")
    common.add_common_args(parser)
    parser.add_argument("-train", action="store_true")
    parser.add_argument("-test_only", action="store_true")
    parser.add_argument("--tb_dir", default=None,
                        help="not ported (ROADMAP A18): raises")
    return parser


def make_step(model: RCNN, config: Dict[str, Any], steps_per_epoch: int,
              seed: int = 0) -> DetectionStep:
    """The detection step of ``config["train"]`` in ``tpu.compute_dtype``;
    ``seed`` seeds the samplers."""
    train_cfg = config["train"]
    compute_dtype = compute_dtype_from_config(config)
    configure_precision(compute_dtype)
    steps_per_epoch = max(int(steps_per_epoch), 1)
    warmup = min(MAX_WARMUP, steps_per_epoch - 1)
    return make_detection_train_step(
        model, train_cfg["optimizer"], train_cfg.get("scheduler"),
        steps_per_epoch, warmup, compute_dtype, seed=seed)


def train_epoch(step: DetectionStep, batches: Iterable) -> Dict[str, Any]:
    """One epoch of ``step`` over ``batches``: (batch, targets) pairs, or the
    loader's (batch, targets, host_targets).  Raises on a non-finite loss.

    Returns {"steps": [(step, loss, {term: value}, ms)], "seconds",
    "loader_s"} as mimic_runner.train_epoch."""
    model = step.model
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    model.train()
    metrics = StepMetrics()
    out: Dict[str, Any] = {"steps": []}

    def record(entries):
        for entry in entries:
            if not math.isfinite(entry[1]):
                bad = [k for k, v in entry[2].items() if not math.isfinite(v)]
                raise FloatingPointError(
                    f"loss is {entry[1]} at step {entry[0]}: non-finite "
                    f"{', '.join(bad) or 'sum'} ({entry[2]}), stopping "
                    "training")
            out["steps"].append(entry)

    t_start = time.perf_counter()
    batches = common.Timed(batches)
    for item in batches:
        batch, targets = item[0], item[1]
        batch, targets = to_device(batch, device), to_device(targets, device)
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        loss, terms = step(batch, targets)
        record(metrics.push(step.step - 1, loss, terms, start))
    record(metrics.drain())
    out["seconds"] = time.perf_counter() - t_start
    out["loader_s"] = batches.seconds
    return out


def train(model: RCNN, config: Dict[str, Any],
          train_batches: Iterable[Tuple[Batch, Batch]],
          val_batches: Iterable[Batch], steps_per_epoch: int,
          seed: int = 0) -> Dict[str, List]:
    """Train ``model`` for ``train.num_epochs`` epochs, each over
    ``train_batches``: (batch, targets) pairs, the batch with images
    [B, H, W, 3] (uint8, or float in [0, 1]), image_sizes and
    original_sizes [B, 2], the targets with boxes [B, G, 4], labels [B, G]
    and boxes_valid [B, G] padded to a fixed G, and for a Mask or Keypoint
    R-CNN masks_crop [B, G, 114, 114] or keypoints [B, G, K, 3].  The
    model stays on its device (the card unless the caller put it on the
    CPU) and trains the parameters that ``requires_grad``; ``seed`` seeds
    the samplers.

    Returns {"steps": [(step, loss, {term: value}, ms)], "evals": [the
    records of ``evaluate`` for each epoch]}; ms is the step's time between
    CUDA events (None on the CPU)."""
    step = make_step(model, config, steps_per_epoch, seed)
    history: Dict[str, List] = {"steps": [], "evals": []}
    for _ in range(int(config["train"]["num_epochs"])):
        history["steps"] += train_epoch(step, train_batches)["steps"]
        history["evals"].append(evaluate(model.eval(), val_batches))
    model.train()
    return history


def train_coco(model: RCNN, config: Dict[str, Any], args: argparse.Namespace,
               train_loader, val_loader) -> Dict[str, List]:
    """The runner's training (coco_runner.py:41-166): epochs over
    ``train_loader`` (``set_epoch`` each), the val bbox mAP after each, the
    best checkpoint at ``model.ckpt`` when it rises, resuming from that file
    when it exists.  Returns {"steps", "epochs"} as
    mimic_runner.distill_coco."""
    ckpt_path = config["model"].get("ckpt")
    common.check_ckpt_backend(config)
    step = make_step(model, config, len(train_loader), args.seed)
    best = 0.0
    if ckpt_util.check_if_exists(ckpt_path):
        best = common.resume(ckpt_path, model, step)
    history: Dict[str, List] = {"steps": [], "epochs": []}
    for epoch in range(int(config["train"]["num_epochs"])):
        train_loader.set_epoch(epoch)
        done = train_epoch(step, common.epoch_batches(train_loader))
        history["steps"] += done.pop("steps")
        common.mean_over_ranks(done)
        evaluator, times = common.coco_evaluate(model.eval(), val_loader)
        model.train()
        val_map = float(evaluator.stats["bbox"][0])
        saved = bool(val_map > best and ckpt_path)
        if saved:
            best = val_map
            multihost.save_on_master(common.save_checkpoint, ckpt_path,
                                     model, step, best, config, args)
            print(f"saved best ckpt (val mAP {val_map:.4f})", flush=True)
        history["epochs"].append({
            "val_map": val_map, "saved": saved, "train": done, "eval": times,
            "stats": {k: v.tolist() for k, v in evaluator.stats.items()}})
    return history


def run(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """``main`` after the config is loaded, as one process or N ranks
    (``common.distributed``; each trains and evaluates its shard).
    Returns {"train": the history of ``train_coco`` (with -train), "test":
    {"stats", "eval"}}."""
    common.check_unported_args(args)
    with common.distributed(args) as device:
        return _run(config, args, device)


def _run(config: Dict[str, Any], args: argparse.Namespace,
         device: torch.device) -> Dict[str, Any]:
    model = get_model(config["model"], seed=args.seed, device=device)
    out: Dict[str, Any] = {}
    if args.train:
        min_sizes = common.keypoint_min_sizes(model.kind, True)
        batch_size = int(config["train"]["batch_size"])
        train_loader, val_loader, _ = common.loaders_from_config(
            config, model.kind, batch_size, min_sizes=min_sizes)
        common.log_global_batch(batch_size, train_loader)
        out["train"] = train_coco(model, config, args, train_loader,
                                  val_loader)
    elif ckpt_util.check_if_exists(config["model"].get("ckpt")):
        payload = ckpt_util.load_ckpt(config["model"]["ckpt"])
        load_weights(model, payload["params"], payload.get("state"))
    _, _, test_loader = common.loaders_from_config(config, model.kind, 1)
    evaluator, times = common.coco_evaluate(model.eval(), test_loader)
    out["test"] = {"stats": {k: v.tolist() for k, v in
                             evaluator.stats.items()}, "eval": times}
    return out


def main(args: argparse.Namespace) -> Dict[str, Any]:
    config = overwrite_config(load_config(args.config), args.json)
    return run(config, args)


def cli():
    main(get_argparser().parse_args())


if __name__ == "__main__":
    cli()
