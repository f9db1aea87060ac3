"""HND / GHND distillation entry point.

Counterpart of hnd_ghnd_tpu/runners/mimic_runner.py (reference
src/mimic_runner.py): builds a frozen teacher and a bottleneck student from
the YAML config (each loading its ``ckpt`` when the file exists), distils
over the COCO train loader with the reference's warmup of
min(1000, steps_per_epoch - 1) steps and its MultiStepLR, evaluates the
student's val bbox mAP after each epoch (through the 8-bit bottleneck round
trip only with ``-transform_bottleneck``, C8), keeps the best checkpoint
with its optimizer state, and finally evaluates teacher and student on the
test split, the student from its best checkpoint.  Step scalars are read
one step late (``StepMetrics``), so the loop never waits on the step it just
queued.

    python -m hnd_ghnd_tpu_torch.runners.mimic_runner --config <yaml> \\
        -distill -transform_bottleneck [--device cpu]

``distill`` is the batch-level loop over given batches (dicts of arrays),
whose evals return raw detections; ``distill_coco`` is the runner's loop
over the loaders.  TensorBoard and the profiler (A18) raise.

N ranks (``torchrun --nproc_per_node N -m
hnd_ghnd_tpu_torch.runners.mimic_runner ...``, or ``--dist_url env://``
with RANK, WORLD_SIZE and LOCAL_RANK set) run JAX's global-batch step
(parallel/train_step.py): ``train.batch_size`` is per rank, rank 0 logs and
writes the checkpoints, and the best one is chosen on the merged val mAP,
the same on every rank.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Iterable, List

import torch

from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
from hnd_ghnd_tpu_torch.distill.box import DistillationBox
from hnd_ghnd_tpu_torch.models.factory import get_model, load_weights
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel import multihost
from hnd_ghnd_tpu_torch.parallel.train_step import (MAX_WARMUP, DistillStep,
                                                    make_distill_train_step)
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.runners.common import (StepMetrics,
                                               compute_dtype_from_config,
                                               configure_precision, evaluate,
                                               to_device)
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
from hnd_ghnd_tpu_torch.utils.logging import MetricLogger


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Mimic (distillation) runner")
    common.add_common_args(parser)
    parser.add_argument("-distill", action="store_true",
                        help="run distillation training")
    parser.add_argument("-test_only", action="store_true")
    parser.add_argument("-student_only", action="store_true")
    parser.add_argument("-transform_bottleneck", action="store_true",
                        help="quantize/dequantize the bottleneck at eval")
    parser.add_argument("-skip_teacher_eval", action="store_true")
    parser.add_argument("--profile_dir", default=None,
                        help="not ported (ROADMAP A18): raises")
    parser.add_argument("--tb_dir", default=None,
                        help="not ported (ROADMAP A18): raises")
    return parser


def make_step(teacher: RCNN, student: RCNN, config: Dict[str, Any],
              steps_per_epoch: int) -> DistillStep:
    """The distill step of ``config["train"]`` on one device; the teacher is
    frozen here."""
    train_cfg = config["train"]
    compute_dtype = compute_dtype_from_config(config)
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            f"distillation in {compute_dtype} is not ported (ROADMAP A4): "
            "set tpu.compute_dtype: float32")
    configure_precision(compute_dtype)
    device = next(student.parameters()).device
    if next(teacher.parameters()).device != device:
        raise ValueError("distill: teacher and student must share a device")
    teacher.eval().requires_grad_(False)
    steps_per_epoch = max(int(steps_per_epoch), 1)
    warmup = min(MAX_WARMUP, steps_per_epoch - 1)
    box = DistillationBox(teacher, student, train_cfg["criterion"])
    return make_distill_train_step(box, train_cfg["optimizer"],
                                   train_cfg.get("scheduler"),
                                   steps_per_epoch, warmup)


def train_epoch(step: DistillStep, batches: Iterable, log_freq: int = 0,
                header: str = "") -> Dict[str, Any]:
    """One epoch of ``step`` over ``batches`` (dicts with ``images``, or the
    loader's (batch, targets, host_targets)), the student in train mode.

    Returns {"steps": [(step, loss, {term: value}, ms)], "seconds": the
    epoch's wall time, "loader_s": the time spent waiting on ``batches``};
    ms is the step's time between CUDA events (None on the CPU)."""
    student = step.box.student
    device = next(student.parameters()).device
    cuda = device.type == "cuda"
    student.train()
    metrics = StepMetrics()
    meters = MetricLogger()
    out: Dict[str, Any] = {"steps": []}

    def record(entries):
        for entry in entries:
            out["steps"].append(entry)
            meters.update(loss=entry[1], **entry[2])
            if log_freq and entry[0] % log_freq == 0:
                print(f"{header} [step {entry[0]}] {meters}", flush=True)

    t_start = time.perf_counter()
    batches = common.Timed(batches)
    for item in batches:
        batch = item[0] if isinstance(item, tuple) else item
        images = to_device({"images": batch["images"]}, device)["images"]
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        loss, terms = step(images)
        record(metrics.push(step.step - 1, loss, terms, start))
    record(metrics.drain())
    out["seconds"] = time.perf_counter() - t_start
    out["loader_s"] = batches.seconds
    return out


def distill(teacher: RCNN, student: RCNN, config: Dict[str, Any],
            train_batches: Iterable[Dict[str, Any]],
            val_batches: Iterable[Dict[str, Any]],
            steps_per_epoch: int,
            use_bottleneck_transformer: bool = False) -> Dict[str, List]:
    """Distil ``student`` from ``teacher`` for ``train.num_epochs`` epochs,
    each over ``train_batches`` (dicts with ``images`` [B, H, W, 3], uint8
    or float in [0, 1], on the host or on the models' device).  Both models
    are on one device, the card unless the caller put them on the CPU.
    The student trains what its factory left trainable (everything outside
    ``frozen_modules``).  Each epoch's eval quantizes and dequantizes the
    bottleneck only with ``use_bottleneck_transformer`` (JAX's
    ``-transform_bottleneck``).

    Returns {"steps": [(step, loss, {term: value}, ms)], "evals": [the
    records of ``evaluate`` for each epoch]}; ms is the step's time between
    CUDA events (None on the CPU)."""
    step = make_step(teacher, student, config, steps_per_epoch)
    history: Dict[str, List] = {"steps": [], "evals": []}
    for _ in range(int(config["train"]["num_epochs"])):
        history["steps"] += train_epoch(step, train_batches)["steps"]
        history["evals"].append(evaluate(
            student.eval(), val_batches,
            use_bottleneck_transformer=use_bottleneck_transformer))
        student.train()
    return history


def distill_coco(teacher: RCNN, student: RCNN, config: Dict[str, Any],
                 args: argparse.Namespace, train_loader, val_loader
                 ) -> Dict[str, List]:
    """The runner's distillation (mimic_runner.py:52-206): epochs over
    ``train_loader`` (``set_epoch`` each), the val bbox mAP after each,
    the best checkpoint at ``student_model.ckpt`` when it rises, resuming
    from that file when it exists.

    Returns {"steps": [(step, loss, {term: value}, ms)], "epochs": [{
    "val_map", "saved", "train" (seconds, loader_s: the ranks' mean),
    "eval" (the times of ``coco_evaluate``), "stats"}]}.  At N ranks an
    epoch is ``len(train_loader)`` steps on every rank
    (``common.epoch_batches``)."""
    train_cfg = config["train"]
    ckpt_path = config["student_model"].get("ckpt")
    common.check_ckpt_backend(config)
    step = make_step(teacher, student, config, len(train_loader))
    best = 0.0
    if ckpt_util.check_if_exists(ckpt_path):
        best = common.resume(ckpt_path, student, step)
    log_freq = int(train_cfg.get("log_freq", 1000))
    history: Dict[str, List] = {"steps": [], "epochs": []}
    for epoch in range(int(train_cfg["num_epochs"])):
        train_loader.set_epoch(epoch)
        done = train_epoch(step, common.epoch_batches(train_loader),
                           log_freq, f"Epoch: [{epoch}]")
        history["steps"] += done.pop("steps")
        common.mean_over_ranks(done)
        evaluator, times = common.coco_evaluate(
            student.eval(), val_loader,
            use_bottleneck_transformer=args.transform_bottleneck)
        student.train()
        val_map = float(evaluator.stats["bbox"][0])
        saved = bool(val_map > best and ckpt_path)
        if saved:
            best = val_map
            multihost.save_on_master(common.save_checkpoint, ckpt_path,
                                     student, step, best, config, args)
            print(f"saved best ckpt (val mAP {val_map:.4f})", flush=True)
        history["epochs"].append({
            "val_map": val_map, "saved": saved, "train": done, "eval": times,
            "stats": {k: v.tolist() for k, v in evaluator.stats.items()}})
    return history


def run(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """``main`` after the config is loaded: distil when ``-distill``, reload
    the best checkpoint, then the test evals (mimic_runner.py:225-255).
    As N ranks when a launch or the caller's group says so
    (``common.distributed``): each distils its shard of the global batch,
    evaluates its shard of val and test, and reads the merged stats.

    Returns {"distill": the history of ``distill_coco`` (with -distill),
    "teacher" and "student": {"stats", "eval"} of the test evals}."""
    common.check_unported_args(args)
    with common.distributed(args) as device:
        return _run(config, args, device)


def _run(config: Dict[str, Any], args: argparse.Namespace,
         device: torch.device) -> Dict[str, Any]:
    teacher = get_model(config["teacher_model"], seed=args.seed,
                        device=device)
    student = get_model(config["student_model"], seed=args.seed + 1,
                        device=device)
    out: Dict[str, Any] = {}
    if args.distill:
        min_sizes = common.keypoint_min_sizes(student.kind, True)
        batch_size = int(config["train"]["batch_size"])
        train_loader, val_loader, _ = common.loaders_from_config(
            config, student.kind, batch_size, min_sizes=min_sizes)
        common.log_global_batch(batch_size, train_loader)
        out["distill"] = distill_coco(teacher, student, config, args,
                                      train_loader, val_loader)
        # rank 0's last checkpoint write is done before any rank reads it
        multihost.barrier()
    # the final test eval runs the BEST checkpoint, also right after
    # distillation (reference mimic_runner.py:148-149)
    ckpt_path = config["student_model"].get("ckpt")
    if ckpt_util.check_if_exists(ckpt_path):
        payload = ckpt_util.load_ckpt(ckpt_path)
        load_weights(student, payload["params"], payload.get("state"))
    _, _, test_loader = common.loaders_from_config(config, student.kind, 1)
    if not args.student_only and not args.skip_teacher_eval:
        print("evaluating teacher", flush=True)
        evaluator, times = common.coco_evaluate(teacher.eval(), test_loader)
        out["teacher"] = {"stats": {k: v.tolist() for k, v in
                                    evaluator.stats.items()}, "eval": times}
    print("evaluating student", flush=True)
    evaluator, times = common.coco_evaluate(
        student.eval(), test_loader,
        use_bottleneck_transformer=args.transform_bottleneck)
    out["student"] = {"stats": {k: v.tolist() for k, v in
                                evaluator.stats.items()}, "eval": times}
    return out


def main(args: argparse.Namespace) -> Dict[str, Any]:
    config = overwrite_config(load_config(args.config), args.json)
    return run(config, args)


def cli():
    main(get_argparser().parse_args())


if __name__ == "__main__":
    cli()
