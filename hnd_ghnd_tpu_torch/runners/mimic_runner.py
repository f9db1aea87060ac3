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
queued.  The step runs in ``tpu.compute_dtype`` (bfloat16 unless the config
says float32, as in the JAX package); with ``org_loss_factor != 0`` it adds
the student's detection losses on the loader's targets, its samplers
seeded from ``--seed``.

    python -m hnd_ghnd_tpu_torch.runners.mimic_runner --config <yaml> \\
        -distill -transform_bottleneck [--device cpu] \\
        [--json '{"tpu": {"compute_dtype": "bfloat16"}}']

``distill`` is the batch-level loop over given batches (dicts of arrays),
whose evals return raw detections; ``distill_coco`` is the runner's loop
over the loaders.  ``--tb_dir`` writes ``train/loss`` and
``train/{term}`` every ``log_freq`` steps and ``val/map`` each epoch (rank
0; utils/tensorboard.py), ``--profile_dir`` a ``torch.profiler`` trace of
loop iterations 3-6 (utils/profiling.StepTrace), as JAX's runner does.

N ranks (``torchrun --nproc_per_node N -m
hnd_ghnd_tpu_torch.runners.mimic_runner ...``, or ``--dist_url env://``
with RANK, WORLD_SIZE and LOCAL_RANK set) run JAX's global-batch step, or
with the org term its per-rank average (parallel/train_step.py):
``train.batch_size`` is per rank, rank 0 logs and
writes the checkpoints, and the best one is chosen on the merged val mAP,
the same on every rank.  With no launch on a host of several cards the
runner runs JAX's one-process mesh as local workers, one a card
(parallel/mesh.py): ``train.batch_size`` is then the global batch, split
by rows over the workers, and ``--world_size`` caps the cards.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

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
from hnd_ghnd_tpu_torch.utils.profiling import StepTrace
from hnd_ghnd_tpu_torch.utils.tensorboard import SummaryWriter


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
                        help="write a torch.profiler trace of loop "
                             "iterations 3-6 here")
    parser.add_argument("--tb_dir", default=None,
                        help="write TensorBoard scalars here (rank 0)")
    return parser


def make_step(teacher: RCNN, student: RCNN, config: Dict[str, Any],
              steps_per_epoch: int, seed: int = 0) -> DistillStep:
    """The distill step of ``config["train"]`` on one device in
    ``tpu.compute_dtype``; the teacher is frozen here.  ``seed`` seeds the
    samplers of the org term (``org_loss_factor != 0``)."""
    train_cfg = config["train"]
    compute_dtype = compute_dtype_from_config(config)
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
                                   steps_per_epoch, warmup, compute_dtype,
                                   seed=seed)


def train_epoch(step: DistillStep, batches: Iterable, log_freq: int = 0,
                header: str = "", tb: Optional[SummaryWriter] = None,
                trace: Optional[StepTrace] = None) -> Dict[str, Any]:
    """One epoch of ``step`` over ``batches`` (dicts with ``images``, or the
    loader's (batch, targets, host_targets)), the student in train mode.
    With the org term the batches carry their targets ((batch, targets) or
    the loader's triple), and the batch and targets go to the device as
    ``coco_runner.train_epoch`` moves them.  With ``log_freq``, a
    ``MetricLogger`` line every ``log_freq`` batches (``log_every``, JAX's
    mimic_runner.py:148) and the scalars to ``tb`` every ``log_freq``
    steps, both from the lag-1 reads; ``trace`` brackets each iteration.

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
            if tb is not None:
                common.log_train_scalars(tb, entry, log_freq)

    t_start = time.perf_counter()
    batches = common.Timed(batches)
    org = step.box.use_org_loss
    items = meters.log_every(batches, log_freq, header) if log_freq \
        else batches
    for item in items:
        if trace is not None:
            trace.before()
        batch = item[0] if isinstance(item, tuple) else item
        if org:
            if not isinstance(item, tuple):
                raise ValueError("org_loss_factor != 0: the batches must "
                                 "carry their targets")
            args = (to_device(batch, device), to_device(item[1], device))
        else:
            args = (to_device({"images": batch["images"]}, device),)
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        loss, terms = step(*args)
        record(metrics.push(step.step - 1, loss, terms, start))
        if trace is not None:
            trace.after()
    record(metrics.drain())
    out["seconds"] = time.perf_counter() - t_start
    out["loader_s"] = batches.seconds
    return out


def distill(teacher: RCNN, student: RCNN, config: Dict[str, Any],
            train_batches: Iterable[Dict[str, Any]],
            val_batches: Iterable[Dict[str, Any]],
            steps_per_epoch: int,
            use_bottleneck_transformer: bool = False,
            seed: int = 0) -> Dict[str, List]:
    """Distil ``student`` from ``teacher`` for ``train.num_epochs`` epochs,
    each over ``train_batches`` (dicts with ``images`` [B, H, W, 3], uint8
    or float in [0, 1], on the host or on the models' device; with
    ``org_loss_factor != 0``, (batch, targets) pairs as
    ``coco_runner.train`` takes them, ``seed`` seeding the samplers).
    Both models are on one device, the card unless the caller put them on
    the CPU.
    The student trains what its factory left trainable (everything outside
    ``frozen_modules``).  Each epoch's eval quantizes and dequantizes the
    bottleneck only with ``use_bottleneck_transformer`` (JAX's
    ``-transform_bottleneck``).

    Returns {"steps": [(step, loss, {term: value}, ms)], "evals": [the
    records of ``evaluate`` for each epoch]}; ms is the step's time between
    CUDA events (None on the CPU)."""
    step = make_step(teacher, student, config, steps_per_epoch, seed)
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
    from that file when it exists; ``--tb_dir``'s scalars and
    ``--profile_dir``'s trace.

    Returns {"steps": [(step, loss, {term: value}, ms)], "epochs": [{
    "val_map", "saved", "train" (seconds, loader_s: the ranks' mean),
    "eval" (the times of ``coco_evaluate``), "stats"}]}.  At N ranks an
    epoch is ``len(train_loader)`` steps on every rank
    (``common.epoch_batches``)."""
    train_cfg = config["train"]
    ckpt_path = config["student_model"].get("ckpt")
    common.check_ckpt_backend(config)
    step = make_step(teacher, student, config, len(train_loader), args.seed)
    best = 0.0
    if ckpt_util.check_if_exists(ckpt_path):
        best = common.resume(ckpt_path, student, step)
    log_freq = int(train_cfg.get("log_freq", 1000))
    history: Dict[str, List] = {"steps": [], "epochs": []}
    tb = common.summary_writer(args)
    trace = StepTrace(getattr(args, "profile_dir", None))
    try:
        for epoch in range(int(train_cfg["num_epochs"])):
            train_loader.set_epoch(epoch)
            done = train_epoch(step, common.epoch_batches(train_loader),
                               log_freq, f"Epoch: [{epoch}]", tb, trace)
            history["steps"] += done.pop("steps")
            common.mean_over_ranks(done)
            evaluator, times = common.coco_evaluate(
                student.eval(), val_loader,
                use_bottleneck_transformer=args.transform_bottleneck)
            student.train()
            val_map = float(evaluator.stats["bbox"][0])
            tb.add_scalar("val/map", val_map, epoch)
            tb.flush()
            saved = bool(val_map > best and ckpt_path)
            if saved:
                best = val_map
                multihost.save_on_master(common.save_checkpoint, ckpt_path,
                                         student, step, best, config, args)
                print(f"saved best ckpt (val mAP {val_map:.4f})", flush=True)
            history["epochs"].append({
                "val_map": val_map, "saved": saved, "train": done,
                "eval": times,
                "stats": {k: v.tolist() for k, v in evaluator.stats.items()}})
    finally:
        trace.close()
        tb.close()
    return history


def run(config: Dict[str, Any], args: argparse.Namespace,
        devices: Optional[Sequence] = None) -> Dict[str, Any]:
    """``main`` after the config is loaded: distil when ``-distill``, reload
    the best checkpoint, then the test evals (mimic_runner.py:225-255).
    As N ranks when a launch or the caller's group says so, or as the
    local mode's workers, one a card (``common.launch``): each distils its
    share of the global batch, evaluates its share of val and test, and
    reads the merged stats.

    Returns {"distill": the history of ``distill_coco`` (with -distill),
    "teacher" and "student": {"stats", "eval"} of the test evals}: rank
    0's, in the local mode.  ``devices``: the local mode's, in place of
    every visible card."""
    return common.launch(_run, config, args, devices)


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
