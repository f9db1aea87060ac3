"""End-to-end learning demonstration on synthetic data, on one card.

Counterpart of tools/e2e_demo.py.  (1) Overfit a teacher on a tiny
synthetic COCO set through the port's detection step
(``coco_runner.make_step``: bfloat16, SGD lr 0.02, momentum 0.9, no decay,
batch 8 at the 96x96 bucket, min side 64, max side 96); (2) GHND-distil a
bottleneck-3 student from it (``mimic_runner.make_step``: the four
``layer`` MSE-sum terms, Adam 1e-3, layers 2-4, the FPN and the heads
frozen, in ``--distill_dtype``), the student inheriting the teacher's
conv1, bn1, layer2-4, FPN, RPN and RoI heads; (3) evaluate both with
COCOeval (``common.coco_evaluate``), the student without and with its
8-bit bottleneck round trip.  Both loops run through the runners' shipped
epoch loop (``train_epoch``: lag-1 reads, a log line every 50 or 100
steps).  Seeds go through ``torch.Generator``s: teacher ``--seed`` (0),
the samplers ``--seed`` + 1, student ``--seed`` + 2.  On the card the
runs are not bit-reproducible (the RoIAlign backward's float atomics,
cuDNN's algorithms): one seed gives a spread of mAPs.

``--roi_ab`` evaluates the trained teacher twice, its RoIAlign through the
CUDA kernel and through the kernel's plain PyTorch version, and prints both
mAPs and their delta.  ``--kp_ab`` (Keypoint R-CNN) evaluates it with the
host keypoint decode and with the device one (``kp_decode: device``).

    python -m hnd_ghnd_tpu_torch.tools.e2e_demo [--steps 300]
        [--distill_steps 400] [--kind faster_rcnn|mask_rcnn|keypoint_rcnn]
        [--distill_dtype float32|bfloat16] [--skip_distill] [--roi_ab]
        [--kp_ab] [--device cpu] [--out DIR]

Prints JAX's ``RESULT`` lines; ``main`` returns the numbers.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import time
from typing import Any, Dict, Iterable, List

import torch

from hnd_ghnd_tpu_torch.tools import runner_bench
from hnd_ghnd_tpu_torch.tools.runner_bench import FROZEN

BUCKETS = ((96, 96),)
MIN_SIZES = (64,)
MAX_SIZE = 96
BATCH = 8
TEACHER_DTYPE = "bfloat16"
INHERITED = ("backbone.body.conv1.", "backbone.body.bn1.",
             "backbone.body.layer2.", "backbone.body.layer3.",
             "backbone.body.layer4.", "backbone.fpn.", "rpn.", "roi_heads.")


class Cycle:
    """``n`` items cycling over ``items``, with a length (the epoch loops'
    MetricLogger reads it)."""

    def __init__(self, items: List, n: int):
        self.items = items
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        for i in range(self.n):
            yield self.items[i % len(self.items)]


def teacher_config(kind: str, num_classes: int, **params) -> Dict[str, Any]:
    return {
        "name": kind,
        "backbone": {"name": "resnet50",
                     "params": {"pretrained": False, "freeze_layers": False}},
        "params": {"num_classes": num_classes,
                   **({"num_keypoints": 17} if kind == "keypoint_rcnn"
                      else {}), **params}}


def student_config(num_classes: int) -> Dict[str, Any]:
    """The GHND b3ch student with ``num_classes``, layers 2-4, the FPN and
    the heads frozen."""
    return dict(runner_bench.student_config(),
                params={"num_classes": num_classes}, frozen_modules=FROZEN)


def inherit(student, teacher) -> List[str]:
    """Copy the teacher's conv1, bn1, layer2-4, FPN, RPN and RoI-head
    entries into the student (the reference's pretrained=True semantics);
    returns the keys copied.  A shared key of another shape raises."""
    own = student.state_dict()
    copied = {}
    for k, v in teacher.state_dict().items():
        if k.startswith(INHERITED) and k in own:
            if own[k].shape != v.shape:
                raise ValueError(f"the student cannot inherit {k}: "
                                 f"{tuple(v.shape)} vs {tuple(own[k].shape)}")
            copied[k] = v
    student.load_state_dict(copied, strict=False)
    return sorted(copied)


def on_device(batches: Iterable, device: torch.device) -> List:
    """The loader's (batch, targets, host) triples with batch and targets
    moved to ``device`` once."""
    from hnd_ghnd_tpu_torch.runners.common import to_device
    return [(to_device(b, device), to_device(t, device), h)
            for b, t, h in batches]


def stats_of(evaluator) -> Dict[str, float]:
    return {t: float(s[0]) for t, s in evaluator.stats.items()}


@contextlib.contextmanager
def plain_roi_align():
    """The RoIAlign op's plain PyTorch version in place of the kernel's
    launch, on any device, for the duration."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    launch = RK.roi_align_op
    RK.roi_align_op = RK._roi_align_cpu
    try:
        yield
    finally:
        RK.roi_align_op = launch


def roi_ab(teacher, test_loader) -> Dict[str, Any]:
    """The same weights evaluated through the RoIAlign kernel and through
    its plain version; the kernel's launches counted in each."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.runners import common
    ab, launches = {}, {}
    for impl in ("kernel", "plain"):
        before = sum(RK.roi_align.launches.values())
        with plain_roi_align() if impl == "plain" else contextlib.nullcontext():
            ev, _ = common.coco_evaluate(teacher.eval(), test_loader)
        launches[impl] = sum(RK.roi_align.launches.values()) - before
        ab[impl] = {t: round(v, 4) for t, v in stats_of(ev).items()}
    out = {"roi_ab": ab, "launches": launches,
           "delta_bbox": round(ab["kernel"]["bbox"] - ab["plain"]["bbox"], 5)}
    print(json.dumps(out), flush=True)
    return out


def kp_ab(teacher, kind: str, num_classes: int, test_loader,
          device) -> Dict[str, Any]:
    """The same weights evaluated with the host and the device keypoint
    decode."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import common
    ab = {}
    for decode in ("host", "device"):
        m = get_model(teacher_config(kind, num_classes, kp_decode=decode),
                      device=device)
        m.load_state_dict(teacher.state_dict())
        ev, _ = common.coco_evaluate(m.eval().requires_grad_(False),
                                     test_loader)
        ab[decode] = {t: round(v, 4) for t, v in stats_of(ev).items()}
    out = {"kp_ab": ab, "delta_keypoints": round(
        ab["device"]["keypoints"] - ab["host"]["keypoints"], 5)}
    print(json.dumps(out), flush=True)
    return out


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="end-to-end learning demo")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--distill_steps", type=int, default=400)
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--out", default=None,
                   help="fixture directory (a temporary one by default)")
    p.add_argument("--distill_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kind", default="faster_rcnn",
                   choices=["faster_rcnn", "mask_rcnn", "keypoint_rcnn"])
    p.add_argument("--skip_distill", action="store_true")
    p.add_argument("--roi_ab", action="store_true",
                   help="after training, evaluate through the RoIAlign "
                        "kernel and through its plain version")
    p.add_argument("--kp_ab", action="store_true",
                   help="(keypoint_rcnn) after training, evaluate with the "
                        "host and the device keypoint decode")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    p.add_argument("--seed", type=int, default=0,
                   help="teacher init seed; the samplers take seed + 1, "
                        "the student's init seed + 2")
    return p


def main(argv=None) -> Dict[str, Any]:
    args = get_argparser().parse_args(argv)
    if args.kp_ab and args.kind != "keypoint_rcnn":
        raise ValueError("--kp_ab needs --kind keypoint_rcnn")
    with contextlib.ExitStack() as stack:
        out_dir = args.out or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="e2e_demo_"))
        return run(args, out_dir)


def run(args: argparse.Namespace, out_dir: str) -> Dict[str, Any]:
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset
    from hnd_ghnd_tpu_torch.data.fixtures import make_coco_fixture
    from hnd_ghnd_tpu_torch.data.loader import DetectionLoader
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import (coco_runner, common,
                                            mimic_runner)

    kind = args.kind
    device = common.rank_device(args.device)
    img_dir, ann_file = make_coco_fixture(
        out_dir, num_images=args.images, seed=11,
        num_classes=1 if kind == "keypoint_rcnn" else 3,
        keypoints=kind == "keypoint_rcnn")
    ds = CocoDataset(img_dir, ann_file, with_masks=kind == "mask_rcnn",
                     with_keypoints=kind == "keypoint_rcnn")
    train_loader = DetectionLoader(ds, BATCH, training=True, min_sizes=MIN_SIZES,
                                   max_size=MAX_SIZE, buckets=BUCKETS,
                                   hflip_prob=0.0, num_workers=2)
    test_loader = DetectionLoader(ds, 1, training=False, min_sizes=MIN_SIZES,
                                  max_size=MAX_SIZE, buckets=BUCKETS,
                                  num_workers=2)
    num_classes = 2 if kind == "keypoint_rcnn" else 4
    teacher = get_model(teacher_config(kind, num_classes), seed=args.seed,
                        device=device)
    batches = on_device(train_loader, device)
    result: Dict[str, Any] = {"kind": kind}

    # ---- phase 1: overfit the teacher ------------------------------------
    config = {"model": teacher_config(kind, num_classes),
              "train": {"optimizer": {"type": "SGD", "params": {
                  "lr": 0.02, "momentum": 0.9, "weight_decay": 0.0}}},
              "tpu": {"compute_dtype": TEACHER_DTYPE}}
    # one step an epoch: no warmup, as JAX's demo has none
    step = coco_runner.make_step(teacher, config, 1, seed=args.seed + 1)
    t0 = time.perf_counter()
    done = coco_runner.train_epoch(step, Cycle(batches, args.steps),
                                   log_freq=50, header="teacher")
    losses = [s[1] for s in done["steps"]]
    result["teacher_loss"] = (losses[0], losses[-1])
    result["teacher_s"] = time.perf_counter() - t0
    print(f"teacher loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({args.steps} steps, {result['teacher_s']:.1f} s)", flush=True)

    print("== teacher eval ==", flush=True)
    teacher.eval().requires_grad_(False)
    tev, _ = common.coco_evaluate(teacher, test_loader)
    result["teacher"] = stats_of(tev)
    teacher_map = result["teacher"]["bbox"]
    if args.roi_ab:
        result["roi_ab"] = roi_ab(teacher, test_loader)
    if args.kp_ab:
        result["kp_ab"] = kp_ab(teacher, kind, num_classes, test_loader,
                                device)
    if args.skip_distill:
        print(f"\nRESULT {kind} teacher stats: {result['teacher']}",
              flush=True)
        return result

    # ---- phase 2: GHND-distil the student ---------------------------------
    student = get_model(student_config(num_classes), seed=args.seed + 2,
                        device=device)
    result["inherited"] = inherit(student, teacher)
    dconfig = {"train": {
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
        "criterion": runner_bench.distill_criterion()},
        "tpu": {"compute_dtype": args.distill_dtype}}
    dstep = mimic_runner.make_step(teacher, student, dconfig, 1)
    t0 = time.perf_counter()
    done = mimic_runner.train_epoch(dstep, Cycle(batches, args.distill_steps),
                                    log_freq=100, header="distill")
    dlosses = [s[1] for s in done["steps"]]
    result["distill_loss"] = (dlosses[0], dlosses[-1])
    result["distill_s"] = time.perf_counter() - t0

    student.eval().requires_grad_(False)
    print("== student eval (no transformer) ==", flush=True)
    sev_raw, _ = common.coco_evaluate(student, test_loader)
    print("== student eval (8-bit bottleneck transformer ON) ==", flush=True)
    sev, _ = common.coco_evaluate(student, test_loader,
                                  use_bottleneck_transformer=True)
    result["student_raw"] = stats_of(sev_raw)
    result["student"] = stats_of(sev)
    student_map = result["student"]["bbox"]
    result["retention"] = student_map / max(teacher_map, 1e-9)
    print(f"student mAP raw={result['student_raw']['bbox']:.4f} "
          f"quantized={student_map:.4f}", flush=True)
    print(f"\nRESULT teacher mAP={teacher_map:.4f} "
          f"student mAP={student_map:.4f} "
          f"retention={100 * result['retention']:.1f}% "
          f"distill loss {dlosses[0]:.1f} -> {dlosses[-1]:.1f}", flush=True)
    return result


if __name__ == "__main__":
    main()
