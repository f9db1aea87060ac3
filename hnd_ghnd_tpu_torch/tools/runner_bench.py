"""Sustained throughput of the port's shipped runner loops.

Counterpart of tools/runner_bench.py.  ``measure_runner_loop`` runs
``runners/mimic_runner.distill_coco`` (the loop ``mimic_runner -distill``
runs: MetricLogger, StepMetrics' lag-1 reads, the per-step CUDA events,
``set_epoch``, the best-checkpoint bookkeeping) for two epochs over one
batch already on the device (``RepeatLoader``); epoch 1 pays cuDNN's and
the kernels' first calls.  ``common.coco_evaluate`` is replaced, for the
call only, by a stub that marks the epoch boundaries, and the epoch-2
training window is timed from the end of epoch 1's eval to the start of
epoch 2's: N steps and the loop's drain of the last one, with no per-step
wait beyond the lag-1 reads.  ``measure_coco_runner_loop`` is its
supervised twin over ``coco_runner.train_coco``.

The models are the GHND b3ch student and its ResNet-50 teacher of
__graft_entry__.py (the configs are copied here), seeded as the JAX tool
seeds them (teacher 0, student 1).  The port runs one step per dispatch:
JAX's ``steps_per_dispatch`` and ``dispatch_unroll`` (an XLA scan) have no
counterpart, and ``--spd`` / ``--unroll`` other than 1 raise.

    python -m hnd_ghnd_tpu_torch.tools.runner_bench [--batch 24]
        [--steps 120] [--hw 832,1344] [--kind ghnd|hnd]
        [--runner mimic|coco] [--dtype bfloat16|float32] [--device cpu]

Prints one JSON line: JAX's keys, plus ``step_ms`` (epoch 2's per-step
CUDA-event times: median, min, max; None on the CPU),
``peak_memory_gib`` (``torch.cuda.max_memory_allocated`` over the run;
None on the CPU) and ``window_syncs`` (on the card, where each host sync
of the timed window was called from; None on the CPU).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import warnings
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch

FROZEN = ["backbone.body.layer2", "backbone.body.layer3",
          "backbone.body.layer4", "backbone.fpn", "rpn", "roi_heads"]


def student_config(bch: int = 3) -> Dict[str, Any]:
    """__graft_entry__._student_config: the GHND b3ch Faster R-CNN
    student with its 8-bit bottleneck transformer."""
    return {
        "name": "faster_rcnn",
        "backbone": {
            "name": "custom_resnet50",
            "params": {"pretrained": False, "freeze_layers": False,
                       "layer1": {"name": "Bottleneck4LargeResNet",
                                  "bottleneck_channel": bch}},
        },
        "bottleneck_transformer": {
            "order": ["quantizer", "dequantizer"],
            "components": {"quantizer": {"params": {"num_bits": 8}},
                           "dequantizer": {"params": {"num_bits": 8}}},
        },
        "params": {"num_classes": 91},
    }


def teacher_config() -> Dict[str, Any]:
    """__graft_entry__._teacher_config: the ResNet-50 Faster R-CNN."""
    return {
        "name": "faster_rcnn",
        "backbone": {"name": "resnet50",
                     "params": {"pretrained": False, "freeze_layers": True}},
        "params": {"num_classes": 91},
    }


def distill_criterion(stages=(1, 2, 3, 4)) -> Dict[str, Any]:
    """The MSE-sum criterion over ``backbone.body.layer{i}`` (GHND: 1-4,
    HND: 1), org_loss_factor 0."""
    return {
        "type": "general", "params": {"org_loss_factor": 0.0},
        "terms": {f"layer{i}": {
            "ts_modules": [f"backbone.body.layer{i}"] * 2,
            "criterion": {"type": "MSELoss", "params": {"reduction": "sum"}},
            "factor": 1.0} for i in stages}}


def distill_config(batch: int, kind: str = "ghnd",
                   compute_dtype: str = "bfloat16") -> Dict[str, Any]:
    """The config of JAX's measure_runner_loop (tools/runner_bench.py:84-108):
    two epochs, Adam 1e-3, layers 2-4, the FPN and the heads frozen."""
    stages = (1,) if kind == "hnd" else (1, 2, 3, 4)
    return {
        "train": {
            "batch_size": batch, "num_epochs": 2, "log_freq": 10000,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
            "criterion": distill_criterion(stages),
        },
        "student_model": dict(student_config(), frozen_modules=FROZEN),
        "tpu": {"compute_dtype": compute_dtype},
    }


def seeded_images(batch: int, hw, device: torch.device,
                  seed: int = 42) -> Dict[str, torch.Tensor]:
    """float32 uniform images on ``device`` from a seeded generator there,
    image_sizes [800, 1333] and original_sizes [480, 640], as JAX's tool
    makes its batch on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h, w = hw
    return {
        "images": torch.rand((batch, h, w, 3), generator=gen,
                             device=device),
        "image_sizes": torch.tensor([[800, 1333]] * batch, dtype=torch.int32,
                                    device=device),
        "original_sizes": torch.tensor([[480, 640]] * batch,
                                       dtype=torch.int32, device=device),
    }


class RepeatLoader:
    """Loader stand-in: the same batch (already on the device) ``steps``
    times an epoch, with the surface the runner loops use: iteration over
    (batch, targets, host_targets), ``len``, ``set_epoch``."""

    def __init__(self, batch, steps: int, targets=None):
        self.batch = batch
        self.steps = steps
        self.targets = targets
        self.batch_size = batch["images"].shape[0]

    def __len__(self) -> int:
        return self.steps

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        for _ in range(self.steps):
            yield self.batch, self.targets, None


class _Marks:
    """The stub of ``common.coco_evaluate``: records the host clock at each
    call and returns the surface the runner loops read.  On the card
    (``sync_debug``), ``torch.cuda.set_sync_debug_mode("warn")`` is on
    between the first mark and the second, and the host syncs it reports
    in that window are kept in ``syncs``."""

    def __init__(self, sync_debug: bool = False):
        self.marks: List[float] = []
        self.sync_debug = sync_debug
        self.syncs: Optional[List[str]] = None
        self._caught = None

    def __call__(self, *args, **kwargs):
        self.marks.append(time.perf_counter())
        if self.sync_debug and len(self.marks) == 1:
            self._caught = warnings.catch_warnings(record=True)
            self.syncs = self._caught.__enter__()
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
        elif self._caught is not None and len(self.marks) == 2:
            self.stop()
        return SimpleNamespace(stats={"bbox": np.zeros(12)}), {}

    def stop(self) -> None:
        if self._caught is None:
            return
        torch.cuda.set_sync_debug_mode(0)
        self._caught.__exit__(None, None, None)
        self._caught = None
        # the mode's own notice that it is a prototype is not a sync
        self.syncs = [f"{w.filename}:{w.lineno}: {w.message}"
                      for w in self.syncs
                      if "synchroniz" in str(w.message).lower()
                      and "prototype feature" not in str(w.message)]


def _run_marked(run, sync_debug: bool):
    """``run()`` with ``common.coco_evaluate`` stubbed, restored after.
    Returns (its result, the marks, t0, t_end)."""
    from hnd_ghnd_tpu_torch.runners import common
    marks = _Marks(sync_debug)
    original = common.coco_evaluate
    common.coco_evaluate = marks
    try:
        t0 = time.perf_counter()
        out = run()
        t_end = time.perf_counter()
    finally:
        marks.stop()
        common.coco_evaluate = original
    if len(marks.marks) != 2:
        raise RuntimeError(f"expected two epoch marks, got {marks.marks}")
    return out, marks, t0, t_end


def _step_ms(entries: List, steps: int) -> Optional[Dict[str, float]]:
    """Median, min and max of the last epoch's per-step CUDA-event ms."""
    ms = [e[3] for e in entries[-steps:] if e[3] is not None]
    if not ms:
        return None
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def _peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _check_one_step_per_dispatch(steps_per_dispatch: int,
                                 dispatch_unroll: int = 1) -> None:
    if steps_per_dispatch != 1 or dispatch_unroll != 1:
        raise NotImplementedError(
            "steps_per_dispatch / dispatch_unroll: the port runs one step "
            "per dispatch (JAX's XLA scan has no counterpart)")


def _report(metric: str, batch: int, steps: int, baseline: float,
            marked: _Marks, t0: float, t_end: float, entries: List,
            device: torch.device) -> Dict[str, Any]:
    marks = marked.marks
    window = marks[1] - marks[0]
    img_s = batch * steps / window
    return {
        "metric": metric,
        "value": round(img_s, 2),
        "unit": "img/s/chip",
        "vs_baseline": round(img_s / baseline, 2),
        "window_s": round(window, 2),
        "steps": steps,
        "epoch1_s": round(marks[0] - t0, 2),
        "total_s": round(t_end - t0, 2),
        "step_ms": _step_ms(entries, steps),
        "peak_memory_gib": _peak_gib(device),
        "window_syncs": marked.syncs,
    }


def measure_runner_loop(batch: int = 24, steps: int = 120, hw=(832, 1344),
                        kind: str = "ghnd", baseline: float = 10.0,
                        compute_dtype: str = "bfloat16",
                        steps_per_dispatch: int = 1,
                        dispatch_unroll: int = 1,
                        device: str | torch.device = "cuda") -> dict:
    """The shipped ``mimic_runner.distill_coco`` loop for two epochs of
    ``steps`` over one batch on ``device``; returns the epoch-2 window's
    rate (the number ``bench.py`` reports), its per-step times and, on the
    card, ``window_syncs``: the host syncs
    ``torch.cuda.set_sync_debug_mode`` reports in the window (the file and
    line that called each)."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    _check_one_step_per_dispatch(steps_per_dispatch, dispatch_unroll)
    device = torch.device(device)
    teacher = get_model(teacher_config(), seed=0, device=device)
    config = distill_config(batch, kind, compute_dtype)
    student = get_model(config["student_model"], seed=1, device=device)
    loader = RepeatLoader(seeded_images(batch, hw, device), steps)
    args = SimpleNamespace(seed=0, transform_bottleneck=False,
                           profile_dir=None, tb_dir=None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    hist, marks, t0, t_end = _run_marked(
        lambda: mimic_runner.distill_coco(teacher, student, config, args,
                                          loader, None),
        device.type == "cuda")
    return _report(f"mimic_runner_distill_img_s_{kind}_b{batch}", batch,
                   steps, baseline, marks, t0, t_end, hist["steps"], device)


def coco_targets(batch: int, device: torch.device, g: int = 8):
    """JAX's seeded boxes (RandomState(3)): ``g`` boxes an image inside
    800x1333, labels 1-90, all valid."""
    rnd = np.random.RandomState(3)
    x1 = rnd.uniform(0, 600, (batch, g, 1)).astype(np.float32)
    y1 = rnd.uniform(0, 400, (batch, g, 1)).astype(np.float32)
    wh = rnd.uniform(40, 300, (batch, g, 2)).astype(np.float32)
    boxes = np.concatenate([x1, y1, np.minimum(x1 + wh[..., :1], 1332.0),
                            np.minimum(y1 + wh[..., 1:], 799.0)], -1)
    labels = rnd.randint(1, 91, (batch, g)).astype(np.int64)
    return {"boxes": torch.from_numpy(boxes).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "boxes_valid": torch.ones((batch, g), dtype=torch.bool,
                                      device=device)}


def measure_coco_runner_loop(batch: int = 16, steps: int = 60,
                             hw=(832, 1344), baseline: float = 10.0,
                             compute_dtype: str = "bfloat16",
                             steps_per_dispatch: int = 1,
                             device: str | torch.device = "cuda") -> dict:
    """The shipped ``coco_runner.train_coco`` loop (the supervised path)
    for two epochs of ``steps`` over one batch and its seeded targets on
    ``device``: the org protocol (frozen conv1, bn1 and layer1; SGD with
    momentum and weight decay, MultiStepLR)."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import coco_runner
    _check_one_step_per_dispatch(steps_per_dispatch)
    device = torch.device(device)
    model_cfg = teacher_config()
    model = get_model(model_cfg, seed=0, device=device)
    config = {
        "model": model_cfg,
        "train": {
            "batch_size": batch, "num_epochs": 2, "log_freq": 10000,
            "optimizer": {"type": "SGD",
                          "params": {"lr": 0.0075, "momentum": 0.9,
                                     "weight_decay": 0.0001}},
            "scheduler": {"type": "MultiStepLR",
                          "params": {"milestones": [16, 22], "gamma": 0.1}},
        },
        "tpu": {"compute_dtype": compute_dtype},
    }
    loader = RepeatLoader(seeded_images(batch, hw, device), steps,
                          coco_targets(batch, device))
    args = SimpleNamespace(seed=0, tb_dir=None)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    hist, marks, t0, t_end = _run_marked(
        lambda: coco_runner.train_coco(model, config, args, loader, None),
        device.type == "cuda")
    return _report(f"coco_runner_train_img_s_b{batch}", batch, steps,
                   baseline, marks, t0, t_end, hist["steps"], device)


def get_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="runner-loop throughput")
    ap.add_argument("--batch", type=int, default=24)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--hw", default="832,1344")
    ap.add_argument("--kind", choices=("ghnd", "hnd"), default="ghnd")
    ap.add_argument("--runner", choices=("mimic", "coco"), default="mimic",
                    help="coco = the supervised coco_runner loop")
    ap.add_argument("--baseline", type=float, default=10.0,
                    help="V100 img/s anchor (BASELINE.md)")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="tpu.compute_dtype (float32 = the shipped config's)")
    ap.add_argument("--spd", type=int, default=1,
                    help="tpu.steps_per_dispatch: 1 only in the port")
    ap.add_argument("--unroll", type=int, default=1,
                    help="tpu.dispatch_unroll: 1 only in the port")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    return ap


def main(argv=None) -> dict:
    a = get_argparser().parse_args(argv)
    hw = tuple(int(v) for v in a.hw.split(","))
    if a.runner == "coco":
        out = measure_coco_runner_loop(a.batch, a.steps, hw, a.baseline,
                                       compute_dtype=a.dtype,
                                       steps_per_dispatch=a.spd,
                                       device=a.device)
    else:
        out = measure_runner_loop(a.batch, a.steps, hw, a.kind, a.baseline,
                                  compute_dtype=a.dtype,
                                  steps_per_dispatch=a.spd,
                                  dispatch_unroll=a.unroll, device=a.device)
    if a.dtype != "bfloat16":
        out["metric"] += f"_{a.dtype}"
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
