"""Headline benchmark of the port: GHND distillation images/sec/chip.

Counterpart of bench.py: the reference's hot loop (teacher forward,
student forward, the four-term MSE sum and an Adam step on the bottleneck)
at COCO training resolution (bucket 832x1344, image sizes 800x1333),
batch 24, bfloat16, on one card.

  * ``raw_step_img_s``: ``build_distill_bench``'s step, WARMUP steps each
    read back, then ITERS steps queued back to back with one
    ``torch.cuda.synchronize()`` at the end (bench.py:78-98);
  * ``value``: the shipped runner loop's rate, epoch 2 of
    ``tools/runner_bench.measure_runner_loop(batch=24, steps=60,
    hw=(832, 1344))`` (the loop ``mimic_runner -distill`` runs).  A failure
    of the loop is an error, not a number: there is no fallback.

``vs_baseline`` is against the 10 img/s V100 anchor of BASELINE.md.
Earlier lines, each with the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them: the peak device memory, epoch 2's per-step CUDA-event ms (median,
min, max) and host syncs in the timed window
(``torch.cuda.set_sync_debug_mode``), and the float32 rate of the same loop
(``--f32_steps``; float32 is the compute dtype of
config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml).  The fused stem
kernels run only under ``HND_TPU_PALLAS_STEM=1``, as in the JAX package.

    python -m hnd_ghnd_tpu_torch.bench [--f32_steps 60] [--device cpu]

The last line of stdout is one JSON object with bench.py's keys.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from hnd_ghnd_tpu_torch.tools import runner_bench

V100_BASELINE_IMG_S = 10.0
BATCH = 24
BUCKET = (832, 1344)
WARMUP = 3
ITERS = 10
LOOP_STEPS = 60


def build_distill_bench(batch_size: int = BATCH, bucket=BUCKET,
                        compute_dtype: str = "bfloat16",
                        device: str | torch.device = "cuda"
                        ) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The GHND distill step and the batch of the headline bench
    (bench.py:28-75): teacher seed 0, student seed 1, the four-term MSE sum,
    Adam 1e-3, layers 2-4, the FPN and the heads frozen; float32 images
    from ``np.random.RandomState(0)``, image and original sizes 800x1333.
    Returns (step, batch on ``device``)."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    device = torch.device(device)
    config = runner_bench.distill_config(batch_size, "ghnd", compute_dtype)
    teacher = get_model(runner_bench.teacher_config(), seed=0, device=device)
    student = get_model(config["student_model"], seed=1, device=device)
    # one epoch of one step: no warmup and no milestones, a constant lr
    step = mimic_runner.make_step(teacher, student.train(), config, 1)
    h, w = bucket
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(batch_size, h, w, 3)
                              .astype(np.float32))
    sizes = torch.tensor([[800, 1333]] * batch_size, dtype=torch.int32)
    batch = {"images": images.to(device), "image_sizes": sizes.to(device),
             "original_sizes": sizes.clone().to(device)}
    return step, batch


def raw_step_rate(step, batch, warmup: int = WARMUP,
                  iters: int = ITERS) -> float:
    """Images/s of ``iters`` steps queued back to back after ``warmup``
    steps, each read back; one sync at the end."""
    device = batch["images"].device
    for _ in range(warmup):
        loss, _ = step(batch)
        float(loss)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss, _ = step(batch)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    else:
        float(loss)
    dt = time.perf_counter() - t0
    return batch["images"].shape[0] * iters / dt


def card_name(device: torch.device) -> str:
    """The card's name and power limit from nvidia-smi ("cpu" on the
    CPU)."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i",
                          str(device.index or 0)],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def get_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the port's headline bench")
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--f32_steps", type=int, default=LOOP_STEPS,
                    help="steps an epoch of the float32 loop (0: skip it)")
    return ap


def main(argv=None) -> Dict[str, Any]:
    a = get_argparser().parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        device = torch.device("cuda", torch.cuda.current_device())
    card = card_name(device)

    step, batch = build_distill_bench(BATCH, BUCKET, "bfloat16", device)
    img_s = raw_step_rate(step, batch)
    del step, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()

    loop = runner_bench.measure_runner_loop(
        batch=BATCH, steps=LOOP_STEPS, hw=BUCKET, device=device)
    value = loop["value"]
    print(json.dumps({"card": card, "loop": loop}), flush=True)
    print(json.dumps({"card": card, "peak_memory_gib":
                      loop["peak_memory_gib"]}), flush=True)
    print(json.dumps({"card": card, "epoch2_step_ms": loop["step_ms"],
                      "window_syncs": loop["window_syncs"],
                      "steps": LOOP_STEPS}), flush=True)
    if a.f32_steps:
        if device.type == "cuda":
            torch.cuda.empty_cache()
        f32 = runner_bench.measure_runner_loop(
            batch=BATCH, steps=a.f32_steps, hw=BUCKET, device=device,
            compute_dtype="float32")
        print(json.dumps({"card": card, "float32": f32}), flush=True)
    out = {
        "metric": "mimic_runner_distill_images_per_sec_per_chip",
        "value": value,
        "unit": "images/sec/chip",
        "vs_baseline": round(value / V100_BASELINE_IMG_S, 2),
        "raw_step_img_s": round(img_s, 2),
        "loop": "mimic_runner.distill_coco epoch-2 window",
        "note": "the shipped loop over one batch on the card, epoch 2 of "
                f"{LOOP_STEPS} steps; no fallback to the raw rate",
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
