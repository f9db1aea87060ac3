"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of hnd_ghnd_tpu_torch/csrc from the checkout and
holds each against its plain PyTorch version on the card.  Then the two
paths, at full width with random weights and BN statistics from a seed:

  * serving: seeded batches through the GHND b3ch Faster R-CNN student
    (batch 8 at 832x1344 and 1344x832, batch 1 at 832x1344), compared with
    the CPU on the batch-1 input;
  * the heads: the same batches through the GHND b3ch Mask R-CNN and
    Keypoint R-CNN students, with int8_roi_pool off and then on (the level
    quantizer and the int8 RoIAlign), their heads compared with the CPU's
    on the CPU's FPN maps and detections;
  * distillation: ``mimic_runner.distill`` of the student from the ResNet-50
    teacher, batch 4 on both buckets, with the fused stem switched on
    (HND_TPU_PALLAS_STEM=1), then its per-epoch eval on a batch-8 serving
    batch; the same steps again with the switch off (cuDNN's stem); one
    step compared with a float64 step on the CPU;
  * supervised training: ``coco_runner.train`` of the org Faster R-CNN of
    config/org/faster_rcnn-backbone_resnet50.yaml in bfloat16, batch 2 on
    both buckets with seeded synthetic targets, then its float32 eval on a
    batch-8 serving batch; one float32 step compared with a float64 step on
    the CPU.

Each path checks that every kernel it runs was launched.  Any failed check
raises.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists each kernel's route, launches, error, times (as its caller sees
it, ``ms``, and on the card alone, ``device_ms``) and bound.  Without a
GPU, or without the package beside it, the script exits nonzero and prints
no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import copy
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# student_model, teacher_model and train of
# config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml, spelled out because
# yaml may be missing where this runs
STUDENT_MODEL = {
    "name": "faster_rcnn",
    "backbone": {
        "name": "custom_resnet50",
        "params": {
            "pretrained": True,
            "freeze_layers": False,
            "layer1": {"name": "Bottleneck4LargeResNet", "bottleneck_channel": 3},
        },
    },
    "bottleneck_transformer": {
        "order": ["quantizer", "dequantizer"],
        "components": {
            "quantizer": {"params": {"num_bits": 8}},
            "dequantizer": {"params": {"num_bits": 8}},
        },
    },
    "params": {"num_classes": 91, "pretrained": True},
    "distill_backbone_only": True,
    "frozen_modules": ["backbone.body.layer2", "backbone.body.layer3",
                       "backbone.body.layer4", "backbone.fpn", "rpn",
                       "roi_heads"],
    "experiment": "coco2017-faster_rcnn-backbone_custom_resnet50_from_"
                  "faster_rcnn-backbone_resnet50-b3ch",
    "ckpt": "./resource/ckpt/ghnd/coco2017-faster_rcnn-backbone_custom_"
            "resnet50_from_faster_rcnn-backbone_resnet50-b3ch.pt",
}
# student_model of config/ghnd/mask_rcnn-backbone_resnet50-b3ch.yaml and of
# config/ghnd/keypoint_rcnn-backbone_resnet50-b3ch.yaml: the same trunk,
# bottleneck and frozen modules as STUDENT_MODEL, another head
MASK_STUDENT_MODEL = dict(
    STUDENT_MODEL, name="mask_rcnn",
    experiment="coco2017-mask_rcnn-backbone_custom_resnet50_from_mask_rcnn-"
               "backbone_resnet50-b3ch",
    ckpt="./resource/ckpt/ghnd/coco2017-mask_rcnn-backbone_custom_resnet50_"
         "from_mask_rcnn-backbone_resnet50-b3ch.pt")
KEYPOINT_STUDENT_MODEL = dict(
    STUDENT_MODEL, name="keypoint_rcnn",
    params={"num_classes": 2, "pretrained": True, "num_keypoints": 17},
    experiment="coco2017-keypoint_rcnn-backbone_custom_resnet50_from_"
               "keypoint_rcnn-backbone_resnet50-b3ch",
    ckpt="./resource/ckpt/ghnd/coco2017-keypoint_rcnn-backbone_custom_"
         "resnet50_from_keypoint_rcnn-backbone_resnet50-b3ch.pt")
TEACHER_MODEL = {
    "name": "faster_rcnn",
    "backbone": {"name": "resnet50",
                 "params": {"pretrained": True, "freeze_layers": True}},
    "params": {"num_classes": 91, "pretrained": True},
    "experiment": "coco2017-faster_rcnn-backbone_resnet50",
    "ckpt": "./resource/ckpt/org/coco2017-faster_rcnn-backbone_resnet50.pt",
}
TRAIN = {
    "num_epochs": 20,
    "batch_size": 4,
    "log_freq": 1000,
    "optimizer": {"type": "Adam", "params": {"lr": 0.001}},
    "criterion": {
        "type": "general",
        "params": {"org_loss_factor": 0.0},
        "terms": {
            f"layer{i}": {
                "ts_modules": [f"backbone.body.layer{i}"] * 2,
                "criterion": {"type": "MSELoss",
                              "params": {"reduction": "sum"}},
                "factor": 1.0,
            } for i in (1, 2, 3, 4)
        },
    },
    "scheduler": {"type": "MultiStepLR",
                  "params": {"milestones": [5, 15], "gamma": 0.1}},
}
COMPUTE_DTYPE = "float32"      # tpu.compute_dtype of the same config
# model, train and tpu of config/org/faster_rcnn-backbone_resnet50.yaml: its
# model block is the GHND config's teacher_model
ORG_MODEL = TEACHER_MODEL
ORG_TRAIN = {
    "num_epochs": 26,
    "batch_size": 2,
    "log_freq": 1000,
    "optimizer": {"type": "SGD", "params": {"lr": 0.0075, "momentum": 0.9,
                                            "weight_decay": 0.0001}},
    "scheduler": {"type": "MultiStepLR",
                  "params": {"milestones": [16, 22], "gamma": 0.1}},
}
ORG_TPU = {"buckets": [[832, 1344], [1344, 832]], "compute_dtype": "bfloat16",
           "mesh_axis": "data", "eval_batch_size": 8, "pixel_dtype": "float32"}
# the training phase: batch 2 (train.batch_size), 3 steps on each bucket and
# the first batch again (warmup 6 of 7 steps); 1-8 GT boxes per image,
# padded to the JAX loader's MAX_GT
ORG_BATCH = 2
MAX_GT = 100
# RoI sampling of the train step: 512 per image, P2-P5 of 256 channels
TRAIN_ROIS = 512
BUCKETS = ((832, 1344), (1344, 832))
EVAL_BATCH = 8                 # tpu.eval_batch_size
SEED = 0
# fp32 with TF32 off on both sides: only summation order differs (cuDNN vs
# the CPU's convolutions over up to 4608-term dot products through ~60
# layers), so each stage agrees to 1e-4 of its largest magnitude
STAGE_TOL = 1e-4
ROI_TOL = 1e-5                 # RoIAlign: identical arithmetic, order only
# the stem kernels sum in another order than cuDNN: 147-term sums for the
# forward, B x OH x OW-term sums (1.1 M at batch 4) for dW
STEM_FWD_TOL = 1e-5            # x max |plain output|
STEM_DW_TOL = 1e-4             # x max |plain dW|
REPS = 25                      # timed runs per kernel; the median is kept
# ~5 ms of the card's clock: longer than the host takes to enqueue any
# kernel's call with its wrapper's checks (time_ms's device reading)
SPIN_CYCLES = 10_000_000
# the card's peaks for the bound of a kernel (H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12        # float32 outside the tensor cores
# the distill phase: batch 4 (train.batch_size), pixel_dtype float32; the
# first batch comes back last, so the loss must have fallen on it
TRAIN_BATCH = 4
STEPS_PER_BUCKET = 3
# losses of the switched-off run against the switched-on one: the first
# step differs only in the stem's summation order; after it, Adam's first
# moves of +-lr on near-zero gradients may go either way
LOSS_TOL_FIRST = 1e-5
LOSS_TOL_LATER = 1e-3
# one distill step on the card (float32) against the CPU in float64, at
# batch 1 on a quarter of the 832x1344 bucket (the CPU's time).  The
# gradients reach the stem and encoder through six train-mode BNs whose
# backward cancels: float32 gradients on the CPU land up to 3.6e-4 of a
# leaf's largest element off float64 (tests/test_torch_port_distill.py),
# and cuDNN's float32 convolutions up to 2.3e-3 (this phase on an H100
# 80GB HBM3 at 700 W: an encoder BN bias)
CPU_SHAPE = (416, 672)
CPU_TERM_TOL = 1e-5
CPU_GRAD_TOL = 5e-3
CPU_STATS_TOL = 1e-5
# one supervised float32 step on the card against the CPU in float64, at
# batch 1 on the same quarter bucket, both sides on the CPU's RoI samples
# and the same RPN draws: the four terms, and the gradients of the RoI
# heads and the FPN (through the backward kernel).  On an H100 80GB HBM3
# at 700 W, over two draws of random weights, the terms agreed to 9.1e-7
# and the gradients to 1.65e-3 of a leaf's largest element in the RoI
# heads (fc7's bias: fc6/fc7 pre-activations within float32 noise of 0 flip
# their ReLU between the two sides) and to 1.6e-4 in the FPN
TRAIN_TERM_TOL = 1e-5
TRAIN_HEAD_GRAD_TOL = 5e-3     # x a leaf's largest gradient element
TRAIN_FPN_GRAD_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, spin: bool = False) -> float:
    """Median of REPS CUDA-event timings of ``fn`` after a warm-up.  With
    ``spin`` each timing starts behind a spin of the card (SPIN_CYCLES)
    that outlasts the host's enqueueing of ``fn``, so it reads the card's
    time for ``fn``'s work; without it, the card may wait on the host's
    launching (a wrapper's checks and small torch ops can take longer on
    the host than a fast kernel on the card)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(fn) -> dict:
    """``fn``'s time both ways: ``ms`` as the caller sees it, ``device_ms``
    on the card alone (time_ms)."""
    return {"ms": time_ms(fn), "device_ms": time_ms(fn, spin=True)}


def box_mix(rng: np.random.RandomState, b: int, n: int, h: int, w: int):
    """Square, tall, wide, sub-pixel and partly off-image boxes, [b, n, 4]
    float32: the mix of tests/test_pallas_roi.py, whose sizes are for a
    256x512 image, with the long sides scaled to h x w."""
    sy, sx = h / 256.0, w / 512.0
    out = []
    for i in range(b * n):
        kind = i % 5
        if kind == 0:    # square-ish
            bw, bh = rng.uniform(20, 200) * sx, rng.uniform(20, 200) * sy
        elif kind == 1:  # tall
            bw, bh = rng.uniform(2, 10), rng.uniform(200, 250) * sy
        elif kind == 2:  # wide
            bw, bh = rng.uniform(200, 500) * sx, rng.uniform(2, 10)
        elif kind == 3:  # tiny / sub-pixel
            bw, bh = rng.uniform(0.1, 4), rng.uniform(0.1, 4)
        else:            # large, often partly off-image
            bw, bh = rng.uniform(50, 400) * sx, rng.uniform(50, 200) * sy
        x1 = rng.uniform(-20, w - bw / 2)
        y1 = rng.uniform(-20, h - bh / 2)
        out.append([x1, y1, x1 + bw, y1 + bh])
    return np.array(out, np.float32).reshape(b, n, 4)


def quant_input(seed: int, shape) -> np.ndarray:
    """Seeded float32 input for the quantizer: N(0, 9) around an offset."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 3 + rng.uniform(-2, 2)).astype(np.float32)


def live_norms_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Give every BatchNorm of ``model`` seeded random statistics and
    affines, in place, with the last BN of each residual branch (``bn3``)
    scaled 0.1-0.3 so activations stay bounded.

    The seeded init (like the JAX package's) leaves frozen BNs at identity
    and zeroes each ``bn3``, which multiplies every residual branch of
    layer2-4 by 0: a comparison on those weights cannot see the branches,
    nor how a BN uses its mean, variance and eps."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if getattr(m, "running_var", None) is None:
            continue
        n = m.running_var.numel()
        lo, hi = (0.1, 0.3) if name.endswith(".bn3") else (0.5, 1.5)
        with torch.no_grad():
            for t, a, b in ((m.weight, lo, hi), (m.bias, -0.1, 0.1),
                            (m.running_mean, -0.1, 0.1),
                            (m.running_var, 0.5, 2.0)):
                t.copy_(torch.empty(n).uniform_(a, b, generator=gen))
    return model


def serving_model(device: torch.device):
    """The b3ch student at full width from seed SEED, with live BNs and the
    class logits spread x300: random weights give near-uniform class
    scores under the 0.05 threshold, and the spread makes the thresholds
    and the per-class NMS select real detections."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    model = live_norms_(get_model(STUDENT_MODEL, seed=SEED, device=device),
                        SEED)
    model.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    return model.requires_grad_(False)  # serving only: no autograd graph


def serving_batches(rng: np.random.RandomState):
    """uint8 batches padded into their bucket, like the loader's."""
    out = []
    for (bh, bw), b in ((BUCKETS[0], EVAL_BATCH), (BUCKETS[1], EVAL_BATCH),
                        (BUCKETS[0], 1)):
        images = np.zeros((b, bh, bw, 3), np.uint8)
        sizes = np.zeros((b, 2), np.int32)
        for i in range(b):
            h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
            w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
            images[i, :h, :w] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
            sizes[i] = (h, w)
        original = np.round(sizes * 0.75).astype(np.int32)
        out.append({"images": images, "image_sizes": sizes,
                    "original_sizes": original})
    return out


def rel_err(got, want) -> float:
    want = want.detach().float().cpu()
    got = got.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def tapped_bytes(levels, boxes, valid, image_size, pool: int) -> int:
    """The bytes of P2-P5 that a RoIAlign of ``boxes`` reads at least: the
    cells a valid RoI taps with a nonzero weight, times C and the element
    size (a tighter bound than whole levels, which ``bound_ms`` counts).
    They are the nonzero entries of the plain version's gradient at one
    channel (its weights are >= 0, so they never cancel)."""
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    ones = [torch.zeros((f.shape[0], f.shape[1], f.shape[2], 1),
                        device=f.device, requires_grad=True) for f in levels]
    out = multiscale_roi_align_batch(ones, boxes, image_size, pool, 2, valid)
    grads = torch.autograd.grad(out.sum(), ones)
    cells = sum(int((g != 0).sum()) for g in grads)
    return cells * levels[0].shape[-1] * levels[0].element_size()


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over their peak rate."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_FP32_PER_S * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def stem_inputs(gen: torch.Generator, shape, device: torch.device):
    """A normalised-image-like input and a stem conv with the trunk's init
    scale (kaiming-normal, fan out) and a live frozen-BN affine."""
    x = torch.randn(shape, generator=gen, device=device)
    w = torch.randn((64, 3, 7, 7), generator=gen, device=device) \
        * (2.0 / (64 * 49)) ** 0.5
    scale = torch.rand(64, generator=gen, device=device) + 0.5
    bias = torch.randn(64, generator=gen, device=device) * 0.1
    return x, w, scale, bias


def stem_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The three stem kernels against their plain versions at the distill
    step's shapes (batch 4 on both buckets), on a ragged shape (33 x 50
    outputs: a partial tile in each direction) and on one with W/2 odd
    whose tiles no persistent grid divides (65 x 673 outputs, 594 tiles),
    timed at both buckets."""
    import torch.nn.functional as F
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(TRAIN_BATCH, 3) + BUCKETS[0], (TRAIN_BATCH, 3) + BUCKETS[1],
              (2, 3, 66, 100), (3, 3, 130, 1346)]
    for shape in shapes:
        x, w, scale, bias = stem_inputs(gen, shape, dev)
        want, conv = ts.stem_forward(x, w, scale, bias, with_conv=True)
        got = SK.stem_fwd(x, w, scale, bias)
        got_res, got_conv = SK.stem_fwd_res(x, w, scale, bias)
        g = torch.randn(conv.shape, generator=gen, device=dev)
        dw = SK.stem_dw(x, g)
        want_dw = ts.stem_weight_grad(x, g)
        torch.cuda.synchronize()
        errs = {
            "stem_fwd": (float((got - want).abs().max()),
                         float(want.abs().max()), STEM_FWD_TOL),
            "stem_fwd_res": (max(float((got_res - want).abs().max()),
                                 float((got_conv - conv).abs().max())),
                             float(conv.abs().max()), STEM_FWD_TOL),
            "stem_dw": (float((dw - want_dw).abs().max()),
                        float(want_dw.abs().max()), STEM_DW_TOL),
        }
        check(torch.equal(SK.stem_dw(x, g), dw), "stem_dw is not repeatable")
        for name, (err, scale_, tol) in errs.items():
            log(f"[stem] {name} {shape}: max abs err {err:.3e} (max |plain| "
                f"{scale_:.3e}, bound {tol} x max)")
            check(err <= tol * scale_, f"{name} {shape}: {err} > {tol} x "
                  f"{scale_}")
        if shape in shapes[:2]:
            times = {
                "stem_fwd": (timings(lambda: SK.stem_fwd(x, w, scale, bias)),
                             time_ms(lambda: ts.stem_forward(x, w, scale,
                                                             bias))),
                "stem_fwd_res": (
                    timings(lambda: SK.stem_fwd_res(x, w, scale, bias)),
                    time_ms(lambda: ts.stem_forward(x, w, scale, bias,
                                                    with_conv=True))),
                "stem_dw": (timings(lambda: SK.stem_dw(x, g)),
                            time_ms(lambda: ts.stem_weight_grad(x, g))),
            }
            # one PyTorch call each: the conv alone (no affine, no ReLU)
            # for the forwards, conv2d_weight for dW
            conv_ms = time_ms(lambda: F.conv2d(x, w, stride=2, padding=3))
            dw_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x, w.shape, g, stride=2, padding=3))
            for name, (k, p_ms) in times.items():
                lib = dw_ms if name == "stem_dw" else conv_ms
                log(f"[stem] {name} {shape}: {k['ms']:.4f} ms kernel "
                    f"({k['device_ms']:.4f} on the card), {p_ms:.4f} ms plain, "
                    f"{lib:.4f} ms library (median of {REPS})")
        if shape == shapes[0]:
            macs = 2.0 * 147 * conv.numel()
            bounds = {
                "stem_fwd": bound(nbytes(x, w, scale, bias, want),
                                  macs + 3.0 * want.numel()),
                "stem_fwd_res": bound(nbytes(x, w, scale, bias, want, conv),
                                      macs + 3.0 * want.numel()),
                "stem_dw": bound(nbytes(x, g, dw), macs),
            }
            for name, line in (("stem_fwd", 126), ("stem_fwd_res", 132),
                               ("stem_dw", 141)):
                kernels[name] = dict(
                    source="hnd_ghnd_tpu_torch/csrc/stem.cu",
                    replaces=f"hnd_ghnd_tpu/ops/pallas_stem.py:{line}",
                    max_abs_err=errs[name][0], **times[name][0],
                    plain_ms=times[name][1],
                    library_ms=dw_ms if name == "stem_dw" else conv_ms,
                    **bounds[name])


def distill_models(device: torch.device):
    """The seeded ResNet-50 teacher with live BNs, and the b3ch student with
    its stem and layer2-4 copied from the teacher (the reference's
    pretrained + frozen_modules setup), its class logits spread as in
    ``serving_model`` for the per-epoch eval."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    teacher = live_norms_(get_model(TEACHER_MODEL, seed=SEED, device=device),
                          SEED)
    student = live_norms_(get_model(STUDENT_MODEL, seed=SEED + 1,
                                    device=device), SEED + 1)
    shared = ("backbone.body.conv1.", "backbone.body.bn1.",
              "backbone.body.layer2.", "backbone.body.layer3.",
              "backbone.body.layer4.")
    student.load_state_dict({k: v for k, v in teacher.state_dict().items()
                             if k.startswith(shared)}, strict=False)
    with torch.no_grad():
        student.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    return teacher, student


def distill_batches(rng: np.random.RandomState, device: torch.device):
    """float32 batches in [0, 1] padded into their bucket like the loader's,
    STEPS_PER_BUCKET on each bucket, then the first batch again."""
    out = []
    for bh, bw in BUCKETS:
        for _ in range(STEPS_PER_BUCKET):
            images = np.zeros((TRAIN_BATCH, bh, bw, 3), np.float32)
            for i in range(TRAIN_BATCH):
                h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
                w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
                images[i, :h, :w] = rng.rand(h, w, 3)
            out.append({"images": torch.from_numpy(images).to(device)})
    return out + [out[0]]


def distill_phase(dev: torch.device, eval_batch: dict):
    """mimic_runner.distill with the stem switch on, then the same steps
    from the same start with it off.  Returns (teacher, student at its
    start, the stem kernels' launches in the switched-on run)."""
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    from hnd_ghnd_tpu_torch.runners.mimic_runner import distill
    from hnd_ghnd_tpu_torch.utils.params import updatable_param_names
    teacher, student = distill_models(dev)
    start = copy.deepcopy(student.state_dict())
    trainable = set(updatable_param_names(student))
    frozen = [n for n, _ in student.named_parameters() if n not in trainable]
    batches = distill_batches(np.random.RandomState(SEED + 2), dev)
    n = len(batches)
    config = {"train": dict(TRAIN, num_epochs=1),
              "student_model": STUDENT_MODEL,
              "tpu": {"compute_dtype": COMPUTE_DTYPE}}
    counters = {"stem_fwd": SK.stem_fwd, "stem_fwd_res": SK.stem_fwd_res,
                "stem_dw": SK.stem_dw, "quantize": QK.quantize,
                "dequantize": QK.dequantize, "roi_align": RK.roi_align}
    runs = {}
    for switch in ("1", "0"):
        os.environ["HND_TPU_PALLAS_STEM"] = switch
        student.load_state_dict(start)
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        # the -transform_bottleneck run: the eval round-trips the
        # bottleneck through the quantizer kernels
        hist = distill(teacher, student, config, batches,
                       [eval_batch] if switch == "1" else [], n,
                       use_bottleneck_transformer=True)
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tag = "on" if switch == "1" else "off"
        n_eval = sum(len(e) for e in hist["evals"])
        log(f"[distill] switch {tag}: {n} steps + {n_eval} eval batch(es) "
            f"in {wall:.3f} s; launches {launches}; peak memory "
            f"{peak:.2f} GiB")
        for idx, loss, terms, ms in hist["steps"]:
            shape = tuple(batches[idx]["images"].shape)
            log(f"[distill] switch {tag} step {idx} {shape}: {ms:.3f} ms, "
                f"loss {loss:.6e}, terms "
                + " ".join(f"{k} {v:.6e}" for k, v in terms.items()))
        runs[tag] = (hist, launches)
        if switch == "1":
            after = student.state_dict()
            for name in frozen:
                check(torch.equal(after[name], start[name]),
                      f"frozen {name} changed")
            for name in trainable:
                check(not torch.equal(after[name], start[name]),
                      f"trainable {name} did not move")
            stats = [k for k in start if k.startswith("backbone.body.layer1.")
                     and k.endswith(("running_mean", "running_var"))]
            check(len(stats) == 16 and all(
                not torch.equal(after[k], start[k]) for k in stats),
                "a bottleneck BN's running statistics did not change")
            log(f"[distill] {len(frozen)} frozen parameters bit-identical, "
                f"{len(trainable)} trainable ones moved (backbone.body.bn1."
                "weight among them), 16 bottleneck BN statistics changed")
            check(launches["stem_fwd_res"] == n and launches["stem_dw"] == n,
                  "a student stem kernel did not launch once per step")
            check(launches["stem_fwd"] == n + 1,
                  "the teacher's stem kernel did not launch once per step "
                  "and once in the eval")
            for k in ("quantize", "dequantize", "roi_align"):
                check(launches[k] == 1, f"{k} did not launch in the eval")
            (rec,) = hist["evals"][0]
            dets = rec["dets"]
            check(dets["boxes"].shape == (EVAL_BATCH, 100, 4)
                  and bool(np.isfinite(dets["boxes"]).all())
                  and bool(np.isfinite(dets["scores"]).all()), "eval output")
            log(f"[distill] eval of batch {tuple(eval_batch['images'].shape)}:"
                f" {rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
        else:
            check(all(launches[k] == 0 for k in
                      ("stem_fwd", "stem_fwd_res", "stem_dw")),
                  "a stem kernel launched with the switch off")
    losses = {tag: [loss for _, loss, _, _ in runs[tag][0]["steps"]]
              for tag in runs}
    on, off = losses["on"], losses["off"]
    check(all(np.isfinite(on)) and all(np.isfinite(off)), "non-finite loss")
    check(on[-1] < on[0], f"loss did not fall on the repeated batch: {on}")
    for i, (a, b) in enumerate(zip(on, off)):
        rel = abs(a - b) / abs(a)
        tol = LOSS_TOL_FIRST if i == 0 else LOSS_TOL_LATER
        check(rel <= tol, f"step {i}: switch on/off losses {a} {b} ({rel})")
    log(f"[distill] losses switch on vs off within {LOSS_TOL_FIRST} (step 0) "
        f"and {LOSS_TOL_LATER}: max rel "
        f"{max(abs(a - b) / abs(a) for a, b in zip(on, off)):.2e}")
    # step times per bucket, leaving out each bucket's first step (cuDNN's
    # first calls at a new shape)
    for tag in runs:
        steps = runs[tag][0]["steps"]
        for bi, bucket in enumerate(BUCKETS):
            first = bi * STEPS_PER_BUCKET
            ms = [s[3] for s in steps
                  if tuple(batches[s[0]]["images"].shape[1:3]) == bucket
                  and s[0] != first]
            log(f"[distill] switch {tag} bucket {bucket}: median step "
                f"{statistics.median(ms):.3f} ms over {len(ms)} steps "
                f"({TRAIN_BATCH / statistics.median(ms) * 1e3:.2f} img/s)")
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    student.load_state_dict(start)
    return teacher, student, runs["on"][1]


def distill_cpu_phase(dev: torch.device, teacher, student) -> None:
    """One distill step (stem switch on) on the card in float32 against the
    same step on the CPU in float64: terms, every trainable gradient, the
    new bottleneck BN statistics."""
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.models.factory import build_model
    images = torch.from_numpy(np.random.RandomState(SEED + 3).rand(
        1, *CPU_SHAPE, 3).astype(np.float32))
    # the CPU's copies first: the card's step moves the running statistics
    cpu = []
    for model, cfg in ((teacher, TEACHER_MODEL), (student, STUDENT_MODEL)):
        m = build_model(cfg)
        m.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        cpu.append(m.double())
    out = {}
    for where in ("gpu", "cpu"):
        if where == "gpu":
            t, s, x = teacher, student, images.to(dev)
        else:
            (t, s), x = cpu, images.double()
        t.eval()
        s.train()
        s.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        _, terms = DistillationBox(t, s, TRAIN["criterion"]).loss(x)
        sum(terms.values()).backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in s.named_parameters() if p.requires_grad}
        stats = {k: v.double().cpu() for k, v in s.state_dict().items()
                 if k.startswith("backbone.body.layer1.")
                 and k.endswith(("running_mean", "running_var"))}
        out[where] = ({k: float(v.detach()) for k, v in terms.items()},
                      grads, stats)
        log(f"[distill-cpu] {where}: one step at {tuple(x.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
    (t_g, g_g, s_g), (t_c, g_c, s_c) = out["gpu"], out["cpu"]
    worst = 0.0
    for k in t_c:
        rel = abs(t_g[k] - t_c[k]) / abs(t_c[k])
        worst = max(worst, rel)
        check(rel <= CPU_TERM_TOL, f"term {k}: card {t_g[k]} cpu {t_c[k]}")
    log(f"[distill-cpu] terms within {CPU_TERM_TOL}: max rel {worst:.2e}")
    rels = {}
    for name, c in g_c.items():
        # a BN bias followed by an unpadded conv and a train-mode BN has a
        # zero gradient (the next BN removes it): both give float noise
        # there, held against the BN weight's gradient
        ref = g_c[name[:-len("bias")] + "weight"] if name in (
            "backbone.body.layer1.decoder.3.bias",
            "backbone.body.layer1.decoder.8.bias") else c
        scale = float(ref.abs().max())
        if ref is not c:
            check(float(g_g[name].abs().max()) <= CPU_TERM_TOL * scale,
                  f"{name}: not ~0")
            continue
        rels[name] = float((g_g[name] - c).abs().max()) / scale
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[distill-cpu] {len(g_c)} gradients, largest errors (x their max): "
        + ", ".join(f"{n} {r:.2e}" for n, r in top))
    check(top[0][1] <= CPU_GRAD_TOL, f"gradient {top[0][0]}: {top[0][1]} of "
          f"its max > {CPU_GRAD_TOL}")
    worst = max(float((s_g[k] - v).abs().max() / v.abs().max())
                for k, v in s_c.items())
    check(worst <= CPU_STATS_TOL, f"running statistics: {worst}")
    log(f"[distill-cpu] {len(s_c)} running statistics within {CPU_STATS_TOL}:"
        f" worst {worst:.2e}")


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def roi_train_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The bf16 RoIAlign forward and the RoIAlign backward (f32 and bf16
    levels) against their plain versions at the train step's shapes: P2-P5
    of one batch-2 832x1344 bucket, 512 RoIs per image, 7x7 bins, C=256."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, w = BUCKETS[0]
    rng = np.random.RandomState(SEED + 5)
    boxes = torch.from_numpy(box_mix(rng, ORG_BATCH, TRAIN_ROIS, h, w)).to(dev)
    # sel_on: a few slots unsampled, as when an image has too few candidates
    valid = torch.from_numpy(rng.rand(ORG_BATCH, TRAIN_ROIS) > 0.05).to(dev)
    n_valid = int(valid.sum())
    size = (h, w)
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        levels = [torch.randn((ORG_BATCH, h // s, w // s, 256), generator=gen,
                              device=dev).to(dtype) for s in (4, 8, 16, 32)]
        cot = torch.randn((ORG_BATCH, TRAIN_ROIS, 7, 7, 256), generator=gen,
                          device=dev).to(dtype)
        shapes = [tuple(f.shape[1:3]) for f in levels]
        _, level, weight = RK.checked_inputs(levels, boxes, valid)
        got = RK.roi_align(levels, boxes, size, 7, 2, valid)
        want = multiscale_roi_align_batch(levels, boxes, size, 7, 2, valid)
        fwd_err = float((got.float() - want.float()).abs().max())
        log(f"[roi-train] forward {tag} {tuple(got.shape)}: max abs err "
            f"{fwd_err} (bit-identical: {torch.equal(got, want)})")
        if dtype == torch.bfloat16:
            # the kernel rounds the plain version's float32 bin once
            check(torch.equal(got, want), "roi_align bf16 is not "
                  "bit-identical to its plain version")
        ref = [f.clone().requires_grad_(True) for f in levels]
        plain_out = multiscale_roi_align_batch(ref, boxes, size, 7, 2, valid)
        plain = torch.autograd.grad(plain_out, ref, cot, retain_graph=True)
        got_g = RK.roi_align_backward(cot, shapes, dtype, boxes, level,
                                      weight, size, 2)
        again = RK.roi_align_backward(cot, shapes, dtype, boxes, level,
                                      weight, size, 2)
        torch.cuda.synchronize()
        top = max(float(g.float().abs().max()) for g in plain)
        bwd_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got_g, plain))
        # float atomics add in another order than the plain scatter:
        # 1e-5 of the largest gradient (f32), one bf16 ulp of it (bf16)
        tol = ROI_TOL * top if dtype == torch.float32 else bf16_ulp(top)
        same = all(torch.equal(a, b) for a, b in zip(got_g, again))
        log(f"[roi-train] backward {tag}: max abs err {bwd_err:.3e} (largest "
            f"|plain grad| {top:.3e}, bound {tol:.3e}); two runs "
            f"{'agree' if same else 'differ'} bit for bit (float atomics: "
            "the order of the adds is not fixed)")
        check(bwd_err <= tol, f"roi_align_bwd {tag}: {bwd_err} > {tol}")
        bwd_t = timings(lambda: RK.roi_align_backward(
            cot, shapes, dtype, boxes, level, weight, size, 2))
        plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
            plain_out, ref, cot, retain_graph=True))
        # 2 x 2 samples of 4 taps, a multiply and an add each, and the
        # validity weight, per (valid RoI, bin, channel)
        n_ops = 33.0 * n_valid * 49 * 256
        fwd_bound = dict(
            bound(nbytes(*levels, boxes, valid, got), n_ops),
            tapped_bound_ms=bound(tapped_bytes(levels, boxes, valid, size, 7)
                                  + nbytes(boxes, valid, got),
                                  n_ops)["bound_ms"])
        bwd_bound = bound(nbytes(cot, boxes, valid, *got_g), n_ops)
        fwd_t = timings(lambda: RK.roi_align(levels, boxes, size, 7, 2,
                                             valid))
        plain_fwd_ms = time_ms(lambda: multiscale_roi_align_batch(
            levels, boxes, size, 7, 2, valid))
        log(f"[roi-train] forward {tag}: {fwd_t['ms']:.4f} ms kernel "
            f"({fwd_t['device_ms']:.4f} on the card), {plain_fwd_ms:.4f} ms "
            f"plain; backward {bwd_t['ms']:.4f} ms kernel "
            f"({bwd_t['device_ms']:.4f} on the card), {plain_bwd_ms:.4f} ms "
            f"plain autograd (median of {REPS}); bounds "
            f"{fwd_bound['bound_ms']:.4f} (tapped cells "
            f"{fwd_bound['tapped_bound_ms']:.4f}) / "
            f"{bwd_bound['bound_ms']:.4f} ms by {fwd_bound['bound_by']}")
        # no single PyTorch call computes either function (no torchvision)
        if dtype == torch.bfloat16:
            kernels["roi_align_bf16"] = dict(
                source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
                replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231",
                max_abs_err=fwd_err, **fwd_t, plain_ms=plain_fwd_ms,
                library_ms=None, **fwd_bound)
            kernels["roi_align_bwd"] = dict(
                source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
                replaces="hnd_ghnd_tpu/ops/pallas_roi.py:446",
                max_abs_err=bwd_err, **bwd_t, plain_ms=plain_bwd_ms,
                library_ms=None, **bwd_bound)
        del levels, cot, got, want, ref, plain_out, plain, got_g, again
    torch.cuda.empty_cache()


def int8_kernels_phase(dev: torch.device, kernels: dict) -> None:
    """The level quantizer and the int8 RoIAlign against their plain
    versions at the eval's shapes: P2-P5 of a batch-8 832x1344 bucket
    (C=256, NCHW maps as the FPN gives them), 8x1000 RoIs at 7x7 (the box
    head) and 8x100 at 14x14 (the mask and keypoint heads); the int8 pool
    against the f32 pool of the same float levels; the f32 kernel at
    14x14; and what the int8 box pool with its quantize costs against the
    f32 box pool with its NHWC copy."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import (assign_levels,
                                                  multiscale_roi_align_batch,
                                                  quantize_fpn_levels)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    h, w = BUCKETS[0]
    size = (h, w)
    # levels of different ranges; the last image's lower half is padding
    nchw = []
    for i, s in enumerate((4, 8, 16, 32)):
        f = torch.randn((EVAL_BATCH, 256, h // s, w // s), generator=gen,
                        device=dev) * (1.0 + i)
        f[-1, :, h // s // 2:] = 0.0
        nchw.append(f)
    views = [f.permute(0, 2, 3, 1) for f in nchw]
    nhwc = [v.contiguous() for v in views]
    codes, scales = RK.quantize_levels(views)
    plain_q, plain_s = quantize_fpn_levels(views)
    cpu_q, cpu_s = quantize_fpn_levels([v.cpu() for v in nhwc])
    again_q, again_s = RK.quantize_levels(nhwc)
    for what, (q, s) in (("plain on the card", (plain_q, plain_s)),
                         ("the CPU", (cpu_q, cpu_s)),
                         ("the NHWC route", (again_q, again_s))):
        check(torch.equal(scales.cpu(), s.cpu())
              and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(codes, q)),
              f"quantize_levels codes or scales differ from {what}")
    log(f"[kernels] quantize_levels P2-P5 of {tuple(views[0].shape)}: codes "
        f"and scales bit-exact vs plain (card and CPU), from NCHW and NHWC; "
        f"scales {[float(v) for v in scales]}")
    del cpu_q, again_q, plain_q
    tables = (codes, scales)
    rng = np.random.RandomState(SEED + 9)
    for n, pool in ((1000, 7), (100, 14)):
        boxes = torch.from_numpy(box_mix(rng, EVAL_BATCH, n, h, w)).to(dev)
        valid = torch.from_numpy(rng.rand(EVAL_BATCH, n) > 0.3).to(dev)
        got = RK.roi_align(views, boxes, size, pool, 2, valid, quant=tables)
        want = multiscale_roi_align_batch(views, boxes, size, pool, 2, valid,
                                          quant=tables)
        err = float((got - want).abs().max())
        log(f"[kernels] roi_align_int8 {tuple(got.shape)}: max abs err {err} "
            f"(bit-identical: {torch.equal(got, want)})")
        # the plain float32 program, the same operations in the same order
        check(torch.equal(got, want), f"roi_align_int8 at {pool}x{pool} is "
              "not bit-identical to its plain version")
        # each bin is a mean (weights summing to at most 1) of values within
        # half a step of their floats: half its level's step, plus rounding
        f32 = RK.roi_align(nhwc, boxes, size, pool, 2, valid)
        step = scales[assign_levels(boxes.reshape(-1, 4)).long()]
        gap = (got - f32).abs().reshape(EVAL_BATCH * n, -1).max(1).values
        limit = 0.5 * step + ROI_TOL * float(f32.abs().max())
        check(bool((gap <= limit).all()), "the int8 pool is farther than "
              "half a quantization step from the f32 pool")
        log(f"[kernels] int8 vs f32 pool {pool}x{pool}: largest gap "
            f"{float(gap.max()):.4e}, {float((gap / limit).max()):.3f} of "
            f"its half step + rounding")
        if pool == 14:
            plain = multiscale_roi_align_batch(nhwc, boxes, size, 14, 2, valid)
            e14 = float((f32 - plain).abs().max())
            log(f"[kernels] roi_align f32 {tuple(f32.shape)}: max abs err "
                f"{e14} (max |plain| {float(plain.abs().max())}, bound "
                f"{ROI_TOL} x max)")
            check(e14 <= ROI_TOL * float(plain.abs().max()),
                  f"roi_align f32 at 14x14: {e14}")
            # the heads' pooling: kernel, plain version and bounds (whole
            # levels and tapped cells) per table
            n_ops = 33.0 * int(valid.sum()) * 196 * 256
            for tag, kernel, plain, levels, rest in (
                    ("f32", lambda: RK.roi_align(nhwc, boxes, size, 14, 2,
                                                 valid),
                     lambda: multiscale_roi_align_batch(nhwc, boxes, size, 14,
                                                        2, valid),
                     nhwc, nbytes(boxes, valid, f32)),
                    ("int8", lambda: RK.roi_align(views, boxes, size, 14, 2,
                                                  valid, quant=tables),
                     lambda: multiscale_roi_align_batch(
                         views, boxes, size, 14, 2, valid, quant=tables),
                     codes, nbytes(scales, boxes, valid, got))):
                t, plain_ms = timings(kernel), time_ms(plain)
                b14 = bound(nbytes(*levels) + rest, n_ops)
                tapped = bound(tapped_bytes(levels, boxes, valid, size, 14)
                               + rest, n_ops)["bound_ms"]
                log(f"[kernels] roi_align {tag} 8x100 RoIs at 14x14: "
                    f"{t['ms']:.4f} ms kernel ({t['device_ms']:.4f} on the "
                    f"card), {plain_ms:.4f} ms plain (median of {REPS}); "
                    f"bound {b14['bound_ms']:.4f} ms by {b14['bound_by']}, "
                    f"{b14['bound_ms'] / t['ms']:.1%} of it; tapped cells "
                    f"{tapped:.4f} ms, {tapped / t['device_ms']:.1%} of the "
                    "card's time")
            continue
        n_valid = int(valid.sum())
        kernels["roi_align_int8"] = dict(
            source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
            replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231", max_abs_err=err,
            **timings(lambda: RK.roi_align(views, boxes, size, 7, 2, valid,
                                           quant=tables)),
            plain_ms=time_ms(lambda: multiscale_roi_align_batch(
                views, boxes, size, 7, 2, valid, quant=tables)),
            library_ms=None,
            **bound(nbytes(*codes, scales, boxes, valid, got),
                    33.0 * n_valid * 49 * 256),
            tapped_bound_ms=bound(tapped_bytes(codes, boxes, valid, size, 7)
                                  + nbytes(scales, boxes, valid, got),
                                  33.0 * n_valid * 49 * 256)["bound_ms"])
        # the box pool from the FPN's NCHW maps, both ways
        f32_way = time_ms(lambda: RK.roi_align(
            [v.contiguous() for v in views], boxes, size, 7, 2, valid))
        int8_way = time_ms(lambda: RK.roi_align(
            views, boxes, size, 7, 2, valid, quant=RK.quantize_levels(views)))
        log(f"[kernels] box pool 8x1000 7x7 from NCHW P2-P5: f32 (NHWC copy "
            f"+ pool) {f32_way:.4f} ms, int8 (quantize + pool) {int8_way:.4f} "
            f"ms (median of {REPS})")
    # abs, max, divide, round and two clamps per element
    n_el = sum(f.numel() for f in views)
    kernels["quantize_levels"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/fpn_quant.cu",
        replaces="hnd_ghnd_tpu/ops/roi_align.py:201", max_abs_err=0.0,
        **timings(lambda: RK.quantize_levels(views)),
        plain_ms=time_ms(lambda: quantize_fpn_levels(views)), library_ms=None,
        **bound(nbytes(*views, *codes, scales), 6.0 * n_el))
    del nchw, views, nhwc, codes, tables, got, want, f32
    torch.cuda.empty_cache()


def heads_phase(dev: torch.device, serving, fpn_cpu, props, pvalid,
                one: dict, served: list) -> dict:
    """The GHND b3ch Mask and Keypoint R-CNN students (the serving model's
    trunk, FPN and RPN, their own seeded heads, live BNs, class logits x300)
    serve ``served`` through ``runners.common.evaluate`` with int8_roi_pool
    off, then on; then card against CPU at batch 1 with the switch on, on
    the CPU's FPN maps and proposals (``fpn_cpu``, ``props``, ``pvalid`` of
    ``one``) and the CPU's detections.  Returns the kernels' launches in
    the switched-on runs."""
    from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.runners.common import evaluate
    shared = {k: v for k, v in serving.state_dict().items()
              if k.startswith(("backbone.", "rpn."))}
    n = len(served)
    total = {"roi_align_int8": 0, "quantize_levels": 0}
    for cfg, head in ((MASK_STUDENT_MODEL, "mask_probs"),
                      (KEYPOINT_STUDENT_MODEL, "keypoint_logits")):
        kind = cfg["name"]
        off = live_norms_(get_model(cfg, seed=SEED, device=dev), SEED)
        off.load_state_dict(shared, strict=False)
        off.roi_heads.box_predictor.cls_score.weight.data.mul_(300.0)
        on_cfg = dict(cfg, params=dict(cfg["params"], int8_roi_pool=True))
        on = build_model(on_cfg)
        on.load_state_dict(off.state_dict())
        models = {"off": off.requires_grad_(False),
                  "on": on.to(dev).requires_grad_(False)}
        dets = {}
        for tag, model in models.items():
            QK.quantize.launches = QK.dequantize.launches = 0
            RK.roi_align.launches = RK.roi_align.launches_int8 = 0
            RK.quantize_levels.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            records = evaluate(model, served, use_bottleneck_transformer=True)
            wall = time.perf_counter() - t0
            got = {"quantize": QK.quantize.launches,
                   "dequantize": QK.dequantize.launches,
                   "roi_align": RK.roi_align.launches,
                   "roi_align_int8": RK.roi_align.launches_int8,
                   "quantize_levels": RK.quantize_levels.launches}
            want = ({"quantize": n, "dequantize": n, "roi_align": 2 * n,
                     "roi_align_int8": 0, "quantize_levels": 0}
                    if tag == "off" else
                    {"quantize": n, "dequantize": n, "roi_align": 0,
                     "roi_align_int8": 2 * n, "quantize_levels": n})
            log(f"[heads] {kind} int8 {tag}: {n} batches in {wall:.3f} s; "
                f"launches {got}; peak memory "
                f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
            check(got == want, f"{kind} int8 {tag}: launches {got}, want "
                  f"{want}")
            if tag == "on":
                for k in total:
                    total[k] += got[k]
            for i, (batch, rec) in enumerate(zip(served, records)):
                b = batch["images"].shape[0]
                out = rec["dets"][head]
                shape = ((b, 100, 28, 28) if head == "mask_probs"
                         else (b, 100, 56, 56, 17))
                check(out.shape == shape, f"{kind} {head} shape {out.shape}")
                check(bool(np.isfinite(out).all()), f"{kind} non-finite {head}")
                if head == "mask_probs":
                    check(bool(((out >= 0) & (out <= 1)).all()),
                          "mask_probs outside [0, 1]")
                check(bool(np.isfinite(rec["dets"]["boxes"]).all()),
                      "non-finite boxes")
                log(f"[heads] {kind} int8 {tag} batch {i} "
                    f"{tuple(batch['images'].shape)}: {rec['ms']:.2f} ms, "
                    f"{int(rec['dets']['valid'].sum())} detections")
            dets[tag] = [r["dets"] for r in records[-3:]]
        # how many of the f32 tables' detections the int8 tables keep
        kept = total_f32 = 0
        for a, b in zip(dets["off"], dets["on"]):
            for i in range(a["valid"].shape[0]):
                for j in np.flatnonzero(a["valid"][i]):
                    total_f32 += 1
                    kept += bool((b["valid"][i]
                                  & (b["labels"][i] == a["labels"][i, j])
                                  & (np.abs(b["boxes"][i] - a["boxes"][i, j])
                                     .max(1) < 0.5)).any())
        log(f"[heads] {kind}: the int8 forward shares {kept} of the f32 "
            f"forward's {total_f32} detections (label, box within 0.5 px)")
        # card vs CPU, switch on: the CPU's maps, proposals and detections
        cpu = build_model(on_cfg).requires_grad_(False)
        cpu.load_state_dict({k: v.cpu() for k, v in off.state_dict().items()})
        shape_ = BUCKETS[0]
        sizes = torch.from_numpy(one["image_sizes"])
        t0 = time.perf_counter()
        with torch.no_grad():
            det_c = cpu.roi_heads.infer(fpn_cpu, props, pvalid, sizes, shape_)
        cpu_s = time.perf_counter() - t0
        on_gpu = [f.to(dev) for f in fpn_cpu]
        with torch.no_grad():
            tables = on.roi_heads.pool_tables(on_gpu, True)
            cpu_tables = cpu.roi_heads.pool_tables(fpn_cpu, True)
            check(torch.equal(tables[1][1].cpu(), cpu_tables[1][1])
                  and all(torch.equal(a.cpu(), b) for a, b in
                          zip(tables[1][0], cpu_tables[1][0])),
                  "the card's int8 tables differ from the CPU's")
            out_g = on.roi_heads.head_outputs(
                tables, det_c["boxes"].to(dev), det_c["valid"].to(dev),
                det_c["labels"].to(dev), shape_)
        e = rel_err(out_g[head], det_c[head])
        log(f"[heads] {kind} card vs CPU (int8 tables, the CPU's "
            f"{int(det_c['valid'].sum())} detections): {head} rel err "
            f"{e:.2e} (CPU heads forward {cpu_s:.2f} s)")
        check(e <= STAGE_TOL, f"{kind} {head} card vs CPU: {e}")
        del off, on, models, cpu, on_gpu, tables, out_g
        torch.cuda.empty_cache()
    return total


def org_targets(rng: np.random.RandomState, sizes: np.ndarray):
    """1-8 GT boxes per image inside its valid size, labels 1-90, padded to
    MAX_GT with ``boxes_valid``, like the JAX loader's targets."""
    b = len(sizes)
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    labels = np.zeros((b, MAX_GT), np.int64)
    valid = np.zeros((b, MAX_GT), bool)
    for i, (h, w) in enumerate(sizes):
        g = rng.randint(1, 9)
        bw = rng.uniform(16, 0.6 * w, g)
        bh = rng.uniform(16, 0.6 * h, g)
        x1 = rng.uniform(0, w - bw)
        y1 = rng.uniform(0, h - bh)
        boxes[i, :g] = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
        labels[i, :g] = rng.randint(1, 91, g)
        valid[i, :g] = True
    return {"boxes": boxes, "labels": labels, "boxes_valid": valid}


def org_batch(rng: np.random.RandomState, bucket, b: int):
    """(batch, targets): float32 images in [0, 1] padded into the bucket."""
    bh, bw = bucket
    images = np.zeros((b, bh, bw, 3), np.float32)
    sizes = np.zeros((b, 2), np.int32)
    for i in range(b):
        h = bh if i % 2 == 0 else int(bh * rng.uniform(0.6, 1.0))
        w = bw if i % 3 == 0 else int(bw * rng.uniform(0.6, 1.0))
        images[i, :h, :w] = rng.rand(h, w, 3)
        sizes[i] = (h, w)
    batch = {"images": images, "image_sizes": sizes,
             "original_sizes": np.round(sizes * 0.75).astype(np.int32)}
    return batch, org_targets(rng, sizes)


def train_phase(dev: torch.device, eval_batch: dict) -> dict:
    """coco_runner.train of the org model in bfloat16: batch 2, 3 steps on
    each bucket and the first batch again, then the float32 eval of a
    batch-8 serving batch.  Returns the kernels' launches in that run."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.runners.coco_runner import train
    from hnd_ghnd_tpu_torch.utils.params import updatable_param_names
    model = live_norms_(get_model(ORG_MODEL, seed=SEED + 6, device=dev),
                        SEED + 6)
    start = copy.deepcopy(model.state_dict())
    trainable = set(updatable_param_names(model))
    frozen = [n for n, _ in model.named_parameters() if n not in trainable]
    rng = np.random.RandomState(SEED + 7)
    batches = [org_batch(rng, bucket, ORG_BATCH) for bucket in BUCKETS
               for _ in range(STEPS_PER_BUCKET)]
    batches.append(batches[0])
    n = len(batches)
    config = {"model": ORG_MODEL, "train": dict(ORG_TRAIN, num_epochs=1),
              "tpu": ORG_TPU}
    RK.roi_align.launches = RK.roi_align.launches_bf16 = 0
    RK.roi_align_backward.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    hist = train(model, config, batches, [eval_batch], n, seed=SEED)
    wall = time.perf_counter() - t0
    launches = {"roi_align": RK.roi_align.launches,
                "roi_align_bf16": RK.roi_align.launches_bf16,
                "roi_align_bwd": RK.roi_align_backward.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"[train] {n} bf16 steps + 1 float32 eval batch in {wall:.3f} s; "
        f"launches {launches}; peak memory {peak:.2f} GiB")
    for idx, loss, terms, ms in hist["steps"]:
        shape = tuple(batches[idx][0]["images"].shape)
        check(all(np.isfinite(v) for v in terms.values()),
              f"step {idx}: a non-finite loss term {terms}")
        log(f"[train] step {idx} {shape}: {ms:.3f} ms, loss {loss:.6e}, "
            + " ".join(f"{k} {v:.6e}" for k, v in terms.items()))
    check(len(hist["steps"]) == n, "a step's scalars are missing")
    check(launches["roi_align_bf16"] == n and launches["roi_align_bwd"] == n,
          "the bf16 RoIAlign forward and backward did not launch once per "
          "step")
    check(launches["roi_align"] == 1, "the f32 RoIAlign did not launch once "
          "in the float32 eval")
    after = model.state_dict()
    for name in frozen:
        check(torch.equal(after[name], start[name]), f"frozen {name} changed")
    for name in trainable:
        check(not torch.equal(after[name], start[name]),
              f"trainable {name} did not move")
    check(all(n.startswith(("backbone.body.conv1.", "backbone.body.bn1.",
                            "backbone.body.layer1.")) for n in frozen)
          and len(frozen) > 0, "freeze_layers froze something else")
    log(f"[train] {len(frozen)} frozen parameters (conv1, bn1, layer1) "
        f"bit-identical, {len(trainable)} trainable ones moved")
    (rec,) = hist["evals"][0]
    dets = rec["dets"]
    check(dets["boxes"].shape == (EVAL_BATCH, 100, 4)
          and bool(np.isfinite(dets["boxes"]).all())
          and bool(np.isfinite(dets["scores"]).all()), "eval output")
    log(f"[train] float32 eval of batch {tuple(eval_batch['images'].shape)}:"
        f" {rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
    for bi, bucket in enumerate(BUCKETS):
        first = bi * STEPS_PER_BUCKET
        ms = [s[3] for s in hist["steps"]
              if tuple(batches[s[0]][0]["images"].shape[1:3]) == bucket
              and s[0] != first]
        log(f"[train] bucket {bucket}: median step "
            f"{statistics.median(ms):.3f} ms over {len(ms)} steps "
            f"({ORG_BATCH / statistics.median(ms) * 1e3:.2f} img/s)")
    return launches


def train_cpu_phase(dev: torch.device) -> None:
    """One supervised float32 step (TF32 off) on the card against the same
    step on the CPU in float64, at batch 1 on a quarter of the 832x1344
    bucket.  Top-k, NMS and sampling are discrete: the CPU's RoI samples
    and the same RPN draws go to both sides."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    model = live_norms_(get_model(ORG_MODEL, seed=SEED + 8, device="cpu"),
                        SEED + 8)
    rng = np.random.RandomState(SEED + 8)
    batch, targets = org_batch(rng, CPU_SHAPE, 1)
    recorded = []  # the CPU's draws, replayed on the card

    def record(shape):
        r = torch.from_numpy(rng.rand(*shape).astype(np.float32))
        recorded.append(r)
        return r

    out, sampled = {}, None
    n_bwd = RK.roi_align_backward.launches
    for where in ("cpu", "gpu"):
        if where == "cpu":
            m, d, dtype = model.double(), torch.device("cpu"), torch.float64
            draw = record
        else:
            m, d, dtype = model.float().to(dev), dev, torch.float32
            replay = iter(list(recorded))
            draw = lambda shape: next(replay).to(dev)  # noqa: E731
        m.train().zero_grad(set_to_none=True)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        t = {k: torch.from_numpy(v).to(d) for k, v in targets.items()}
        t["boxes"] = t["boxes"].to(dtype)
        t0 = time.perf_counter()
        images = images_to_compute(b["images"], dtype)
        _, feats = m.backbone_features(images)
        props, pvalid, raw = m.rpn.propose(feats, b["image_sizes"], CPU_SHAPE,
                                           training=True)
        losses = m.rpn.loss(raw, t, draw)
        if sampled is None:
            sampled = m.roi_heads.select_training_samples(props, pvalid, t,
                                                          record)
        s = tuple(x.to(d, dtype) if x.is_floating_point() else x.to(d)
                  for x in sampled)
        losses.update(m.roi_heads.loss(feats, CPU_SHAPE, s))
        sum(losses.values()).backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in m.named_parameters()
                 if n.startswith(("roi_heads.", "backbone.fpn."))}
        out[where] = ({k: float(v.detach()) for k, v in losses.items()}, grads)
        log(f"[train-cpu] {where}: one step at {tuple(images.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
    check(RK.roi_align_backward.launches == n_bwd + 1,
          "the card's step did not run the backward kernel")
    (t_g, g_g), (t_c, g_c) = out["gpu"], out["cpu"]
    worst = max(abs(t_g[k] - t_c[k]) / abs(t_c[k]) for k in t_c)
    log("[train-cpu] terms card / cpu: " + ", ".join(
        f"{k} {t_g[k]:.8e} / {t_c[k]:.8e}" for k in t_c)
        + f"; max rel {worst:.2e}")
    check(worst <= TRAIN_TERM_TOL, f"terms: {worst} > {TRAIN_TERM_TOL}")
    rels = {n: float((g_g[n] - c).abs().max() / c.abs().max())
            for n, c in g_c.items()}
    top = sorted(rels.items(), key=lambda kv: -kv[1])[:4]
    log(f"[train-cpu] {len(g_c)} gradients of the RoI heads and the FPN, "
        "largest errors (x their max): "
        + ", ".join(f"{n} {r:.2e}" for n, r in top))
    for name, rel in rels.items():
        tol = (TRAIN_HEAD_GRAD_TOL if name.startswith("roi_heads.")
               else TRAIN_FPN_GRAD_TOL)
        check(rel <= tol, f"gradient {name}: {rel} of its max > {tol}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.codec.quantizer import (dequantize_tensor,
                                                    quantize_tensor)
    from hnd_ghnd_tpu_torch.models.factory import build_model
    from hnd_ghnd_tpu_torch.models.rcnn import RCNN
    from hnd_ghnd_tpu_torch.ops import nms as nms_ops
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    from hnd_ghnd_tpu_torch.runners.common import (configure_precision,
                                                   eval_forward, evaluate)

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    # ---------------------------------------------------------- 1. setup
    log(f"[setup] card: {card}")
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    present = {m: importlib.util.find_spec(m) is not None
               for m in ("jax", "yaml", "PIL", "cv2", "triton")}
    log(f"[setup] installed (not imported): {present}")

    # ---------------------------------------------------------- 2. build
    lib = _build.load()
    log(f"[build] {_build.build_info['seconds']:.1f} s "
        f"(cached={_build.build_info['cached']}) {_build.build_info['path']}")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build] {line.strip()}")
    check(lib is not None, "kernel library did not load")

    # ---------------------------------------------------------- 3. kernels
    # float32 with TF32 off everywhere, the plain versions included
    configure_precision(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = {}
    # the bottleneck tensor of the serving path (+4 from the k2/p1 convs),
    # as NHWC, as its channels_last NCHW view, and a size that is not a
    # multiple of the vector width or the block
    z = torch.from_numpy(quant_input(SEED, (EVAL_BATCH, 212, 340, 3))).to(dev)
    cases = [("nhwc", z), ("channels_last", z.permute(0, 3, 1, 2)),
             ("odd", torch.from_numpy(quant_input(SEED + 1, (3, 101, 77, 5)))
              .to(dev))]
    for name, x in cases:
        q = QK.quantize(x, 8)
        ref = quantize_tensor(x, 8)
        cpu = quantize_tensor(x.cpu(), 8)
        check(torch.equal(q.tensor, ref.tensor), f"quantize codes ({name})")
        check(torch.equal(q.tensor.cpu(), cpu.tensor), f"codes vs CPU ({name})")
        for a, b in ((q.scale, ref.scale), (q.zero_point, ref.zero_point),
                     (q.scale.cpu(), cpu.scale),
                     (q.zero_point.cpu(), cpu.zero_point)):
            check(torch.equal(a, b), f"scale/zero point ({name})")
        d = QK.dequantize(q)
        check(torch.equal(d, dequantize_tensor(ref)), f"dequantize ({name})")
        log(f"[kernels] quantize/dequantize {name} {tuple(x.shape)}: "
            "bit-exact vs plain (card and CPU)")
    q = QK.quantize(z, 8)
    # no single PyTorch call computes the quantizer or RoIAlign: no library
    # time.  Operations per element: min, max, divide, add, 2 clamps and a
    # round to quantize; subtract and multiply to dequantize.
    kernels["quantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:46",
        max_abs_err=float((q.tensor.int() - quantize_tensor(z, 8).tensor.int())
                          .abs().max()),
        **timings(lambda: QK.quantize(z, 8)),
        plain_ms=time_ms(lambda: quantize_tensor(z, 8)), library_ms=None,
        **bound(nbytes(z, q.tensor), 7.0 * z.numel()))
    kernels["dequantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:61",
        max_abs_err=float((QK.dequantize(q) - dequantize_tensor(q))
                          .abs().max()),
        **timings(lambda: QK.dequantize(q)),
        plain_ms=time_ms(lambda: dequantize_tensor(q)), library_ms=None,
        **bound(nbytes(q.tensor, z), 2.0 * z.numel()))

    h, w = BUCKETS[0]
    levels = [torch.randn((EVAL_BATCH, h // s, w // s, 256), generator=gen,
                          device=dev) for s in (4, 8, 16, 32)]
    rng = np.random.RandomState(SEED)
    boxes = torch.from_numpy(box_mix(rng, EVAL_BATCH, 1000, h, w)).to(dev)
    valid = torch.from_numpy(rng.rand(EVAL_BATCH, 1000) > 0.3).to(dev)
    got = RK.roi_align(levels, boxes, (h, w), 7, 2, valid)
    want = multiscale_roi_align_batch(levels, boxes, (h, w), 7, 2, valid)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"[kernels] roi_align {tuple(got.shape)}: max abs err {err} "
        f"(max |plain| {scale}, bound {ROI_TOL} x max)")
    check(err <= ROI_TOL * scale, f"roi_align err {err} > {ROI_TOL} x {scale}")
    # each valid RoI's output element: 2 x 2 samples of 4 bilinear taps
    # (a multiply and an add each) and the average
    n_valid = int(valid.sum())
    kernels["roi_align"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231", max_abs_err=err,
        **timings(lambda: RK.roi_align(levels, boxes, (h, w), 7, 2, valid)),
        plain_ms=time_ms(lambda: multiscale_roi_align_batch(
            levels, boxes, (h, w), 7, 2, valid)), library_ms=None,
        **bound(nbytes(*levels, boxes, valid, got),
                33.0 * n_valid * 49 * levels[0].shape[-1]),
        tapped_bound_ms=bound(tapped_bytes(levels, boxes, valid, (h, w), 7)
                              + nbytes(boxes, valid, got),
                              33.0 * n_valid * 49 * levels[0].shape[-1]
                              )["bound_ms"])
    # what the NHWC hand-over costs from the served NCHW maps, and from
    # channels_last ones
    nchw = [f.permute(0, 3, 1, 2).contiguous() for f in levels]
    copy_ms = time_ms(lambda: [f.permute(0, 2, 3, 1).contiguous()
                               for f in nchw])
    cl = [f.permute(0, 3, 1, 2) for f in levels]
    free_ms = time_ms(lambda: [f.permute(0, 2, 3, 1).contiguous()
                               for f in cl])
    log(f"[kernels] NHWC hand-over of P2-P5 (B=8): {copy_ms:.3f} ms from "
        f"NCHW, {free_ms:.3f} ms from channels_last")
    del levels, nchw, cl, got, want, z, q
    stem_kernels_phase(dev, kernels)
    roi_train_kernels_phase(dev, kernels)
    int8_kernels_phase(dev, kernels)
    for name, k in kernels.items():
        lib = "" if k["library_ms"] is None else \
            f", {k['library_ms']:.4f} ms library"
        tapped = "" if "tapped_bound_ms" not in k else \
            f"; tapped cells {k['tapped_bound_ms']:.4f} ms, " \
            f"{k['tapped_bound_ms'] / k['device_ms']:.1%} of the card's time"
        log(f"[kernels] {name}: {k['ms']:.4f} ms kernel "
            f"({k['device_ms']:.4f} on the card), {k['plain_ms']:.4f} ms "
            f"plain{lib} (median of {REPS}); bound {k['bound_ms']:.4f} ms by "
            f"{k['bound_by']}, {k['bound_ms'] / k['ms']:.1%} of it{tapped}")

    # ---------------------------------------------------------- 4. serving
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the serving path's default
    model = serving_model(dev)
    batches = serving_batches(np.random.RandomState(SEED + 1))
    served = batches * 2  # the first pass includes cuDNN's first calls
    QK.quantize.launches = QK.dequantize.launches = RK.roi_align.launches = 0
    nms_ops.fixpoint.iterations = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    records = evaluate(model, served, use_bottleneck_transformer=True)
    wall = time.perf_counter() - t0
    launches = {"quantize": QK.quantize.launches,
                "dequantize": QK.dequantize.launches,
                "roi_align": RK.roi_align.launches}
    log(f"[slice] {len(served)} batches in {wall:.3f} s; launches {launches}; "
        f"NMS fixpoint syncs {nms_ops.fixpoint.iterations}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for name, n in launches.items():
        check(n == len(served), f"{name} launched {n} times for "
              f"{len(served)} forwards")
    for i, (batch, rec) in enumerate(zip(served, records)):
        b = batch["images"].shape[0]
        dets = rec["dets"]
        check(dets["boxes"].shape == (b, 100, 4), "boxes shape")
        for key in ("scores", "labels", "valid"):
            check(dets[key].shape == (b, 100), f"{key} shape")
        for key in ("boxes", "boxes_model", "scores"):
            check(bool(np.isfinite(dets[key]).all()), f"non-finite {key}")
        log(f"[slice] batch {i} {tuple(batch['images'].shape)}: "
            f"{rec['ms']:.2f} ms, {int(dets['valid'].sum())} detections")
    _, fpn = model.backbone_features(
        torch.from_numpy(batches[2]["images"]).to(dev).float() / 255.0, True)
    log(f"[slice] P2 contiguous NCHW: {fpn[0].is_contiguous()}")

    # ---------------------------------------------------------- 5. card vs CPU
    cpu_model = build_model(STUDENT_MODEL).requires_grad_(False)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    one = batches[2]
    images = torch.from_numpy(one["images"]).float() * torch.tensor(1.0 / 255.0)
    body = {"cpu": cpu_model.backbone.body, "gpu": model.backbone.body}
    x = {"cpu": RCNN.normalize(images), "gpu": RCNN.normalize(images.to(dev))}
    z = {k: b.layer1.encoder(b.stem(x[k])) for k, b in body.items()}
    check(rel_err(z["gpu"], z["cpu"]) <= STAGE_TOL, "encoder output")
    q_cpu = quantize_tensor(z["cpu"], 8)
    flips = (QK.quantize(z["gpu"], 8).tensor.cpu().int()
             - q_cpu.tensor.int()).abs()
    log(f"[cpu] encoder rel err {rel_err(z['gpu'], z['cpu']):.2e}; "
        f"codes differing from the CPU: {int((flips > 0).sum())} of "
        f"{flips.numel()} (max {int(flips.max())} level)")
    check(int(flips.max()) <= 1, "a code moved by more than one level")
    # rounding is a discrete step: both sides decode the CPU's codes
    zq = dequantize_tensor(q_cpu)
    fpn = {}
    for k, b in body.items():
        y = b.layer1.decoder(zq if k == "cpu" else zq.to(dev))
        feats = [y]
        for stage in (2, 3, 4):
            feats.append(getattr(b, f"layer{stage}")(feats[-1]))
        m = cpu_model if k == "cpu" else model
        fpn[k] = m.backbone.fpn(feats)
    for i, (g, c) in enumerate(zip(fpn["gpu"], fpn["cpu"])):
        e = rel_err(g, c)
        log(f"[cpu] P{i + 2} rel err {e:.2e}")
        check(e <= STAGE_TOL, f"FPN P{i + 2}")
    on_gpu = [f.to(dev) for f in fpn["cpu"]]
    heads = {"cpu": cpu_model.rpn.head(fpn["cpu"]), "gpu": model.rpn.head(on_gpu)}
    for j, what in enumerate(("objectness", "deltas")):
        for lv, (g, c) in enumerate(zip(heads["gpu"][j], heads["cpu"][j])):
            e = rel_err(g, c)
            check(e <= STAGE_TOL, f"RPN {what} P{lv + 2}: {e}")
    log("[cpu] RPN head outputs within tolerance on every level")
    shape = BUCKETS[0]
    sizes = torch.from_numpy(one["image_sizes"])
    props, pvalid, _ = cpu_model.rpn.propose(fpn["cpu"], sizes, shape)
    # the CPU's proposals go to both sides (top-k and NMS are discrete)
    lc = cpu_model.roi_heads.box_logits(fpn["cpu"], props, pvalid, shape)
    lg = model.roi_heads.box_logits(on_gpu, props.to(dev), pvalid.to(dev), shape)
    for what, g, c in zip(("class logits", "box deltas"), lg, lc):
        e = rel_err(g, c)
        log(f"[cpu] box head {what} rel err {e:.2e}")
        check(e <= STAGE_TOL, f"box head {what}")
    det_c = eval_forward(cpu_model, {k: torch.from_numpy(v) for k, v in
                                     one.items()}, True)
    det_g = records[-1]["dets"]
    vc = det_c["valid"][0].numpy()
    matched = 0
    for j in np.flatnonzero(vc):
        same = ((det_g["labels"][0] == int(det_c["labels"][0, j]))
                & (np.abs(det_g["boxes"][0] - det_c["boxes"][0, j].numpy())
                   .max(1) < 0.5)
                & det_g["valid"][0])
        matched += bool(same.any())
    log(f"[cpu] final detections: {matched} of {int(vc.sum())} CPU detections "
        f"found on the card (label and box within 0.5 px); card has "
        f"{int(det_g['valid'][0].sum())}")

    del cpu_model, on_gpu, heads, body, x, z
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 5b. heads
    launches.update(heads_phase(dev, model, fpn["cpu"], props, pvalid, one,
                                served))
    del model, fpn
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 6. distill
    teacher, student, stem_launches = distill_phase(dev, batches[0])
    launches.update({k: stem_launches[k] for k in
                     ("stem_fwd", "stem_fwd_res", "stem_dw")})

    # ---------------------------------------------------------- 7. card vs CPU
    distill_cpu_phase(dev, teacher, student)
    del teacher, student
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 8. training
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the stem kernels are f32 only
    train_launches = train_phase(dev, batches[0])
    launches.update({k: train_launches[k] for k in
                     ("roi_align_bf16", "roi_align_bwd")})

    # ---------------------------------------------------------- 9. card vs CPU
    train_cpu_phase(dev)

    # ---------------------------------------------------------- result
    out = [dict(name=name, route="cuda", launches=launches[name], **k)
           for name, k in kernels.items()]
    for k in out:
        check(k["launches"] > 0, f"{k['name']} never launched on its path")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
