"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of hnd_ghnd_tpu_torch/csrc from the checkout and
holds each against its plain PyTorch version on the card.  Then the two
paths, at full width with random weights and BN statistics from a seed:

  * serving: seeded batches through the GHND b3ch Faster R-CNN student
    (batch 8 at 832x1344 and 1344x832, batch 1 at 832x1344), compared with
    the CPU on the batch-1 input;
  * distillation: ``mimic_runner.distill`` of the student from the ResNet-50
    teacher, batch 4 on both buckets, with the fused stem switched on
    (HND_TPU_PALLAS_STEM=1), then its per-epoch eval on a batch-8 serving
    batch; the same steps again with the switch off (cuDNN's stem); one
    step compared with a float64 step on the CPU.

Each path checks that every kernel it runs was launched.  Any failed check
raises.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists each kernel's route, launches, error, time and bound.  Without a
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


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median of REPS CUDA-event timings of ``fn`` after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    step's shapes (batch 4 on both buckets) and on a ragged shape (33 x 50
    outputs: a partial tile in each direction), timed at 832x1344."""
    import torch.nn.functional as F
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(TRAIN_BATCH, 3) + BUCKETS[0], (TRAIN_BATCH, 3) + BUCKETS[1],
              (2, 3, 66, 100)]
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
        if shape != shapes[2]:
            times = {
                "stem_fwd": (time_ms(lambda: SK.stem_fwd(x, w, scale, bias)),
                             time_ms(lambda: ts.stem_forward(x, w, scale,
                                                             bias))),
                "stem_fwd_res": (
                    time_ms(lambda: SK.stem_fwd_res(x, w, scale, bias)),
                    time_ms(lambda: ts.stem_forward(x, w, scale, bias,
                                                    with_conv=True))),
                "stem_dw": (time_ms(lambda: SK.stem_dw(x, g)),
                            time_ms(lambda: ts.stem_weight_grad(x, g))),
            }
            # one PyTorch call each: the conv alone (no affine, no ReLU)
            # for the forwards, conv2d_weight for dW
            conv_ms = time_ms(lambda: F.conv2d(x, w, stride=2, padding=3))
            dw_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x, w.shape, g, stride=2, padding=3))
            for name, (k_ms, p_ms) in times.items():
                lib = dw_ms if name == "stem_dw" else conv_ms
                log(f"[stem] {name} {shape}: {k_ms:.4f} ms kernel, {p_ms:.4f} "
                    f"ms plain, {lib:.4f} ms library (median of {REPS})")
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
                    max_abs_err=errs[name][0], ms=times[name][0],
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
        hist = distill(teacher, student, config, batches,
                       [eval_batch] if switch == "1" else [], n)
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
    configure_precision(COMPUTE_DTYPE)
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
        ms=time_ms(lambda: QK.quantize(z, 8)),
        plain_ms=time_ms(lambda: quantize_tensor(z, 8)), library_ms=None,
        **bound(nbytes(z, q.tensor), 7.0 * z.numel()))
    kernels["dequantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:61",
        max_abs_err=float((QK.dequantize(q) - dequantize_tensor(q))
                          .abs().max()),
        ms=time_ms(lambda: QK.dequantize(q)),
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
        ms=time_ms(lambda: RK.roi_align(levels, boxes, (h, w), 7, 2, valid)),
        plain_ms=time_ms(lambda: multiscale_roi_align_batch(
            levels, boxes, (h, w), 7, 2, valid)), library_ms=None,
        **bound(nbytes(*levels, boxes, valid, got),
                33.0 * n_valid * 49 * levels[0].shape[-1]))
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
    for name, k in kernels.items():
        lib = "" if k["library_ms"] is None else \
            f", {k['library_ms']:.4f} ms library"
        log(f"[kernels] {name}: {k['ms']:.4f} ms kernel, "
            f"{k['plain_ms']:.4f} ms plain{lib} (median of {REPS}); bound "
            f"{k['bound_ms']:.4f} ms by {k['bound_by']}")

    # ---------------------------------------------------------- 4. serving
    os.environ["HND_TPU_PALLAS_STEM"] = "0"  # the serving path's default
    model = serving_model(dev)
    batches = serving_batches(np.random.RandomState(SEED + 1))
    served = batches * 2  # the first pass includes cuDNN's first calls
    QK.quantize.launches = QK.dequantize.launches = RK.roi_align.launches = 0
    nms_ops.fixpoint.iterations = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    records = evaluate(model, served, use_bottleneck_transformer=True,
                       compute_dtype=COMPUTE_DTYPE)
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
    props, pvalid = cpu_model.rpn.propose(fpn["cpu"], sizes, shape)
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

    del model, cpu_model, fpn, on_gpu, heads, body, x, z
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 6. distill
    teacher, student, stem_launches = distill_phase(dev, batches[0])
    launches.update({k: stem_launches[k] for k in
                     ("stem_fwd", "stem_fwd_res", "stem_dw")})

    # ---------------------------------------------------------- 7. card vs CPU
    distill_cpu_phase(dev, teacher, student)

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
