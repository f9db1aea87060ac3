"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of hnd_ghnd_tpu_torch/csrc from the checkout, holds
each against its plain PyTorch version on the card, serves seeded batches
through the GHND b3ch Faster R-CNN student at full width (batch 8 at
832x1344 and 1344x832, batch 1 at 832x1344) with random weights and BN
statistics from a seed, checks that every kernel of that path ran, and
compares the card with the CPU on the batch-1 input.  Any failed check
raises.

The last line of stdout is {"ok": true, "device": {...}}; the line before
it lists each kernel's route, launches, error and time.  Without a GPU, or
without the package beside it, the script exits nonzero and prints no
result.  It imports nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# student_model of config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml,
# spelled out because yaml may be missing where this runs
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
COMPUTE_DTYPE = "float32"      # tpu.compute_dtype of the same config
BUCKETS = ((832, 1344), (1344, 832))
EVAL_BATCH = 8                 # tpu.eval_batch_size
SEED = 0
# fp32 with TF32 off on both sides: only summation order differs (cuDNN vs
# the CPU's convolutions over up to 4608-term dot products through ~60
# layers), so each stage agrees to 1e-4 of its largest magnitude
STAGE_TOL = 1e-4
ROI_TOL = 1e-5                 # RoIAlign: identical arithmetic, order only
REPS = 25                      # timed runs per kernel; the median is kept


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
    return model


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
    kernels["quantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:46",
        max_abs_err=float((q.tensor.int() - quantize_tensor(z, 8).tensor.int())
                          .abs().max()),
        ms=time_ms(lambda: QK.quantize(z, 8)),
        plain_ms=time_ms(lambda: quantize_tensor(z, 8)))
    kernels["dequantize"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/quant.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_quant.py:61",
        max_abs_err=float((QK.dequantize(q) - dequantize_tensor(q))
                          .abs().max()),
        ms=time_ms(lambda: QK.dequantize(q)),
        plain_ms=time_ms(lambda: dequantize_tensor(q)))

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
    kernels["roi_align"] = dict(
        source="hnd_ghnd_tpu_torch/csrc/roi_align.cu",
        replaces="hnd_ghnd_tpu/ops/pallas_roi.py:231", max_abs_err=err,
        ms=time_ms(lambda: RK.roi_align(levels, boxes, (h, w), 7, 2, valid)),
        plain_ms=time_ms(lambda: multiscale_roi_align_batch(
            levels, boxes, (h, w), 7, 2, valid)))
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
    for name, k in kernels.items():
        log(f"[kernels] {name}: {k['ms']:.4f} ms kernel, "
            f"{k['plain_ms']:.4f} ms plain (median of {REPS})")
    del levels, nchw, cl, got, want, z, q

    # ---------------------------------------------------------- 4. slice
    configure_precision(COMPUTE_DTYPE)
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
    cpu_model = build_model(STUDENT_MODEL)
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

    # ---------------------------------------------------------- result
    out = [dict(name=name, route="cuda", launches=launches[name], **k)
           for name, k in kernels.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
