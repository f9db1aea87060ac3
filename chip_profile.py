"""Where the port's serving forward and distill step spend their time on
one NVIDIA GPU.

    python3 chip_profile.py [--out chiprun_out/chip_profile.json]

Serves the model of chip_smoke.py (the GHND b3ch Faster R-CNN student at
full width, seeded weights with live BNs, float32 with TF32 off) at batch 8
in the 832x1344 bucket and measures:

  1. stage times: each stage of the eval forward on the host clock with a
     device sync on either side, median of REPEATS;
  2. host syncs per forward, counted by torch.cuda.set_sync_debug_mode,
     and the NMS fixpoint's share of them;
  3. the forward's latency unprofiled, then a torch.profiler trace of as
     many forwards: device time by kernel group (cuDNN convolutions, GEMMs,
     layout transposes, the port's kernels, copies, the rest), the top
     kernels, and the idle share 1 - (device busy time / latency); the
     same, and the host syncs, for the split deployment's server tail
     (split/deploy.py ``tail_fn``) at batch 8, where the checkout has it;
  4. a layout A/B: the trunk in contiguous NCHW (as served) against a
     channels_last trunk, interleaved (nchw, cl, cl, nchw), at batch 8
     and batch 1.

Then the GHND distill step of chip_smoke.py (teacher and student, batch 4
at 832x1344, the fused stem switched on): its stages between device syncs
(teacher forward, student forward and loss, backward, Adam update), the
same unprofiled-latency / profiler breakdown per step with the stem
kernels' device time and their share of the step's kernel time, the
same breakdown with the switch off (cuDNN's stem), and the step with the
stem switch on against off, interleaved (on, off, off, on).

Last, the supervised bfloat16 step of the org Faster R-CNN (chip_smoke.py's
training phase, batch 2 at 832x1344): its stages between device syncs
(trunk and FPN, RPN proposals, RPN loss, RoI sampling, RoI loss, backward,
SGD update), host syncs per step, and the same profiler breakdown.

    python3 chip_profile.py --int8 [--out ...]

profiles only the int8 server tail's trunk (split/int8.py) at batch 8 on
832x1344: the serving student calibrated as chip_smoke.py's int8 phase
calibrates it, one wire, and the trunk up to the NCHW float32 stage
features the FPN reads.  Its latency (CUDA events), then a profiler trace:
device time by kernel name and by aten op and input shapes (which tells
the border-map add, the dequantized features and the NCHW copies from the
other elementwise passes).  It needs only ``Int8SplitTail.trunk`` (and
``trunk_nchw`` where the package has it), so the same script profiles an
older checkout when run from that checkout's root.

    python3 chip_profile.py --distill-bf16 [--out ...]

profiles only the distill step above computed in bfloat16, where the
stem switch runs the stem kernels on bf16 activations (the bf16 dW on the
tensor cores): its stages, the profiler breakdown with the switch on (each
stem kernel's device ms, the idle share) and off, and the switch A/B in
turns.

Prints one line per result and, last, one JSON object holding them all.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (BUCKETS, EVAL_BATCH, ORG_BATCH, ORG_MODEL, ORG_TRAIN,
                        SEED, TRAIN, distill_batches, distill_models,
                        gpu_name_and_power, live_norms_, org_batch,
                        serving_batches, serving_model)

REPEATS = 5      # stage timings and A/B runs per side and order
FORWARDS = 3     # forwards per latency / profiler window
TOP_KERNELS = 12


def log(msg: str) -> None:
    print(msg, flush=True)


def synced_ms(fn, reps: int = REPEATS):
    """(last result, median ms) of ``fn`` between two device syncs."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, statistics.median(times)


def on_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def stage_times(model, batch):
    """Median ms of each stage of RCNN.forward, fed the previous stage's
    output.  The RPN's and RoI heads' own work is their total less the
    parts timed on their own."""
    from hnd_ghnd_tpu_torch.codec.quantizer import roundtrip
    from hnd_ghnd_tpu_torch.models.rcnn import RCNN
    from hnd_ghnd_tpu_torch.ops.roi_align_kernels import roi_align
    from hnd_ghnd_tpu_torch.runners.common import images_to_compute

    body = model.backbone.body
    heads = model.roi_heads
    shape = tuple(batch["images"].shape[1:3])
    sizes = batch["image_sizes"]
    t = {}

    def stage(name, fn):
        out, t[name] = synced_ms(fn)
        return out

    x = stage("uint8 -> float, normalize",
              lambda: RCNN.normalize(images_to_compute(batch["images"],
                                                       torch.float32)))
    y = stage("stem", lambda: body.stem(x))
    z = stage("encoder", lambda: body.layer1.encoder(y))
    zq = stage("quantize + dequantize (K1+K2)",
               lambda: roundtrip(z, body.layer1.quant_bits))
    feats = [stage("decoder", lambda: body.layer1.decoder(zq))]
    for i in (2, 3, 4):
        layer = getattr(body, f"layer{i}")
        feats.append(stage(f"layer{i}", lambda: layer(feats[-1])))
    fpn = stage("FPN", lambda: model.backbone.fpn(feats))
    stage("RPN head convs", lambda: model.rpn.head(fpn))
    props, pvalid, _ = stage("RPN propose (with head)",
                             lambda: model.rpn.propose(fpn, sizes, shape))
    levels = stage("NHWC hand-over of P2-P5",
                   lambda: [f.permute(0, 2, 3, 1).contiguous()
                            for f in fpn[:4]])
    pooled = stage("RoIAlign (K3)", lambda: roi_align(
        levels, props, shape, 7, boxes_valid=pvalid))
    stage("fc6/fc7 + predictor", lambda: heads.box_predictor(heads.box_head(
        pooled.reshape((-1,) + pooled.shape[2:]))))
    stage("RoI heads infer (all)",
          lambda: heads.infer(fpn, props, pvalid, sizes, shape))
    t["RPN proposals (propose - head)"] = (t["RPN propose (with head)"]
                                           - t["RPN head convs"])
    t["class postprocess + NMS (infer - pool - head)"] = (
        t["RoI heads infer (all)"] - t["NHWC hand-over of P2-P5"]
        - t["RoIAlign (K3)"] - t["fc6/fc7 + predictor"])
    return t


def count_syncs(model, batch):
    """Synchronizing CUDA calls in one forward, and the NMS fixpoint's."""
    from hnd_ghnd_tpu_torch.runners.common import eval_forward
    return syncs_of(lambda: eval_forward(model, batch, True))


def syncs_of(fn):
    """Synchronizing CUDA calls in one call of ``fn``, and the NMS
    fixpoint's (its host checks)."""
    from hnd_ghnd_tpu_torch.ops import nms as nms_ops
    before = nms_ops.fixpoint.iterations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    return len(syncs), nms_ops.fixpoint.iterations - before


def split_tail_profile(model, batch):
    """The split deployment's server tail (split/deploy.py ``tail_fn``) at
    the batch's size, on the wire of the eager head: host syncs per tail,
    and the latency / profiler breakdown per tail."""
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN
    split = SplitRCNN(model, 8)
    bucket = tuple(batch["images"].shape[1:3])
    q, scale, zp, _ = split.head_fn(batch["images"])

    def tail():
        return split.tail_fn(q, scale, zp, batch["image_sizes"], bucket)

    syncs, nms_syncs = syncs_of(tail)
    return {"host_syncs_per_tail": syncs,
            "nms_fixpoint_syncs_per_tail": nms_syncs,
            "profile": device_profile(tail, "tail")}


def _group(name: str) -> str:
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transposes"
    if "roi_align" in low or "quantize" in low or "stem_" in low \
            or "nms_" in low:
        return "port kernels"
    if "memcpy" in low or "memset" in low:
        return "copies and memsets"
    if "dgrad" in low or "wgrad" in low:
        return "cuDNN convolution backward"
    if "conv" in low or "xmma" in low or "fft" in low or "implicit" in low \
            or "winograd" in low:
        return "cuDNN convolutions"
    if "gemm" in low:
        return "GEMMs"
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    busy, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def device_profile(unit_fn, unit: str = "forward"):
    """Latency of ``unit_fn`` (one forward or step) unprofiled, then a
    profiler trace of FORWARDS of them: per-unit device time by group."""
    from torch.profiler import ProfilerActivity, profile

    def units():
        for _ in range(FORWARDS):
            unit_fn()

    _, wall = synced_ms(units, 3)
    latency = wall / FORWARDS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        units()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"latency_ms": latency, "device_events": len(device)}
    if not device:
        log("[profile] the profiler recorded no device events; stage times "
            "above are the breakdown")
        return out
    groups, kernels = {}, {}
    for e in device:
        us = e.time_range.end - e.time_range.start
        g = _group(e.name)
        groups[g] = groups.get(g, 0.0) + us
        n, tot = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, tot + us)
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in device]) / 1e3 / FORWARDS
    out.update({
        f"busy_ms_per_{unit}": busy,
        "idle_share": 1.0 - busy / latency,
        f"kernel_ms_per_{unit}": sum(groups.values()) / 1e3 / FORWARDS,
        f"launches_per_{unit}": len(device) / FORWARDS})
    # the fused stem's kernels (under HND_TPU_PALLAS_STEM=1), by name
    out["stem_kernels_ms"] = {k: v / 1e3 / FORWARDS
                              for k, (_, v) in kernels.items() if "stem_" in k}
    out.update(
        groups_ms={g: v / 1e3 / FORWARDS for g, v in
                   sorted(groups.items(), key=lambda kv: -kv[1])},
        top_kernels=[{"name": k[:120], "calls": n / FORWARDS,
                      "ms": v / 1e3 / FORWARDS}
                     for k, (n, v) in sorted(kernels.items(),
                                             key=lambda kv: -kv[1][1])
                     [:TOP_KERNELS]])
    return out


def log_profile(prof, unit: str) -> None:
    log(f"[profile] latency {prof['latency_ms']:.3f} ms per {unit} "
        f"(unprofiled, {FORWARDS} {unit}s)")
    if "groups_ms" not in prof:
        return
    log(f"[profile] device busy {prof[f'busy_ms_per_{unit}']:.3f} ms, "
        f"kernel sum {prof[f'kernel_ms_per_{unit}']:.3f} ms, "
        f"{prof[f'launches_per_{unit}']:.0f} device events per {unit}; "
        f"idle share {prof['idle_share']:.4f}")
    for g, ms in prof["groups_ms"].items():
        log(f"[profile] {g}: {ms:.3f} ms")
    for k in prof["top_kernels"]:
        log(f"[profile] top {k['ms']:.3f} ms x{k['calls']:.0f} {k['name']}")


def distill_profile(dev, dtype: torch.dtype = torch.float32):
    """Stages, profiles (stem switch on, then off) and stem-switch A/B of
    one distill step computed in ``dtype``."""
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.parallel.train_step import make_distill_train_step
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    teacher, student = distill_models(dev)
    teacher.eval().requires_grad_(False)
    student.train()
    box = DistillationBox(teacher, student, TRAIN["criterion"])
    step = make_distill_train_step(box, TRAIN["optimizer"], TRAIN["scheduler"],
                                   1000, 999, compute_dtype=dtype)
    batch = distill_batches(np.random.RandomState(SEED + 2), dev)[0]
    images = batch["images"]
    for _ in range(2):  # cuDNN's first calls at this shape
        step(batch)
    out = {"batch": tuple(images.shape), "dtype": str(dtype)}

    def teacher_forward():
        with torch.no_grad():
            return box._features(teacher, images)

    def forward_backward():
        step.optimizer.zero_grad(set_to_none=True)
        loss, _ = box.loss(images)
        loss.backward()

    t = {}
    _, t["teacher forward"] = synced_ms(teacher_forward)
    _, fwd = synced_ms(lambda: box.loss(images))
    t["student forward + loss"] = fwd - t["teacher forward"]
    _, fwd_bwd = synced_ms(forward_backward)
    t["student backward"] = fwd_bwd - fwd
    _, t["Adam update"] = synced_ms(step.optimizer.step)
    _, t["whole step"] = synced_ms(lambda: step(batch))
    out["stages_ms"] = t
    out["profile"] = device_profile(lambda: step(batch), "step")
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    step(batch)  # cuDNN's first calls at this shape
    out["profile_off"] = device_profile(lambda: step(batch), "step")
    runs = {"on": [], "off": []}
    for tag in ("on", "off", "off", "on"):
        os.environ["HND_TPU_PALLAS_STEM"] = "1" if tag == "on" else "0"
        step(batch)  # the first call after a switch
        for _ in range(REPEATS):
            runs[tag].append(synced_ms(lambda: step(batch), 1)[1])
    out["stem_switch_ab"] = {k: {"median_ms": statistics.median(v),
                                 "min_ms": min(v), "max_ms": max(v),
                                 "runs": len(v)} for k, v in runs.items()}
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    return out


def train_profile(dev):
    """Stages, host syncs and profile of one supervised bfloat16 step."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.parallel.train_step import (
        images_to_compute, make_detection_train_step, uniform_draw)
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    model = live_norms_(get_model(ORG_MODEL, seed=SEED + 6, device=dev),
                        SEED + 6).train()
    step = make_detection_train_step(model, ORG_TRAIN["optimizer"],
                                     ORG_TRAIN["scheduler"], 1000, 0,
                                     torch.bfloat16)
    batch, targets = org_batch(np.random.RandomState(SEED + 7), BUCKETS[0],
                               ORG_BATCH)
    batch, targets = on_device(batch, dev), on_device(targets, dev)
    for _ in range(2):  # cuDNN's first calls at this shape
        step(batch, targets)
    draw = uniform_draw(torch.Generator(device=dev).manual_seed(SEED))
    shape = BUCKETS[0]
    out = {"batch": tuple(batch["images"].shape)}
    t = {}

    def stage(name, fn):
        res, t[name] = synced_ms(fn)
        return res

    images = images_to_compute(batch["images"], torch.bfloat16)
    _, fpn = stage("trunk + FPN forward",
                   lambda: model.backbone_features(images))
    props, pvalid, raw = stage("RPN propose (head, top-k, NMS)",
                               lambda: model.rpn.propose(
                                   fpn, batch["image_sizes"], shape, True))
    stage("RPN loss (match, sample)",
          lambda: model.rpn.loss(raw, targets, draw))
    sampled = stage("RoI sampling", lambda: model.roi_heads
                    .select_training_samples(props, pvalid, targets, draw))
    stage("RoI loss (RoIAlign, heads)",
          lambda: model.roi_heads.loss(fpn, shape, sampled))
    del fpn, props, pvalid, raw, sampled
    cast = dict(batch, images=images)
    _, fwd = synced_ms(lambda: model(cast, targets, draw))

    def forward_backward():
        step.optimizer.zero_grad(set_to_none=True)
        sum(model(cast, targets, draw).values()).backward()

    _, fwd_bwd = synced_ms(forward_backward)
    t["whole forward (losses)"] = fwd
    t["backward"] = fwd_bwd - fwd
    _, t["SGD update"] = synced_ms(step.optimizer.step)
    _, t["whole step"] = synced_ms(lambda: step(batch, targets))
    out["stages_ms"] = t
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step(batch, targets)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out["host_syncs_per_step"] = sum("synchroniz" in str(w.message).lower()
                                     for w in caught)
    out["profile"] = device_profile(lambda: step(batch, targets), "step")
    return out


def channels_last_variant(model):
    """The same weights with a channels_last trunk: conv weights and the
    stem's input in channels_last, so every map after it is too and the
    RoIAlign hand-over is free."""
    m = copy.deepcopy(model).to(memory_format=torch.channels_last)
    body = m.backbone.body
    stem = body.stem
    body.stem = lambda x: stem(x.contiguous(memory_format=torch.channels_last))
    return m


def layout_ab(model, batches):
    from hnd_ghnd_tpu_torch.runners.common import eval_forward
    variants = {"nchw": model, "channels_last": channels_last_variant(model)}
    out = {}
    for label, batch in batches.items():
        runs = {k: [] for k in variants}
        dets = {}
        for k in ("nchw", "channels_last", "channels_last", "nchw"):
            dets[k], _ = synced_ms(
                lambda: eval_forward(variants[k], batch, True), 1)
            for _ in range(REPEATS):
                runs[k].append(synced_ms(
                    lambda: eval_forward(variants[k], batch, True), 1)[1])
        same = all(torch.equal(dets["channels_last"][key], dets["nchw"][key])
                   for key in dets["nchw"])
        out[label] = {k: {"median_ms": statistics.median(v),
                          "min_ms": min(v), "max_ms": max(v), "runs": len(v)}
                      for k, v in runs.items()}
        out[label]["identical_detections"] = same
    return out


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def int8_trunk_profile(dev):
    """The int8 trunk at batch 8 on 832x1344, to the FPN's NCHW inputs:
    latency, device time by kernel name and by aten op and input shapes."""
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import INT8_CALIB_IMAGES
    from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.split import int8 as qi
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    model = serving_model(dev)
    served = serving_batches(np.random.RandomState(SEED + 50))[0]
    scales = qi.calibrate_from_images(
        model, [served["images"][i:i + 1] for i in range(INT8_CALIB_IMAGES)])
    tail = qi.Int8SplitTail(model, scales)
    q, scale, zp, _ = SplitRCNN(model, 8).head_fn(
        torch.from_numpy(served["images"]).to(dev))
    z = QK.dequantize(QuantizedTensor(q, scale, zp))
    if hasattr(tail, "trunk_nchw"):
        features = tail.trunk_nchw
    else:  # the int8 tail before the fused epilogue: NHWC features
        def features(x):
            return [f.permute(0, 3, 1, 2).contiguous() for f in tail.trunk(x)]

    def unit():
        with torch.no_grad():
            return features(z)

    for _ in range(3):
        unit()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        unit()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = {"batch": tuple(z.shape), "trunk_ms": statistics.median(times),
           "trunk_ms_runs": times}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(FORWARDS):
            unit()
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = {}
    for e in device:
        n, tot = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, tot + e.time_range.end - e.time_range.start)
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in device]) / 1e3 / FORWARDS
    out.update(busy_ms=busy, device_events=len(device) / FORWARDS,
               kernels=[{"name": k[:160], "calls": n / FORWARDS,
                         "ms": v / 1e3 / FORWARDS}
                        for k, (n, v) in sorted(kernels.items(),
                                                key=lambda kv: -kv[1][1])])
    ops = []
    for evt in prof.key_averages(group_by_input_shape=True):
        us = _self_device_us(evt)
        if us > 0 and evt.key.startswith("aten::"):
            ops.append({"op": evt.key, "shapes": str(evt.input_shapes)[:160],
                        "calls": evt.count / FORWARDS,
                        "ms": us / 1e3 / FORWARDS})
    out["aten_ops"] = sorted(ops, key=lambda o: -o["ms"])
    del model, tail, z
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    ap.add_argument("--int8", action="store_true",
                    help="profile only the int8 tail's trunk")
    ap.add_argument("--distill-bf16", action="store_true",
                    help="profile only the bfloat16 distill step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    if args.int8:
        from hnd_ghnd_tpu_torch.runners.common import configure_precision
        dev = torch.device("cuda", 0)
        card = gpu_name_and_power()
        log(f"[setup] card: {card}; torch {torch.__version__} "
            f"cuda {torch.version.cuda}")
        configure_precision(torch.float32)
        result = {"card": card, "int8_trunk": int8_trunk_profile(dev)}
        r = result["int8_trunk"]
        log(f"[int8] trunk {r['batch']}: {r['trunk_ms']:.3f} ms (CUDA "
            f"events, median of {REPEATS}); device busy {r['busy_ms']:.3f} "
            f"ms, {r['device_events']:.0f} device events per trunk")
        for k in r["kernels"][:TOP_KERNELS * 2]:
            log(f"[int8] kernel {k['ms']:.3f} ms x{k['calls']:.0f} "
                f"{k['name'][:110]}")
        for o in r["aten_ops"][:TOP_KERNELS * 3]:
            log(f"[int8] op {o['ms']:.3f} ms x{o['calls']:.0f} {o['op']} "
                f"{o['shapes'][:100]}")
        return emit(result, args.out)
    from hnd_ghnd_tpu_torch.runners.common import (configure_precision,
                                                   eval_forward)

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"[setup] card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    configure_precision(torch.float32)
    if args.distill_bf16:
        result = {"card": card,
                  "distill": distill_profile(dev, torch.bfloat16)}
        log_distill(result["distill"])
        return emit(result, args.out)
    model = serving_model(dev)
    all_batches = serving_batches(np.random.RandomState(SEED + 1))
    b8 = on_device(all_batches[0], dev)
    b1 = on_device(all_batches[2], dev)
    for _ in range(2):  # cuDNN's first calls and the kernel build
        eval_forward(model, b8, True)
        eval_forward(model, b1, True)
    torch.cuda.synchronize()

    result = {"card": card, "batch": EVAL_BATCH, "bucket": list(BUCKETS[0])}
    result["stages_ms"] = stage_times(model, b8)
    for name, ms in result["stages_ms"].items():
        log(f"[stages] {name}: {ms:.3f} ms")
    syncs, nms_syncs = count_syncs(model, b8)
    result["host_syncs_per_forward"] = syncs
    result["nms_fixpoint_syncs_per_forward"] = nms_syncs
    log(f"[syncs] {syncs} synchronizing calls per batch-8 forward, "
        f"{nms_syncs} of them NMS fixpoint checks")
    result["profile"] = device_profile(lambda: eval_forward(model, b8, True))
    log_profile(result["profile"], "forward")
    if importlib.util.find_spec("hnd_ghnd_tpu_torch.split.deploy"):
        st = result["split_tail"] = split_tail_profile(model, b8)
        log(f"[split tail] {st['host_syncs_per_tail']} synchronizing calls "
            f"per batch-8 tail, {st['nms_fixpoint_syncs_per_tail']} of them "
            "NMS fixpoint checks")
        log_profile(st["profile"], "tail")
    result["layout_ab"] = layout_ab(model, {"batch8": b8, "batch1": b1})
    for label, r in result["layout_ab"].items():
        log(f"[layout] {label}: " + ", ".join(
            f"{k} {r[k]['median_ms']:.3f} ms ({r[k]['min_ms']:.3f}-"
            f"{r[k]['max_ms']:.3f})" for k in ("nchw", "channels_last"))
            + f"; identical detections {r['identical_detections']}")
    del model, b8, b1
    torch.cuda.empty_cache()

    result["distill"] = distill_profile(dev)
    log_distill(result["distill"])
    torch.cuda.empty_cache()

    tr = result["train"] = train_profile(dev)
    for name, ms in tr["stages_ms"].items():
        log(f"[train] {name}: {ms:.3f} ms")
    log(f"[train] {tr['host_syncs_per_step']} synchronizing calls per step")
    log_profile(tr["profile"], "step")
    return emit(result, args.out)


def log_distill(d) -> None:
    for name, ms in d["stages_ms"].items():
        log(f"[distill] {name}: {ms:.3f} ms")
    for key, switch in (("profile", "on"), ("profile_off", "off")):
        log(f"[distill] {d['dtype']} step, stem switch {switch}:")
        log_profile(d[key], "step")
        stem = d[key].get("stem_kernels_ms", {})
        if stem:
            total = sum(stem.values())
            log(f"[distill] stem kernels {total:.4f} ms per step, "
                f"{total / d[key]['kernel_ms_per_step']:.4%} of the kernel "
                "time: " + ", ".join(f"{k[:60]} {v:.4f}"
                                     for k, v in stem.items()))
    log("[distill] stem switch: " + ", ".join(
        f"{k} {v['median_ms']:.3f} ms ({v['min_ms']:.3f}-{v['max_ms']:.3f})"
        for k, v in d["stem_switch_ab"].items()))


def emit(result: dict, out) -> int:
    """Prints ``result`` as the last line, and writes it to ``out``."""
    line = json.dumps(result)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
