"""Where the port's serving forward spends its time on one NVIDIA GPU.

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
     kernels, and the idle share 1 - (device busy time / latency);
  4. a layout A/B: the trunk in contiguous NCHW (as served) against a
     channels_last trunk, interleaved (nchw, cl, cl, nchw), at batch 8
     and batch 1.

Prints one line per result and, last, one JSON object holding them all.
Needs one CUDA device; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (BUCKETS, COMPUTE_DTYPE, EVAL_BATCH, SEED,
                        gpu_name_and_power, serving_batches, serving_model)

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
              lambda: RCNN.normalize(images_to_compute(batch["images"])))
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
    props, pvalid = stage("RPN propose (with head)",
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
    from hnd_ghnd_tpu_torch.ops import nms as nms_ops
    from hnd_ghnd_tpu_torch.runners.common import eval_forward
    before = nms_ops.fixpoint.iterations
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eval_forward(model, batch, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    return len(syncs), nms_ops.fixpoint.iterations - before


def _group(name: str) -> str:
    low = name.lower()
    if "nchwtonhwc" in low or "nhwctonchw" in low or "transpose" in low:
        return "layout transposes"
    if "roi_align" in low or "quantize" in low:
        return "port kernels (K1-K3)"
    if "memcpy" in low or "memset" in low:
        return "copies and memsets"
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


def device_profile(model, batch):
    from torch.profiler import ProfilerActivity, profile

    from hnd_ghnd_tpu_torch.runners.common import eval_forward

    def forwards():
        for _ in range(FORWARDS):
            eval_forward(model, batch, True)

    _, wall = synced_ms(forwards, 3)
    latency = wall / FORWARDS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forwards()
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
    out.update(
        busy_ms_per_forward=busy,
        idle_share=1.0 - busy / latency,
        kernel_ms_per_forward=sum(groups.values()) / 1e3 / FORWARDS,
        launches_per_forward=len(device) / FORWARDS,
        groups_ms={g: v / 1e3 / FORWARDS for g, v in
                   sorted(groups.items(), key=lambda kv: -kv[1])},
        top_kernels=[{"name": k[:120], "calls": n / FORWARDS,
                      "ms": v / 1e3 / FORWARDS}
                     for k, (n, v) in sorted(kernels.items(),
                                             key=lambda kv: -kv[1][1])
                     [:TOP_KERNELS]])
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    from hnd_ghnd_tpu_torch.runners.common import (configure_precision,
                                                   eval_forward)

    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"[setup] card: {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    configure_precision(COMPUTE_DTYPE)
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
    result["profile"] = device_profile(model, b8)
    prof = result["profile"]
    log(f"[profile] latency {prof['latency_ms']:.3f} ms per forward "
        f"(unprofiled, {FORWARDS} forwards)")
    if "groups_ms" in prof:
        log(f"[profile] device busy {prof['busy_ms_per_forward']:.3f} ms, "
            f"kernel sum {prof['kernel_ms_per_forward']:.3f} ms, "
            f"{prof['launches_per_forward']:.0f} device events per forward; "
            f"idle share {prof['idle_share']:.4f}")
        for g, ms in prof["groups_ms"].items():
            log(f"[profile] {g}: {ms:.3f} ms")
        for k in prof["top_kernels"]:
            log(f"[profile] top {k['ms']:.3f} ms x{k['calls']:.0f} "
                f"{k['name']}")
    result["layout_ab"] = layout_ab(model, {"batch8": b8, "batch1": b1})
    for label, r in result["layout_ab"].items():
        log(f"[layout] {label}: " + ", ".join(
            f"{k} {r[k]['median_ms']:.3f} ms ({r[k]['min_ms']:.3f}-"
            f"{r[k]['max_ms']:.3f})" for k in ("nchw", "channels_last"))
            + f"; identical detections {r['identical_detections']}")
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
