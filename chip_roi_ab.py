"""The bottleneck quantizer pair, RoIAlign, level quantizer, stem kernels
and the int8 tail's trunk of two checkouts of the repository, in turns, on
one GPU.

    python3 chip_roi_ab.py --old-tree OLD --out DIR/ab.json [--groups G,...]

OLD is another checkout, for example a parent commit unpacked with ``git
archive`` into a git-ignored directory of this one.  The script runs itself
once per turn in a fresh process (old, new, new, old), each importing
hnd_ghnd_tpu_torch from its own checkout and building that checkout's
kernels, and each times the wrappers a user calls on the same seeded inputs
at the main path's shapes:

  * ``quantize`` and ``dequantize`` on the float32 bottleneck of a batch-8
    bucket of each size, [8, 212, 340, 3] and [8, 340, 212, 3], and of
    832x1344 at batch 1 and 32;
  * ``roi_align`` on float32 P2-P5 of a batch-8 832x1344 bucket (C=256):
    8x1000 RoIs at 7x7 (the box head) and 8x100 at 14x14 (the mask and
    keypoint heads); the same on their int8 tables (``quantize_levels``);
  * ``quantize_levels`` on float32 P2-P5 of a batch-8 bucket (C=256) of
    each size, 832x1344 and 1344x832, from the NHWC views of NCHW maps (as
    the FPN hands them over) and from contiguous NHWC levels;
  * ``roi_align`` on bfloat16 P2-P5 of a batch-2 bucket, 2x512 RoIs at 7x7
    (the supervised step), and ``roi_align_backward`` there on bfloat16 and
    float32 levels;
  * the stem's ``stem_fwd``, ``stem_fwd_res`` and ``stem_dw`` on a batch-4
    input of each bucket (the distill step's), [4, 3, 832, 1344] and
    [4, 3, 1344, 832];
  * the stem's three wrappers again on bfloat16 activations (R12), held
    to the plain version with chip_smoke's count rule
    (STEM_BF16_DIFF_FRAC); dW's error against the plain version is
    printed in each turn;
  * NMS on the problems of a batch-8 832x1344 served forward (recorded by
    the first turn): the box head's [8, 4096] through ``nms_keep``, and
    the RPN's five levels through ``nms_keep_levels`` where the checkout
    has it (one entry), else one ``nms_keep`` a level; keep masks equal
    to the plain fixpoint's and across the checkouts, and in each
    checkout the device ms of each of its kernels (and memsets) by name,
    from a ``torch.profiler`` trace of whole calls
    (``chip_smoke.kernel_device_ms``);
  * the int8 server tail's trunk (``Int8SplitTail``, its 46 convolutions
    on csrc/int8_conv.cu, B6) at batch 8 on a served batch of each bucket,
    from the dequantized wire to the NCHW float32 features the FPN reads;
    the serving student of chip_smoke.py calibrated as its int8 phase
    calibrates it.  The codes of all 44 sites and the features must agree
    bit for bit between the checkouts.

Each time is a median of chip_smoke.REPS CUDA-event timings, read both ways
chip_smoke reads them (``chip_smoke.timings``): ``ms`` as the caller sees
it, ``device_ms`` on the card alone; a forward's ``checked_inputs`` (its
checks and level assignment) is also timed alone on the card.  Each process holds every output
against the plain version (ops/roi_align.py) with chip_smoke's tolerances;
the RoIAlign forwards' bits, the level quantizer's codes and scales, and
the bottleneck pair's codes, scale, zero point and dequantized floats must
also agree between the checkouts.  The
stem outputs are held to their plain versions with chip_smoke's
STEM_FWD_TOL and STEM_DW_TOL, dW must repeat bit for bit, and the
forwards (float32 and bfloat16, output and residual) and the float32 dW
must equal the first turn's (saved to a temporary directory) bit for bit
in every later turn.  In the last
turn of the new checkout, if its wrapper picks a channel width
(``vector_width``), each case is timed again at every width its kernel
takes, and the passes are timed apart: the backward's zeroing of its
float32 workspace and its bf16 rounding (the scatter is the rest), and the
quantizer's abs-max pass (with its memset) and codes pass
(``quantize_levels_args`` gives their arguments); beside the bottleneck
pair, the launch floors (an empty cooperative kernel with one grid barrier
on quantize's grid, an empty kernel on dequantize's) and ``torch.aminmax``.

``--groups`` runs only some of them (pair, roi, levels, backward, stem,
int8, nms).
Writes the turns and, per case, old and new (each the mean of its two
turns) and their ratio, with the card's name and power limit, to FILE as
JSON; each turn's own record goes beside it.  Without a GPU it exits
nonzero.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (BUCKETS, EVAL_BATCH, INT8_CALIB_IMAGES, ORG_BATCH,
                        ROI_TOL, SEED, STEM_BF16_DIFF_FRAC, STEM_DW_TOL,
                        STEM_FWD_TOL, TRAIN_BATCH, TRAIN_ROIS, bf16_ulp,
                        box_mix, gpu_name_and_power, kernel_device_ms, log,
                        quant_input, sass_hmma, serving_batches,
                        serving_model, stem_inputs, time_ms, timings)

HERE = Path(__file__).resolve().parent
TURNS = ("old", "new", "new", "old")
# the bottleneck pair, the RoIAlign forwards, the level quantizer, the
# RoIAlign backward, the stem, the int8 tail's trunk, NMS
GROUPS = ("pair", "roi", "levels", "backward", "stem", "int8", "nms")


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


@contextlib.contextmanager
def width(RK, vec: int):
    """The wrapper's channel width capped at ``vec`` (the backward's float
    atomics at ``vec`` too)."""
    full, atomic = RK.vector_width, RK.ATOMIC_FLOATS
    RK.vector_width = lambda *a: min(full(*a), vec)
    RK.ATOMIC_FLOATS = vec
    try:
        yield
    finally:
        RK.vector_width, RK.ATOMIC_FLOATS = full, atomic


def widths(RK, itemsize: int) -> list:
    """The channel widths the kernels take for elements of ``itemsize``."""
    return sorted({max(1, nb // itemsize) for nb in RK.VECTOR_BYTES} | {1},
                  reverse=True)


def bottleneck_cases(dev: torch.device):
    """(name, z) for the bottleneck quantizer pair: seeded bottlenecks of
    both buckets at batch 8 ([8, 212, 340, 3] and [8, 340, 212, 3]), and of
    832x1344 at batch 1 and 32 (where the quantize grid's registers hold the
    whole tensor, and where they do not)."""
    for b, h, w in ((EVAL_BATCH, 212, 340), (EVAL_BATCH, 340, 212),
                    (1, 212, 340), (32, 212, 340)):
        yield f"{b}x{h}x{w}x3", torch.from_numpy(
            quant_input(SEED + 15, (b, h, w, 3))).to(dev)


def forward_cases(dev: torch.device):
    """(name, levels, quant, boxes, valid, pool) at the eval's and the
    train step's shapes, from seeds."""
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    rng = np.random.RandomState(SEED + 11)
    h, w = BUCKETS[0]
    levels = [torch.randn((EVAL_BATCH, h // s, w // s, 256), generator=gen,
                          device=dev) for s in (4, 8, 16, 32)]
    tables = RK.quantize_levels(levels)
    for n, pool in ((1000, 7), (100, 14)):
        boxes = torch.from_numpy(box_mix(rng, EVAL_BATCH, n, h, w)).to(dev)
        valid = torch.from_numpy(rng.rand(EVAL_BATCH, n) > 0.3).to(dev)
        yield f"f32 {pool}x{pool}", levels, None, boxes, valid, pool
        yield f"int8 {pool}x{pool}", levels, tables, boxes, valid, pool
    del levels, tables
    feats = [torch.randn((ORG_BATCH, h // s, w // s, 256), generator=gen,
                         device=dev).to(torch.bfloat16) for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(box_mix(rng, ORG_BATCH, TRAIN_ROIS, h, w)).to(dev)
    valid = torch.from_numpy(rng.rand(ORG_BATCH, TRAIN_ROIS) > 0.05).to(dev)
    yield "bf16 7x7 train", feats, None, boxes, valid, 7


def quant_cases(dev: torch.device):
    """(name, levels) for the level quantizer: seeded batch-8 P2-P5 of each
    bucket, as NHWC views of NCHW maps and as contiguous NHWC levels."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for h, w in BUCKETS:
        nchw = [torch.randn((EVAL_BATCH, 256, h // s, w // s), generator=gen,
                            device=dev) * (1.0 + i)
                for i, s in enumerate((4, 8, 16, 32))]
        views = [f.permute(0, 2, 3, 1) for f in nchw]
        yield f"quantize_levels NCHW {h}x{w}", views
        nhwc = [v.contiguous() for v in views]
        del nchw, views
        yield f"quantize_levels NHWC {h}x{w}", nhwc
        del nhwc
        torch.cuda.empty_cache()


def backward_cases(dev: torch.device):
    """(name, levels, cotangent, boxes, valid) at the train step's shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rng = np.random.RandomState(SEED + 12)
    h, w = BUCKETS[0]
    boxes = torch.from_numpy(box_mix(rng, ORG_BATCH, TRAIN_ROIS, h, w)).to(dev)
    valid = torch.from_numpy(rng.rand(ORG_BATCH, TRAIN_ROIS) > 0.05).to(dev)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        levels = [torch.randn((ORG_BATCH, h // s, w // s, 256), generator=gen,
                              device=dev).to(dtype) for s in (4, 8, 16, 32)]
        cot = torch.randn((ORG_BATCH, TRAIN_ROIS, 7, 7, 256), generator=gen,
                          device=dev).to(dtype)
        yield f"backward {tag}", levels, cot, boxes, valid


def stem_cases(tree: Path, dev: torch.device, saved: Path):
    """The stem wrappers of the checkout at ``tree`` on seeded batch-4
    inputs of both buckets, float32 and bfloat16 activations: each held to
    its plain version (float32 within STEM_FWD_TOL; the bf16 forwards
    within one bf16 ulp of the largest output with at most
    STEM_BF16_DIFF_FRAC of the elements differing; dW within STEM_DW_TOL),
    dW repeated, the forwards and the float32 dW saved to ``saved`` by the
    first turn and held to them bit for bit by the later ones.  Yields the
    records."""
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    _build.load()
    # ptxas's registers and spills of the stem kernels (where this turn
    # built the library) and their tensor-core instructions
    kernel = ""
    for line in _build.build_info["log"].splitlines():
        if "entry function" in line:
            kernel = line
        elif "stem" in kernel and ("registers" in line or "spill" in line):
            log(f"[ab {tree.name}] {kernel.strip()}: {line.strip()}")
    for name, n in (sass_hmma(_build.build_info["path"]) or {}).items():
        if "stem" in name:
            log(f"[ab {tree.name}] {n} HMMA in {name}")
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        bf16 = dtype == torch.bfloat16
        for bucket in BUCKETS:
            shape = (TRAIN_BATCH, 3) + bucket
            gen = torch.Generator(device=dev).manual_seed(SEED + 13)
            x, w, scale, bias = stem_inputs(gen, shape, dev)
            x = x.to(dtype)
            want, conv = ts.stem_forward(x, w, scale, bias, with_conv=True)
            g = torch.randn(conv.shape, generator=gen, device=dev).to(dtype)
            want_dw = ts.stem_weight_grad(x, g)
            got = SK.stem_fwd(x, w, scale, bias)
            got_res, got_conv = SK.stem_fwd_res(x, w, scale, bias)
            dw = SK.stem_dw(x, g)
            if not torch.equal(SK.stem_dw(x, g), dw):
                raise AssertionError(f"stem_dw{suffix} {shape} is not "
                                     "repeatable")

            def bound(t):
                m = float(t.float().abs().max())
                return bf16_ulp(m) if bf16 else STEM_FWD_TOL * m

            outs = {"stem_fwd": (got, want, bound(want)),
                    "stem_fwd_res": (got_res, want, bound(want)),
                    "stem_fwd_res conv": (got_conv, conv, bound(conv)),
                    "stem_dw": (dw, want_dw,
                                STEM_DW_TOL * float(want_dw.abs().max()))}
            errs = {}
            for name, (a, b, tol) in outs.items():
                errs[name] = float((a.float() - b.float()).abs().max())
                if errs[name] > tol:
                    raise AssertionError(f"{name}{suffix} {shape}: "
                                         f"{errs[name]} from the plain "
                                         "version")
                if bf16 and name != "stem_dw":
                    n = int((a != b).sum())
                    errs[f"{name} differing"] = n
                    if n > STEM_BF16_DIFF_FRAC * b.numel():
                        raise AssertionError(f"{name}{suffix} {shape}: {n} "
                                             "elements differ")
            # across the checkouts the forwards (both dtypes) and the
            # float32 dW must be the same bits; bf16 dW is held to the plain
            # version only (its kernel may differ between the checkouts)
            file = saved / f"stem{suffix}_{bucket[0]}x{bucket[1]}.pt"
            same = ("stem_fwd", "stem_fwd_res", "stem_fwd_res conv") \
                + (() if bf16 else ("stem_dw",))
            if file.is_file():
                other = torch.load(file, map_location=dev)
                for name in same:
                    if not torch.equal(outs[name][0], other[name]):
                        gap = float((outs[name][0].float()
                                     - other[name].float()).abs().max())
                        raise AssertionError(f"{name}{suffix} {shape}: the "
                                             f"checkouts differ by {gap}")
                    errs[f"{name} vs other checkout"] = "bits equal"
            else:
                torch.save({name: outs[name][0] for name in same}, file)
            del want, conv, got_res, got_conv, want_dw
            calls = {"stem_fwd": lambda: SK.stem_fwd(x, w, scale, bias),
                     "stem_fwd_res": lambda: SK.stem_fwd_res(x, w, scale,
                                                             bias),
                     "stem_dw": lambda: SK.stem_dw(x, g)}
            for name, call in calls.items():
                rec = dict(name=f"{name}{suffix} {bucket[0]}x{bucket[1]}",
                           shape=list(shape), errs=errs, **timings(call))
                log(f"[ab {tree.name}] {rec['name']}: {rec['ms']:.4f} ms "
                    f"({rec['device_ms']:.4f} on the card)")
                yield rec
            log(f"[ab {tree.name}] stem{suffix} {shape} max abs errors: "
                f"{errs}; dW from the plain version {errs['stem_dw']:.3e} "
                f"(bound {outs['stem_dw'][2]:.3e})")
            del x, g, got, dw
            torch.cuda.empty_cache()


def nms_problems(dev: torch.device, saved: Path) -> dict:
    """The NMS problems of a batch-8 832x1344 served forward of
    chip_smoke's serving student, recorded by the first turn to ``saved``
    (from its own checkout's forward: the RPN's levels through
    ``nms_keep_levels`` or one ``nms_keep`` a level, the box head's
    through ``nms_keep``) and loaded by the others: {"box_head": (boxes,
    scores, valid, categories, threshold), "levels": ([(boxes, scores,
    valid) per level], threshold)}."""
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    from hnd_ghnd_tpu_torch.runners.common import eval_forward
    file = saved / "nms_problems.pt"
    if not file.is_file():
        seen = {"keep": [], "levels": []}
        op, levels_op = NMS.nms_keep_op, getattr(NMS, "nms_keep_levels_op",
                                                 None)

        def record(boxes, scores, valid, categories, thr):
            seen["keep"].append((boxes.clone(), scores.clone(), valid.clone(),
                                 categories, thr))
            return op(boxes, scores, valid, categories, thr)

        def record_levels(boxes, scores, valid, sizes, thr):
            seen["levels"].append((boxes, scores, valid, list(sizes), thr))
            return levels_op(boxes, scores, valid, sizes, thr)

        NMS.nms_keep_op = record
        if levels_op is not None:
            NMS.nms_keep_levels_op = record_levels
        try:
            model = serving_model(dev)
            batch = serving_batches(np.random.RandomState(SEED + 1))[0]
            with torch.no_grad():
                eval_forward(model, {k: torch.from_numpy(v).to(dev)
                                     for k, v in batch.items()}, True)
        finally:
            NMS.nms_keep_op = op
            if levels_op is not None:
                NMS.nms_keep_levels_op = levels_op
        box = [p for p in seen["keep"] if p[3] is not None]
        if seen["levels"]:
            b, sc, v, sizes, thr = seen["levels"][0]
            levels = list(zip(b.split(sizes, 1), sc.split(sizes, 1),
                              v.split(sizes, 1)))
        else:
            levels = [p[:3] for p in seen["keep"] if p[3] is None]
            thr = seen["keep"][0][4]
        torch.save({"box_head": box[0], "levels": (levels, thr)}, file)
        del model
        torch.cuda.empty_cache()
    return torch.load(file, map_location=dev)


def nms_cases(tree: Path, dev: torch.device, saved: Path):
    """The NMS of the checkout at ``tree`` on a served forward's problems
    (``nms_problems``): the box head's [8, 4096] through ``nms_keep``, and
    the RPN's five levels through ``nms_keep_levels`` where the checkout
    has it, else one ``nms_keep`` a level; keep masks held to the plain
    fixpoint and, by digest, to the other checkout's; each record also
    has the device ms of each kernel a call launches, by name.  Yields the
    records."""
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    problems = nms_problems(dev, saved)
    bx, sc, va, ca, thr = problems["box_head"]
    levels, lthr = problems["levels"]
    sizes = [p[0].shape[1] for p in levels]
    lb, ls, lv = (torch.cat([p[i] for p in levels], 1).contiguous()
                  for i in range(3))
    if hasattr(NMS, "nms_keep_levels"):
        def rpn():
            return NMS.nms_keep_levels(lb, ls, lthr, lv, sizes)
    else:
        def rpn():
            return torch.cat([NMS.nms_keep(b, s, lthr, v)
                              for b, s, v in levels], 1)
    for name, call, plain in (
            (f"nms box head {list(bx.shape[:2])}",
             lambda: NMS.nms_keep(bx, sc, thr, va, ca),
             lambda: NMS.nms_plain(bx, sc, va, ca, thr)),
            (f"nms rpn levels {sizes} x {lb.shape[0]}", rpn,
             lambda: torch.cat([NMS.nms_plain(b, s, v, None, lthr)
                                for b, s, v in levels], 1))):
        keep = call()
        if not torch.equal(keep, plain()):
            raise AssertionError(f"{name}: keep mask differs from the plain "
                                 "fixpoint's")
        rec = dict(name=name, shape=list(keep.shape), kept=int(keep.sum()),
                   digest=digest(keep), **timings(call),
                   passes_device_ms=kernel_device_ms(call))
        log(f"[ab {tree.name}] {name}: {rec['ms']:.4f} ms "
            f"({rec['device_ms']:.4f} on the card), {rec['kept']} kept; its "
            f"kernels in a profiler trace: " + (", ".join(
                f"{k} {v:.4f}" for k, v in rec["passes_device_ms"].items())
                or "not measured (no device events)"))
        yield rec


def int8_trunk_cases(tree: Path, dev: torch.device):
    """The int8 tail's trunk of the checkout at ``tree``: the serving
    student calibrated on INT8_CALIB_IMAGES served images, then the trunk
    of a batch-8 wire of each bucket up to the NCHW features (the
    package's ``trunk_nchw`` where it has one, else its NHWC features
    copied to NCHW as its ``tail_fn`` copies them).  The sites' codes and
    the features are digested for the other checkout.  Yields the
    records."""
    from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.split import int8 as qi
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN
    os.environ["HND_TPU_PALLAS_STEM"] = "0"
    model = serving_model(dev)
    served = serving_batches(np.random.RandomState(SEED + 50))[:2]
    scales = qi.calibrate_from_images(
        model, [served[0]["images"][i:i + 1]
                for i in range(INT8_CALIB_IMAGES)])
    tail = qi.Int8SplitTail(model, scales)
    split = SplitRCNN(model, 8)
    if hasattr(tail, "trunk_nchw"):
        features = tail.trunk_nchw
    else:
        def features(z):
            return [f.permute(0, 3, 1, 2).contiguous() for f in tail.trunk(z)]
    for batch in served:
        bucket = tuple(batch["images"].shape[1:3])
        q, scale, zp, _ = split.head_fn(
            torch.from_numpy(batch["images"]).to(dev))
        z = QK.dequantize(QuantizedTensor(q, scale, zp))
        sites = {}
        with torch.no_grad():
            feats = [f.permute(0, 3, 1, 2).contiguous()
                     for f in tail.trunk(z, sites)]
            bits = digest(torch.cat(
                [c.reshape(-1) for c in sites.values()]
                + [f.reshape(-1).view(torch.int8) for f in feats]))
            rec = dict(name=f"int8 trunk {bucket[0]}x{bucket[1]}",
                       shape=list(z.shape), digest=bits, sites=len(sites),
                       **timings(lambda: features(z)))
        log(f"[ab {tree.name}] {rec['name']} {tuple(z.shape)}: "
            f"{rec['ms']:.4f} ms ({rec['device_ms']:.4f} on the card); "
            f"{len(sites)} sites")
        yield rec
        del q, z, sites, feats
    del model, tail, split
    torch.cuda.empty_cache()


def bottleneck_cases_run(tree: Path, dev: torch.device, sweep: bool):
    """The quantizer pair of the checkout at ``tree`` on bottleneck_cases:
    codes, scale and zero point bit-exact with the plain version, dequantize
    exact, their bits (digest) compared across the checkouts.  In the sweep
    turn also: the launch floors (an empty cooperative kernel with one grid
    barrier on quantize's grid, an empty kernel on dequantize's) and
    torch.aminmax, the yardstick of quantize's reduction.  Yields the
    records."""
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.codec.quantizer import (dequantize_tensor,
                                                    quantize_tensor)
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    sweep = sweep and hasattr(_build.load(), "hnd_launch_floor")
    for name, z in bottleneck_cases(dev):
        q = QK.quantize(z, 8)
        want = quantize_tensor(z, 8)
        d = QK.dequantize(q)
        if not (torch.equal(q.tensor, want.tensor)
                and torch.equal(q.scale, want.scale)
                and torch.equal(q.zero_point, want.zero_point)
                and torch.equal(d, dequantize_tensor(want))):
            raise AssertionError(f"quantize {name}: differs from the plain "
                                 "version")
        bits = digest(torch.cat([q.tensor.reshape(-1), torch.stack(
            [q.scale, q.zero_point]).view(torch.uint8)]))
        for what, call in (("quantize", lambda: QK.quantize(z, 8)),
                           ("dequantize", lambda: QK.dequantize(q))):
            rec = dict(name=f"{what} {name}", shape=list(z.shape),
                       digest=bits if what == "quantize" else digest(d),
                       **timings(call))
            if sweep and what == "quantize":
                rec["aminmax_device_ms"] = time_ms(lambda: torch.aminmax(z),
                                                   spin=True)
            if sweep:
                lib = _build.load()
                stream = torch.cuda.current_stream(dev).cuda_stream
                rec["launch_floor_device_ms"] = time_ms(
                    lambda: _build.check(lib.hnd_launch_floor(
                        z.numel(), int(what == "quantize"), stream),
                        "hnd_launch_floor"), spin=True)
            log(f"[ab {tree.name}] {rec['name']}: {rec['ms']:.4f} ms "
                f"({rec['device_ms']:.4f} on the card); bit-exact"
                + "".join(f"; {k} {v}" for k, v in rec.items()
                          if k.endswith("device_ms") and k != "device_ms"))
            yield rec
        del q, want, d, z
    torch.cuda.empty_cache()


def turn(tree: Path, out: Path, sweep: bool, saved: Path, groups) -> int:
    """One turn: the RoIAlign and stem wrappers of the checkout at
    ``tree``."""
    sys.path.insert(0, str(tree))
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import (multiscale_roi_align_batch,
                                                  quantize_fpn_levels)
    if not Path(RK.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {RK.__file__}, not from {tree}")
    sweep = sweep and hasattr(RK, "vector_width")
    dev = torch.device("cuda", 0)
    # the plain convolutions in float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size = BUCKETS[0]
    cases = list(bottleneck_cases_run(tree, dev, sweep)
                 if "pair" in groups else ())
    for name, levels, quant, boxes, valid, pool in (
            forward_cases(dev) if "roi" in groups else ()):
        def call():
            return RK.roi_align(levels, boxes, size, pool, 2, valid,
                                quant=quant)
        got = call()
        want = multiscale_roi_align_batch(levels, boxes, size, pool, 2, valid,
                                          quant=quant)
        err = float((got.float() - want.float()).abs().max())
        # bf16 and int8 bit-identical, f32 within ROI_TOL of the largest
        tol = ROI_TOL * float(want.float().abs().max()) \
            if got.dtype == torch.float32 and quant is None else 0.0
        if err > tol or (tol == 0.0 and not torch.equal(got, want)):
            raise AssertionError(f"{name}: {err} from the plain version")
        rec = dict(name=name, shape=list(got.shape), err=err, tol=tol,
                   digest=digest(got), **timings(call))
        # the wrapper's checks and level assignment alone
        tables, scale = (levels, None) if quant is None else quant
        rec["assign_device_ms"] = time_ms(lambda: RK.checked_inputs(
            tables, boxes, valid, scale), spin=True)
        if sweep:
            rec["width_device_ms"] = {}
            for vec in widths(RK, levels[0].element_size() if quant is None
                              else 1):
                with width(RK, vec):
                    if not torch.equal(call(), got):
                        raise AssertionError(f"{name}: width {vec} differs")
                    rec["width_device_ms"][vec] = time_ms(call, spin=True)
        cases.append(rec)
        log(f"[ab {tree.name}] {name} {tuple(got.shape)}: {rec['ms']:.4f} ms "
            f"({rec['device_ms']:.4f} on the card, of which level assignment "
            f"{rec['assign_device_ms']:.4f}); error {err} (bound {tol})"
            + ("" if not sweep else "; channels per thread " + ", ".join(
                f"{v}: {t:.4f}" for v, t in rec["width_device_ms"].items())))
        del got, want
    for name, levels in quant_cases(dev) if "levels" in groups else ():
        def call():
            return RK.quantize_levels(levels)
        codes, scales = call()
        want_q, want_s = quantize_fpn_levels(levels)
        if not (torch.equal(scales, want_s) and all(
                torch.equal(a, b) for a, b in zip(codes, want_q))):
            raise AssertionError(f"{name}: codes or scales differ from the "
                                 "plain version")
        rec = dict(name=name, shape=list(levels[0].shape), digest=digest(
            torch.cat([q.reshape(-1).view(torch.uint8) for q in codes]
                      + [scales.contiguous().view(torch.uint8)])),
            **timings(call))
        if sweep and hasattr(RK, "quantize_levels_args"):
            lib = _build.load()
            # the outputs stay referenced while their pointers are in use
            args, out_q, out_s = RK.quantize_levels_args(levels)
            _build.check(lib.hnd_quantize_levels(*args), "hnd_quantize_levels")
            rec["absmax_device_ms"] = time_ms(lambda: _build.check(
                lib.hnd_quantize_levels_absmax(*args[:7], args[8]),
                "hnd_quantize_levels_absmax"), spin=True)
            rec["codes_device_ms"] = time_ms(lambda: _build.check(
                lib.hnd_quantize_levels_codes(*args),
                "hnd_quantize_levels_codes"), spin=True)
            if not (torch.equal(out_s, scales) and all(
                    torch.equal(a, b) for a, b in zip(out_q, codes))):
                raise AssertionError(f"{name}: the passes alone differ")
            del out_q, out_s
        cases.append(rec)
        log(f"[ab {tree.name}] {name}: {rec['ms']:.4f} ms "
            f"({rec['device_ms']:.4f} on the card); codes and scales equal "
            "the plain version's" + "".join(
                f"; {k} {v:.4f}" for k, v in rec.items()
                if k in ("absmax_device_ms", "codes_device_ms")))
        del codes, scales, want_q, want_s, levels
    for name, levels, cot, boxes, valid in (
            backward_cases(dev) if "backward" in groups else ()):
        dtype = levels[0].dtype
        shapes = [tuple(f.shape[1:3]) for f in levels]
        _, level, weight = RK.checked_inputs(levels, boxes, valid)

        def call():
            return RK.roi_align_backward(cot, shapes, dtype, boxes, level,
                                         weight, size, 2)
        ref = [f.clone().requires_grad_(True) for f in levels]
        plain = torch.autograd.grad(
            multiscale_roi_align_batch(ref, boxes, size, 7, 2, valid), ref,
            cot)
        del ref
        top = max(float(g.float().abs().max()) for g in plain)
        # float atomics add in another order than the plain scatter
        tol = ROI_TOL * top if dtype == torch.float32 else bf16_ulp(top)

        def gap():
            return max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(call(), plain))
        err = gap()
        if err > tol:
            raise AssertionError(f"{name}: {err} > {tol}")
        rec = dict(name=name, shape=list(cot.shape), err=err, tol=tol,
                   **timings(call))
        # the float32 workspace of P2-P5's gradients
        n_acc = sum(ORG_BATCH * h * w * 256 for h, w in shapes)
        if sweep:
            rec["width_device_ms"] = {}
            for vec in widths(RK, cot.element_size()):
                with width(RK, vec):
                    if gap() > tol:
                        raise AssertionError(f"{name}: width {vec} is off")
                    rec["width_device_ms"][vec] = time_ms(call, spin=True)
            rec["zero_device_ms"] = time_ms(lambda: torch.zeros(
                n_acc, dtype=torch.float32, device=dev), spin=True)
        if dtype == torch.bfloat16:
            acc = torch.randn(n_acc, device=dev)
            rounded = torch.empty(n_acc, dtype=torch.bfloat16, device=dev)
            rec["round_device_ms"] = time_ms(
                lambda: _build.check(_build.load().hnd_f32_to_bf16(
                    acc.data_ptr(), rounded.data_ptr(), n_acc,
                    RK._stream(dev)), "hnd_f32_to_bf16"), spin=True)
            if not torch.equal(rounded, acc.to(torch.bfloat16)):
                raise AssertionError("hnd_f32_to_bf16 differs from .to()")
            del acc, rounded
        cases.append(rec)
        log(f"[ab {tree.name}] {name} {tuple(cot.shape)}: {rec['ms']:.4f} ms "
            f"({rec['device_ms']:.4f} on the card); error {err:.3e} (bound "
            f"{tol:.3e})" + "".join(
                f"; {k} {v}" for k, v in rec.items()
                if k in ("width_device_ms", "zero_device_ms",
                         "round_device_ms")))
        del levels, cot, plain
        torch.cuda.empty_cache()
    cases += list(stem_cases(tree, dev, saved) if "stem" in groups else ())
    cases += list(int8_trunk_cases(tree, dev) if "int8" in groups else ())
    cases += list(nms_cases(tree, dev, saved) if "nms" in groups else ())
    out.write_text(json.dumps({"tree": str(tree), "cases": cases}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-tree", type=Path, help="the other checkout")
    ap.add_argument("--out", required=True, type=Path, help="the JSON result")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated kernel groups to run, of "
                    f"{', '.join(GROUPS)} (default: all)")
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--saved", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_roi_ab: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if args.turn is not None:
        return turn(args.turn.resolve(), args.out, args.sweep, args.saved,
                    args.groups.split(","))
    if args.old_tree is None:
        ap.error("--old-tree is required")
    if not set(args.groups.split(",")) <= set(GROUPS):
        ap.error(f"--groups takes {', '.join(GROUPS)}")
    trees = {"old": args.old_tree.resolve(), "new": HERE}
    card = gpu_name_and_power()
    log(f"[ab] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; old {trees['old']}, new {trees['new']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_roi_ab.") as saved:
        for i, side in enumerate(TURNS):
            part = args.out.with_name(f"{args.out.stem}.turn{i}.{side}.json")
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "--turn", str(trees[side]), "--out", str(part),
                            "--saved", saved, "--groups", args.groups]
                           + (["--sweep"] if i == 2 else []), check=True)
            runs.append(json.loads(part.read_text())["cases"])
    results = []
    for k, rec in enumerate(runs[1]):
        name = rec["name"]
        per_turn = [r[k] for r in runs]
        if any(r["name"] != name for r in per_turn):
            raise AssertionError(f"the turns' cases differ at {name}")
        if "digest" in rec and len({r["digest"] for r in per_turn}) != 1:
            raise AssertionError(f"{name}: old and new forwards differ")
        res = {"name": name, "shape": rec["shape"]}
        for key in ("ms", "device_ms", "assign_device_ms"):
            if key not in rec:
                continue
            t = [r[key] for r in per_turn]
            old, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            res[key] = {"turns": t, "old": old, "new": new,
                        "speedup": old / new}
        results.append(res)
        log(f"[ab] {name}: old {res['ms']['old']:.4f} -> new "
            f"{res['ms']['new']:.4f} ms ({res['ms']['speedup']:.2f}x); on the "
            f"card old {res['device_ms']['old']:.4f} -> new "
            f"{res['device_ms']['new']:.4f} ms "
            f"({res['device_ms']['speedup']:.2f}x; turns "
            + " / ".join(f"{t:.4f}" for t in res["device_ms"]["turns"]) + ")"
            + ("" if "assign_device_ms" not in res else
               f"; level assignment on the card old "
               f"{res['assign_device_ms']['old']:.4f} -> new "
               f"{res['assign_device_ms']['new']:.4f} ms")
            + ("" if "digest" not in rec else "; output bits equal"))
    args.out.write_text(json.dumps({"card": card, "turns": TURNS,
                                    "cases": results, "runs": runs},
                                   indent=1))
    log(f"[ab] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
