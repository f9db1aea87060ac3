"""The RoIAlign and stem kernels of two checkouts of the repository, in turns,
on one GPU.

    python3 chip_roi_ab.py --old-tree OLD --out DIR/ab.json

OLD is another checkout, for example a parent commit unpacked with ``git
archive`` into a git-ignored directory of this one.  The script runs itself
once per turn in a fresh process (old, new, new, old), each importing
hnd_ghnd_tpu_torch from its own checkout and building that checkout's
kernels, and each times the wrappers a user calls on the same seeded inputs
at the main path's shapes:

  * ``roi_align`` on float32 P2-P5 of a batch-8 832x1344 bucket (C=256):
    8x1000 RoIs at 7x7 (the box head) and 8x100 at 14x14 (the mask and
    keypoint heads); the same on their int8 tables (``quantize_levels``);
  * ``roi_align`` on bfloat16 P2-P5 of a batch-2 bucket, 2x512 RoIs at 7x7
    (the supervised step), and ``roi_align_backward`` there on bfloat16 and
    float32 levels;
  * the stem's ``stem_fwd``, ``stem_fwd_res`` and ``stem_dw`` on a batch-4
    input of each bucket (the distill step's), [4, 3, 832, 1344] and
    [4, 3, 1344, 832].

Each time is a median of chip_smoke.REPS CUDA-event timings, read both ways
chip_smoke reads them (``chip_smoke.timings``): ``ms`` as the caller sees
it, ``device_ms`` on the card alone; a forward's ``checked_inputs`` (its
checks and level assignment) is also timed alone on the card.  Each process holds every output
against the plain version (ops/roi_align.py) with chip_smoke's tolerances;
the RoIAlign forwards' bits must also agree between the checkouts.  The
stem outputs are held to their plain versions with chip_smoke's
STEM_FWD_TOL and STEM_DW_TOL, dW must repeat bit for bit, and the new
checkout's forwards must agree with the old one's (saved by the first
turn to a temporary directory) within STEM_FWD_TOL.  In the last
turn of the new checkout, if its wrapper picks a channel width
(``vector_width``), each case is timed again at every width its kernel
takes, and the backward's passes are timed apart: the zeroing of its
float32 workspace and the bf16 rounding (the scatter is the rest).

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
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (BUCKETS, EVAL_BATCH, ORG_BATCH, ROI_TOL, SEED,
                        STEM_DW_TOL, STEM_FWD_TOL, TRAIN_BATCH, TRAIN_ROIS,
                        bf16_ulp, box_mix, gpu_name_and_power, log,
                        stem_inputs, time_ms, timings)

HERE = Path(__file__).resolve().parent
TURNS = ("old", "new", "new", "old")


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
    inputs of both buckets: each held to its plain version, dW repeated,
    the forwards saved to ``saved`` when the other checkout's are not
    there yet and held to them when they are.  Yields the records."""
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    for bucket in BUCKETS:
        shape = (TRAIN_BATCH, 3) + bucket
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        x, w, scale, bias = stem_inputs(gen, shape, dev)
        want, conv = ts.stem_forward(x, w, scale, bias, with_conv=True)
        g = torch.randn(conv.shape, generator=gen, device=dev)
        want_dw = ts.stem_weight_grad(x, g)
        got = SK.stem_fwd(x, w, scale, bias)
        got_res, got_conv = SK.stem_fwd_res(x, w, scale, bias)
        dw = SK.stem_dw(x, g)
        if not torch.equal(SK.stem_dw(x, g), dw):
            raise AssertionError(f"stem_dw {shape} is not repeatable")
        outs = {"stem_fwd": (got, want, STEM_FWD_TOL),
                "stem_fwd_res": (got_res, want, STEM_FWD_TOL),
                "stem_fwd_res conv": (got_conv, conv, STEM_FWD_TOL),
                "stem_dw": (dw, want_dw, STEM_DW_TOL)}
        errs = {}
        for name, (a, b, tol) in outs.items():
            errs[name] = float((a - b).abs().max())
            if errs[name] > tol * float(b.abs().max()):
                raise AssertionError(f"{name} {shape}: {errs[name]} from the "
                                     "plain version")
        file = saved / f"stem_{bucket[0]}x{bucket[1]}.pt"
        if file.is_file():
            other = torch.load(file, map_location=dev)
            for name in ("stem_fwd", "stem_fwd_res conv"):
                gap = float((outs[name][0] - other[name]).abs().max())
                if gap > STEM_FWD_TOL * float(outs[name][1].abs().max()):
                    raise AssertionError(f"{name} {shape}: the checkouts "
                                         f"differ by {gap}")
                errs[f"{name} vs other checkout"] = gap
        else:
            torch.save({"stem_fwd": got, "stem_fwd_res conv": got_conv},
                       file)
        del want, conv, got_res, got_conv, want_dw
        calls = {"stem_fwd": lambda: SK.stem_fwd(x, w, scale, bias),
                 "stem_fwd_res": lambda: SK.stem_fwd_res(x, w, scale, bias),
                 "stem_dw": lambda: SK.stem_dw(x, g)}
        for name, call in calls.items():
            rec = dict(name=f"{name} {bucket[0]}x{bucket[1]}",
                       shape=list(shape), errs=errs, **timings(call))
            log(f"[ab {tree.name}] {rec['name']}: {rec['ms']:.4f} ms "
                f"({rec['device_ms']:.4f} on the card)")
            yield rec
        log(f"[ab {tree.name}] stem {shape} max abs errors: {errs}")
        del x, g, got, dw
        torch.cuda.empty_cache()


def turn(tree: Path, out: Path, sweep: bool, saved: Path) -> int:
    """One turn: the RoIAlign and stem wrappers of the checkout at
    ``tree``."""
    sys.path.insert(0, str(tree))
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops.roi_align import multiscale_roi_align_batch
    if not Path(RK.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {RK.__file__}, not from {tree}")
    sweep = sweep and hasattr(RK, "vector_width")
    dev = torch.device("cuda", 0)
    # the plain convolutions in float32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    size = BUCKETS[0]
    cases = []
    for name, levels, quant, boxes, valid, pool in forward_cases(dev):
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
    for name, levels, cot, boxes, valid in backward_cases(dev):
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
    cases += list(stem_cases(tree, dev, saved))
    out.write_text(json.dumps({"tree": str(tree), "cases": cases}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-tree", type=Path, help="the other checkout")
    ap.add_argument("--out", required=True, type=Path, help="the JSON result")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--saved", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_roi_ab: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    if args.turn is not None:
        return turn(args.turn.resolve(), args.out, args.sweep, args.saved)
    if args.old_tree is None:
        ap.error("--old-tree is required")
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
                            "--saved", saved]
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
            + ("" if "digest" not in rec else
               f"; level assignment on the card old "
               f"{res['assign_device_ms']['old']:.4f} -> new "
               f"{res['assign_device_ms']['new']:.4f} ms; forward bits "
               "equal"))
    args.out.write_text(json.dumps({"card": card, "turns": TURNS,
                                    "cases": results, "runs": runs},
                                   indent=1))
    log(f"[ab] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
