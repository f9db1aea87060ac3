#!/usr/bin/env python3
"""The port on every card of a host with four H100s.

A JAX runner started without a multi-process launch builds one mesh over
every local chip; the port runs that mesh as local workers, one a card,
over NCCL (hnd_ghnd_tpu_torch/parallel/mesh.py).  This script holds that
path, and the N-rank path at four ranks, on four cards:

  (a) every kernel on cards 1-3 while card 0 is the current device,
      through its direct entry and its ``hnd_ghnd::`` op where it has one,
      against its plain version on that card: bit for bit where the
      kernel is bit-identical, within chip_smoke.py's bounds elsewhere;
  (b) ``mimic_runner -distill`` of the GHND b3ch config at full width in
      the local mode on four cards, float32 at batch 4 (one image a card),
      against one process on one card at the same global batch: the logged
      losses, the checkpoints' parameter moves and BatchNorm statistics,
      and the merged COCOeval of one checkpoint; then the headline bench's
      workload (bfloat16, batch 24, six images a card) on four cards and
      on one: img/s, the step's median and spread on CUDA events, and the
      all-reduce ms of the BatchNorms' statistics and of the gradient;
  (c) four ranks over NCCL in torchrun's environment at a global batch of
      16: the distill sum in float32 and in bfloat16 and the distill step
      with the org term through ``mimic_runner``, the detection step
      through ``coco_runner``, each against one process (the global batch,
      or the average of the four shards' steps);
  (d) ``coco_runner -train`` and ``ext_runner -train`` in the local mode
      on four cards, against the average of four one-process shard steps
      (detection) and one process on the global batch (ext);
  (e) the sharded split tail, packet k on card k, each shard against the
      eager tail on its packet, and its time against the four packets on
      one card.

    python3 chip_multicard.py [--out multicard.json]

It exits non-zero with fewer than four visible cards and when any check
fails.  Each card's name and power limit and the cards' topology are
printed first; the last line is {"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": 4}}.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from chip_smoke import (BENCH_BATCH, BUCKETS, EXT_MODEL, EXT_TRAIN,
                        GHND_TPU, GHND_YAML, INT8_EPILOGUE_CASES,
                        KEYPOINT_STUDENT_MODEL, LOSS_TOL_FIRST,
                        LOSS_TOL_LATER, MP_GRAD_TOL, MP_MOVE_TOL,
                        MP_TIMEOUT_S, MP_ZERO_GRAD, NMS_LEVELS, ORG_MODEL,
                        ORG_TPU, ORG_TRAIN, RUNNER_SHAPES, SEED,
                        STEM_DW_TOL, STEM_FWD_TOL, STUDENT_MODEL,
                        TEACHER_MODEL, TRAIN, _card_timed,
                        _record_grad_norms, box_mix, check,
                        drop_every_second_image, int8_epilogue,
                        int8_outputs_equal, live_norms_, log, nms_problem,
                        org_criterion, quant_input, runner_models,
                        spawn_ranks, subset_annotations,
                        teacher_annotations, write_keypoint_annotations,
                        write_runner_fixture)

CARDS = 4
# (b): the local mode's fixture, one epoch at global batch 4 (one image a
# card) over LOCAL_TRAIN images of both buckets, val and test LOCAL_VAL
# images whose annotations are the teacher's own detections
LOCAL_BATCH = 4
LOCAL_TRAIN = 16
LOCAL_VAL = 8
# each trainable BatchNorm's running statistics after the epoch: the local
# mode's merged statistics against one process's (``bn_stat_err``: a
# variance over its L2 norm, a mean over its standard deviation's; the
# same sums in another order, and parameters that differ by MP_MOVE_TOL
# of their moves)
BN_STATS_TOL = 1e-4
# the bench's workload: six images a card; epochs of BENCH_STEPS steps,
# then COLLECTIVE_STEPS a epoch with the card synchronised around each
# all-reduce
BENCH_STEPS = 20
COLLECTIVE_STEPS = 3
# (c): four ranks at four images each; NCCL_TRAIN landscape images (one
# bucket, so that the ranks' batches concatenate into the one process's)
RANK_BATCH = 4
NCCL_TRAIN = 32
# bfloat16 against the same step in one process: the activations round
# to 8 significant bits (2^-8 = 3.9e-3) where the BatchNorms' global sums
# differ in order, so a loss and the whole gradient's norm are held to
# BF16_TOL.  A leaf is held against the float32 step instead: the ranks'
# bf16 run and one process's each against one float32 process, leaf by
# leaf (the reduced gradient's norm, the move), the ranks' worst within
# BF16_RANK_FACTOR of one process's (one bf16 ulp at least).  Two bf16
# runs round apart where any float32 sum differs in order, and a leaf
# whose gradient is a cancelling sum (a BatchNorm bias: ~1.1 M bf16
# cotangents) scatters the most; ranks that lose no precision of their
# own stay as near float32 as one process does.
BF16_TOL = 1e-2
BF16_ULP = 2.0 ** -8
BF16_RANK_FACTOR = 2.0
# one SGD step from the average of the shards' gradients: each leaf's move
# against the reference's, as a fraction of its L2 norm (the shards' sums
# on other cards, the RoIAlign backward's atomics in another order)
AVG_MOVE_TOL = 1e-3
# (e): the sharded tail's timed calls
TAIL_REPS = 10


def nvidia_smi(*args: str, check_rc: bool = True) -> str:
    out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                         text=True, check=check_rc, timeout=60)
    if out.returncode:
        return (f"nvidia-smi {' '.join(args)}: exit {out.returncode} "
                f"{(out.stdout + out.stderr).strip()}")
    return out.stdout.strip()


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| over |b|, L2 norms, in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


# ----------------------------------------------------- (a) the kernels


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def fwd_tol(dtype: torch.dtype, want: torch.Tensor) -> float:
    """A stem forward's bound as a share of the plain output's largest
    value: STEM_FWD_TOL in float32; one bf16 ulp of that value in
    bfloat16 (the products are exact, the float32 sums run in another
    order and may round to the other neighbour)."""
    if dtype == torch.float32:
        return STEM_FWD_TOL
    top = float(want.float().abs().max())
    return bf16_ulp(top) / top


def kernels_on_card(dev: torch.device) -> dict:
    """Every kernel on ``dev`` while card 0 stays the current device: its
    direct entry (``launch_*``, or the wrapper that launches) and its
    ``hnd_ghnd::`` op where it has one, against its plain version on
    ``dev``.  Returns {kernel: its largest error against the plain version
    (0 where bit for bit)}; raises on the first disagreement."""
    from hnd_ghnd_tpu_torch.codec import quantizer as tq
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    from hnd_ghnd_tpu_torch.ops import library  # noqa: F401 (the ops)
    from hnd_ghnd_tpu_torch.ops import nms as NMS
    from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
    from hnd_ghnd_tpu_torch.ops import roi_align as tra
    from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    from hnd_ghnd_tpu_torch.runners.common import configure_precision
    ops = torch.ops.hnd_ghnd
    # TF32 off: the plain versions' cuDNN convolutions default to it
    configure_precision(torch.float32)
    torch.cuda.set_device(0)
    rng = np.random.RandomState(dev.index)
    gen = torch.Generator(device=dev).manual_seed(dev.index)
    errs = {}

    def on_card(*tensors):
        check(torch.cuda.current_device() == 0,
              f"the current device moved to {torch.cuda.current_device()}")
        for t in tensors:
            for u in (t if isinstance(t, (list, tuple)) else [t]):
                check(u.device == dev, f"an output on {u.device}, not {dev}")

    def same(name, got, want):
        on_card(got)
        for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                        want if isinstance(want, (list, tuple)) else [want]):
            check(torch.equal(g, w), f"{name} on {dev} differs from its "
                  "plain version")
        errs[name] = 0.0

    def close(name, got, want, tol):
        on_card(got)
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max().clamp(min=1e-30))
        check(err <= tol, f"{name} on {dev}: {err} of the plain version's "
              f"largest value (tol {tol})")
        errs[name] = max(errs.get(name, 0.0), err)

    # quantize / dequantize: bit-exact with the codec's formula
    x = torch.from_numpy(quant_input(dev.index, (4, 212, 340, 3))).to(dev)
    want = tq.quantize_tensor(x, 8)
    for codes, params in (QK.launch_quantize(x, 8), ops.quantize(x, 8)):
        same("quantize", [codes, params[0], params[1]],
             [want.tensor, want.scale.reshape(()), want.zero_point.reshape(
                 ())])
    deq = tq.dequantize_tensor(want)
    scale = want.scale.reshape(1).contiguous()
    zp = want.zero_point.reshape(1).contiguous()
    for got in (QK.launch_dequantize(want.tensor, scale, zp),
                ops.dequantize(want.tensor, scale, zp)):
        same("dequantize", got, deq)

    # RoIAlign forwards on float32, bfloat16 and int8 tables, the level
    # quantizer, and the backward
    b, n, h, w, c = 2, 150, 256, 512, 256
    boxes = torch.from_numpy(box_mix(rng, b, n, h, w)).to(dev)
    valid = torch.from_numpy(rng.rand(b, n) > 0.3).to(dev)
    feats = [torch.from_numpy(rng.randn(b, h // s, w // s, c)
                              .astype(np.float32)).to(dev)
             for s in (4, 8, 16, 32)]
    for dtype, tag in ((torch.float32, "roi_align"),
                       (torch.bfloat16, "roi_align_bf16")):
        levels = [f.to(dtype) for f in feats]
        want = tra.multiscale_roi_align_batch(levels, boxes, (h, w), 7, 2,
                                              valid)
        for got in (RK.launch_roi_align(levels, boxes, valid, None, (h, w),
                                        7, 2),
                    ops.roi_align(levels, boxes, valid, None, [h, w], 7, 2)):
            if dtype == torch.float32:
                close(tag, got, want, 1e-5)
            else:
                same(tag, got, want)
    tables = tra.quantize_fpn_levels(feats)
    for codes, scales in (RK.launch_quantize_levels(feats),
                          ops.quantize_levels(feats)):
        same("quantize_levels", list(codes) + [scales],
             list(tables[0]) + [tables[1]])
    want = tra.multiscale_roi_align_batch(feats, boxes, (h, w), 7, 2, valid,
                                          quant=tables)
    for got in (RK.launch_roi_align(tables[0], boxes, valid, tables[1],
                                    (h, w), 7, 2),
                ops.roi_align(list(tables[0]), boxes, valid, tables[1],
                              [h, w], 7, 2)):
        same("roi_align_int8", got, want)
    cot = torch.randn((b, n, 7, 7, c), generator=gen, device=dev)
    for dtype, tag in ((torch.float32, "roi_align_bwd_f32"),
                       (torch.bfloat16, "roi_align_bwd")):
        ref = [f.to(dtype).requires_grad_(True) for f in feats]
        want = torch.autograd.grad(tra.multiscale_roi_align_batch(
            ref, boxes, (h, w), 7, 2, valid), ref, cot.to(dtype))
        got_in = [f.to(dtype).requires_grad_(True) for f in feats]
        got = torch.autograd.grad(RK.roi_align_train(
            got_in, boxes, (h, w), 7, 2, valid), got_in, cot.to(dtype))
        top = max(float(g.float().abs().max()) for g in want)
        # atomics add in another order: float32 within 1e-5 of the
        # largest gradient, bfloat16 within one bf16 ulp of it
        tol = 1e-5 if dtype == torch.float32 else bf16_ulp(top) / top
        for g, r in zip(got, want):
            on_card(g)
            err = float((g.float() - r.float()).abs().max()) / top
            check(err <= tol, f"{tag} on {dev}: {err} of the largest "
                  f"gradient (tol {tol})")
            errs[tag] = max(errs.get(tag, 0.0), err)

    # the stem: forwards and dW, float32 and bfloat16
    xs = torch.randn((2, 3, 832, 1344), generator=gen, device=dev)
    weight = torch.randn((64, 3, 7, 7), generator=gen, device=dev) * 0.1
    sc = torch.rand(64, generator=gen, device=dev) + 0.5
    bias = torch.randn(64, generator=gen, device=dev) * 0.1
    for dtype, tag in ((torch.float32, "stem"), (torch.bfloat16,
                                                 "stem_bf16")):
        xd = xs.to(dtype)
        want, conv = ts.stem_forward(xd, weight, sc, bias, with_conv=True)
        for got in (SK.launch_stem_fwd(xd, weight, sc, bias),
                    ops.stem_fwd(xd, weight, sc, bias)):
            close(f"{tag}_fwd", got, want, fwd_tol(dtype, want))
        out, res = SK.stem_fwd_res(xd, weight, sc, bias)
        close(f"{tag}_fwd_res", out, want, fwd_tol(dtype, want))
        close(f"{tag}_fwd_res", res, conv, fwd_tol(dtype, conv))
        g = torch.randn(conv.shape, generator=gen, device=dev).to(dtype)
        close(f"{tag}_dw", SK.stem_dw(xd, g), ts.stem_weight_grad(xd, g),
              STEM_DW_TOL)

    # B6: the int8 convs on both main loops, every epilogue mode, bit for
    # bit
    for shape, cout, k, stride, pad in (((2, 52, 84, 64), 128, 3, 1, 1),
                                        ((2, 37, 53, 3), 64, 2, 1, 0)):
        q = torch.randint(-128, 128, shape, generator=gen, device=dev,
                          dtype=torch.int8)
        qw = torch.randint(-127, 128, (cout, k, k, shape[3]), generator=gen,
                           device=dev, dtype=torch.int8)
        same("int8_conv", IC.int8_conv(q, qw, stride, pad),
             IC.int8_conv_plain(q, qw, stride, pad))
        for _, mode, relu, zp_in, identity, features in INT8_EPILOGUE_CASES:
            kw = int8_epilogue(gen, q, qw, stride, pad, 1, mode, relu,
                               zp_in, identity, features)
            got = IC.int8_conv_requant(q, qw, stride, pad, 1, **kw)
            on_card(got if isinstance(got, torch.Tensor) else
                    [t for t in got if t is not None])
            check(int8_outputs_equal(got, IC.int8_conv_requant_plain(
                q, qw, stride, pad, 1, **kw)),
                f"int8_conv_requant ({mode}) on {dev} differs from its "
                "plain version")
            errs["int8_conv_requant"] = 0.0

    # NMS: the box head's categories and the RPN's levels
    bx, scs, vd, cats = nms_problem(rng, 2, 4096, 90, True)
    bx, scs, vd, cats = (t.to(dev) for t in (bx, scs, vd, cats))
    want = NMS.nms_plain(bx, scs, vd, cats, 0.5)
    for got in (NMS.launch_nms_keep(bx, scs, vd, cats, 0.5),
                ops.nms_keep(bx, scs, vd, cats, 0.5)):
        same("nms_keep", got, want)
    sizes = list(NMS_LEVELS[0])
    bx, scs, vd, _ = nms_problem(rng, 2, sum(sizes), 0, False)
    bx, scs, vd = (t.to(dev) for t in (bx, scs, vd))
    want = NMS.nms_levels_plain(bx, scs, vd, sizes, 0.7)
    for got in (NMS.launch_nms_keep_levels(bx, scs, vd, sizes, 0.7),
                ops.nms_keep_levels(bx, scs, vd, sizes, 0.7)):
        same("nms_keep_levels", got, want)
    torch.cuda.synchronize(dev)
    return errs


# ------------------------------------------------------------- helpers


def save_start(path: str, model: torch.nn.Module, best: float = -1.0) -> None:
    """``model``'s weights as a runner checkpoint whose best value is
    ``best``: a runner resumes from it, and -1 makes the first epoch's
    value (0 or more) the best, so that rank 0 writes the epoch's
    weights back to ``path``."""
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
    params, state = jax_params_from_state_dict(model.state_dict())
    ckpt_util.save_ckpt(path, params=params, state=state, best_value=best)


def ckpt_state(path: str) -> dict:
    """A checkpoint's tensors by the port's names, on the CPU."""
    from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
    payload = ckpt_util.load_ckpt(path)
    return {k: torch.as_tensor(np.asarray(v)).cpu() for k, v in
            state_dict_from_jax(payload["params"],
                                payload.get("state") or {}).items()}


def split_of(img_dir: str, ann: str, keep_empty: bool = True) -> dict:
    return {"images": img_dir, "annotations": ann,
            "remove_non_annotated_imgs": not keep_empty,
            "jpeg_quality": None}


def local_mesh(cards):
    """The runners' ``devices`` for the local mode on ``cards``: None on
    every visible card, each once (the runners' default), else the list
    (cards that repeat share over gloo)."""
    if len({c.index for c in cards}) == len(cards) == \
            torch.cuda.device_count():
        return None
    return list(cards)


def compare_moves(start: dict, got: dict, want: dict, names, tol: float,
                  what: str, zero_grad: dict = None) -> list:
    """Each leaf's move from ``start`` in ``got`` against its move in
    ``want`` (L2 norms), worst first.  The leaves of ``zero_grad`` (name ->
    bound), whose gradient is zero (a bias before a train-mode BatchNorm,
    which subtracts what it adds) and which move by float noise and weight
    decay alone, each element within the bound instead."""
    ratios = []
    for name in names:
        moved = want[name] - start[name]
        g = got[name] - start[name]
        if name in (zero_grad or {}):
            check(float((g - moved).abs().max()) <= zero_grad[name],
                  f"{what}: {name} apart by more than {zero_grad[name]}")
            continue
        ratios.append((rel(g, moved), name))
    ratios.sort(reverse=True)
    check(ratios[0][0] <= tol, f"{what}: {ratios[0][1]} moved "
          f"{ratios[0][0]} of the reference's move away from it (tol {tol})")
    return ratios


def bn_stat_err(got: dict, want: dict, key: str) -> float:
    """A BatchNorm statistic's distance from ``want``'s: a variance's over
    its norm, a mean's over the norm of the standard deviation beside it
    (a mean near 0 has no relative precision of its own)."""
    if key.endswith("running_var"):
        scale = want[key].double().norm()
    else:
        scale = want[key[:-len("mean")] + "var"].double().sqrt().norm()
    return float((got[key].double() - want[key].double()).norm() / scale)


def worst(ratios) -> str:
    return ", ".join(f"{n} {r:.3e}" for r, n in ratios[:3])


def compare_steps(got, want, what: str, first: float, later: float) -> None:
    """Logged (loss, terms) of each step against the reference's."""
    check(len(got) == len(want), f"{what}: {len(got)} steps, the reference "
          f"{len(want)}")
    for i, ((loss, terms), (w_loss, w_terms)) in enumerate(zip(got, want)):
        tol = first if i == 0 else later
        for name, a, b in [("loss", loss, w_loss)] + [
                (k, terms[k], w_terms[k]) for k in w_terms]:
            check(abs(a - b) <= tol * abs(b), f"{what} step {i} {name}: "
                  f"{a} against the reference's {b} (tol {tol})")


def shard_average(model, step, shards, seed: int, loss_fn) -> tuple:
    """One update of ``step``'s optimizer from the average of the shards'
    gradients and float buffers (``lax.pmean``), each shard's forward
    from the same buffers with its rank's draws (``fold_in(seed, r)``).
    ``loss_fn(batch, targets, draw) -> (loss, terms)``.  Returns the mean
    loss and terms, and the averaged gradient's leaf norms."""
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.parallel.train_step import uniform_draw
    dev = next(model.parameters()).device
    start = {n: b.clone() for n, b in model.named_buffers()}
    params = [p for g in step.optimizer.param_groups for p in g["params"]]
    grads, buffers, losses, terms = [], [], [], []
    for r, (batch, targets) in enumerate(shards):
        model.load_state_dict(start, strict=False)
        step.optimizer.zero_grad(set_to_none=True)
        draw = uniform_draw(torch.Generator(device=dev).manual_seed(
            multihost.fold_in(seed, r)))
        loss, t = loss_fn(batch, targets, draw)
        loss.backward()
        grads.append([p.grad.clone() for p in params])
        buffers.append({n: b.clone() for n, b in model.named_buffers()
                        if b.is_floating_point()})
        losses.append(float(loss.detach()))
        terms.append({k: float(v.detach()) for k, v in t.items()})
    n = len(shards)
    for i, p in enumerate(params):
        p.grad = sum(g[i] for g in grads) / n
    with torch.no_grad():
        for name, b in model.named_buffers():
            if b.is_floating_point():
                b.copy_(sum(bf[name] for bf in buffers) / n)
    norms = [float(torch.linalg.vector_norm(p.grad.float())) for p in params]
    step.apply_update()
    return (sum(losses) / n, {k: sum(t[k] for t in terms) / n
                               for k in terms[0]}), norms


def trainable(model) -> dict:
    return {n: p.detach().cpu().clone() for n, p in model.named_parameters()
            if p.requires_grad}


# ------------------------------------- (b) the local mode: distillation


def _bench_worker(batch: int, steps: int, collective_steps: int,
                  device: torch.device) -> dict:
    """A local worker's share of the bench's workload: the shipped loop
    (``runner_bench.measure_runner_loop``) at ``batch`` images a card;
    then a short run with the card synchronised around each all-reduce."""
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.tools import runner_bench
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    out = runner_bench.measure_runner_loop(batch=batch, steps=steps,
                                           hw=BUCKETS[0], device=device)
    reduce_ms, grads_ms = [], []
    multihost.all_reduce_ = _card_timed(multihost.all_reduce_, reduce_ms)
    multihost.all_reduce_grads = _card_timed(multihost.all_reduce_grads,
                                             grads_ms)
    runner_bench.measure_runner_loop(batch=batch, steps=collective_steps,
                                     hw=BUCKETS[0], device=device)
    return {"bench": out, "reduce_ms": reduce_ms, "grads_ms": grads_ms,
            "steps": 2 * collective_steps}


def local_distill_phase(root: str, card: str, cards) -> dict:
    """(b): see the module docstring."""
    from hnd_ghnd_tpu_torch.parallel import mesh
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    from hnd_ghnd_tpu_torch.tools import runner_bench
    dev = cards[0]
    root = os.path.join(root, "local_distill")
    fx = write_runner_fixture(root, np.random.RandomState(SEED + 30),
                              {"train": LOCAL_TRAIN, "val": LOCAL_VAL})
    teacher, student = runner_models(dev)
    names = [n for n, p in student.named_parameters() if p.requires_grad]
    ckpts = {k: os.path.join(root, f"{k}.pt")
             for k in ("teacher", "local", "one")}
    save_start(ckpts["teacher"], teacher, 0.0)
    save_start(ckpts["local"], student)
    save_start(ckpts["one"], student)
    start = ckpt_state(ckpts["one"])
    val = split_of(*fx["val"])
    config = {"dataset": {"name": "fixture", "num_workers": 4, "splits": {
        "train": split_of(*fx["train"], keep_empty=False), "val": val,
        "test": val}},
        "teacher_model": dict(TEACHER_MODEL, ckpt=ckpts["teacher"]),
        "student_model": dict(STUDENT_MODEL, ckpt=ckpts["local"]),
        "train": dict(TRAIN, num_epochs=1, batch_size=LOCAL_BATCH),
        "test": {"batch_size": 1}, "tpu": GHND_TPU}
    gt = os.path.join(root, "instances_val_teacher.json")
    n_gt, _, _ = teacher_annotations(teacher, config, gt)
    val = dict(val, annotations=gt)
    config["dataset"]["splits"].update(val=val, test=val)
    del teacher, student
    torch.cuda.empty_cache()

    flags = ["--config", GHND_YAML, "-skip_teacher_eval", "-student_only"]
    t0 = time.perf_counter()
    loc = mimic_runner.run(config, mimic_runner.get_argparser().parse_args(
        flags + ["-distill", "--device", "cuda"]), local_mesh(cards))
    wall_local = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = mimic_runner.run(
        dict(config, student_model=dict(STUDENT_MODEL, ckpt=ckpts["one"])),
        mimic_runner.get_argparser().parse_args(
            flags + ["-distill", "--device", str(dev)]))
    wall_one = time.perf_counter() - t0
    steps_l = [s[1:3] for s in loc["distill"]["steps"]]
    steps_o = [s[1:3] for s in one["distill"]["steps"]]
    want_steps = LOCAL_TRAIN // LOCAL_BATCH
    check(len(steps_o) == want_steps, f"one process: {len(steps_o)} steps, "
          f"want {want_steps}")
    compare_steps(steps_l, steps_o, "local mode", LOSS_TOL_FIRST,
                  LOSS_TOL_LATER)
    check(loc["distill"]["epochs"][0]["saved"]
          and one["distill"]["epochs"][0]["saved"],
          "the epoch's checkpoint was not written")
    got, want = ckpt_state(ckpts["local"]), ckpt_state(ckpts["one"])
    lr = float(TRAIN["optimizer"]["params"]["lr"])
    moves = compare_moves(start, got, want, names, MP_MOVE_TOL,
                          "local mode", dict.fromkeys(
                              MP_ZERO_GRAD, 2 * lr * want_steps))
    stats = sorted(
        ((bn_stat_err(got, want, k), k) for k in want
         if k.startswith("backbone.body.layer1.") and k.endswith(
             ("running_mean", "running_var"))
         and not torch.equal(want[k], start[k])), reverse=True)
    check(stats and stats[0][0] <= BN_STATS_TOL, f"local mode: BatchNorm "
          f"statistics {stats[:1]} (tol {BN_STATS_TOL})")
    # the merged COCOeval of the one process's checkpoint: the test split
    # shared image by image over the cards
    t0 = time.perf_counter()
    again = mimic_runner.run(
        dict(config, student_model=dict(STUDENT_MODEL, ckpt=ckpts["one"])),
        mimic_runner.get_argparser().parse_args(
            flags + ["--device", "cuda"]), local_mesh(cards))
    wall_eval = time.perf_counter() - t0
    check(again["student"]["stats"] == one["student"]["stats"],
          f"the merged COCOeval of one checkpoint on {len(cards)} cards "
          f"{again['student']['stats']['bbox']} is not one card's "
          f"{one['student']['stats']['bbox']}")
    log(f"[b] mimic_runner -distill, local mode on {len(cards)} cards "
        f"({wall_local:.3f} s) against one process on one card "
        f"({wall_one:.3f} s) at global batch {LOCAL_BATCH}: losses "
        + " ".join(f"{a[0]:.6e}/{b[0]:.6e}" for a, b in zip(steps_l,
                                                               steps_o))
        + f"; moves worst {worst(moves)} (tol {MP_MOVE_TOL}); BatchNorm "
        f"statistics worst {worst(stats)} (tol {BN_STATS_TOL}); val mAP "
        f"{loc['distill']['epochs'][0]['val_map']:.6f} / "
        f"{one['distill']['epochs'][0]['val_map']:.6f} on {n_gt} teacher "
        f"boxes; the one-card checkpoint's test COCOeval on "
        f"{len(cards)} cards equals one card's "
        + " ".join(f"{v:.6f}" for v in one["student"]["stats"]["bbox"])
        + f" ({wall_eval:.3f} s)")

    # the bench's workload: six images a card, and all of it on one card
    per_card = BENCH_BATCH // len(cards)
    t0 = time.perf_counter()
    multi = mesh.launch_local(_bench_worker, cards,
                              (per_card, BENCH_STEPS, COLLECTIVE_STEPS))
    wall_multi = time.perf_counter() - t0
    os.environ["HND_TPU_PALLAS_STEM"] = "1"
    try:
        single = runner_bench.measure_runner_loop(
            batch=BENCH_BATCH, steps=BENCH_STEPS, hw=BUCKETS[0], device=dev)
    finally:
        os.environ["HND_TPU_PALLAS_STEM"] = "0"
    torch.cuda.empty_cache()
    bench = multi["bench"]
    ips_multi = bench["value"] * len(cards)
    grads = statistics.median(multi["grads_ms"])
    bns = (sum(multi["reduce_ms"]) - sum(multi["grads_ms"])) / multi["steps"]
    for rec in (bench, single):
        check(np.isfinite(rec["value"]) and rec["value"] > 0, "bench rate")
    sm, so = bench["step_ms"], single["step_ms"]
    log(f"[b] {card}: the bench's workload (bf16, batch {BENCH_BATCH}, "
        f"832x1344, {BENCH_STEPS} steps an epoch, epoch 2): {len(cards)} "
        f"cards {ips_multi:.2f} img/s ({per_card} a card; step ms median "
        f"{sm['median']:.3f}, min {sm['min']:.3f}, max {sm['max']:.3f}; "
        f"peak {bench['peak_memory_gib']:.2f} GiB a card; host syncs in "
        f"the window {bench['window_syncs']}), one card "
        f"{single['value']:.2f} img/s (step ms median {so['median']:.3f}, "
        f"min {so['min']:.3f}, max {so['max']:.3f}); scaling "
        f"{ips_multi / single['value']:.3f}x; all-reduce a step with the "
        f"card synchronised around it (rank 0, {multi['steps']} steps): "
        f"the gradient {grads:.3f} ms (median), the BatchNorms' statistics "
        f"{bns:.3f} ms; spawn to exit {wall_multi:.3f} s")
    return {"img_s": {"cards": ips_multi, "one": single["value"]},
            "step_ms": {"cards": bench["step_ms"], "one": single["step_ms"]},
            "allreduce_ms": {"grads_median": grads, "bn_per_step": bns},
            "peak_gib": {"cards": bench["peak_memory_gib"],
                         "one": single["peak_memory_gib"]},
            "moves_worst": moves[0][0], "bn_stats_worst": stats[0][0],
            "walls_s": {"local": wall_local, "one": wall_one,
                        "eval": wall_eval, "bench": wall_multi}}


# ------------------------------------------ (c) four ranks over NCCL


def _nccl_rank(rank: int, tasks: list, cards: list, root: str,
               results) -> None:
    """One rank of ``ranks_phase``, in a process of its own: puts (rank,
    its records) on ``results``, or (rank, the traceback)."""
    try:
        results.put((rank, _nccl_rank_run(rank, tasks, cards, root)))
    except Exception:
        results.put((rank, traceback.format_exc()))


def _nccl_rank_run(rank: int, tasks: list, cards: list, root: str) -> dict:
    """Each task (name, runner, argv, config, port) through the runner's
    ``run`` with torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) and ``--dist_url env://``: the runner makes
    its NCCL group on card LOCAL_RANK.  Where ranks share a card, a gloo
    group made here instead.  Records each task's logged steps, the first
    update's gradient norms after the ranks' reduction, the group, and
    (rank 0) the trained parameters in ``root``/<task>_rank0.pt."""
    import importlib
    import torch.distributed as dist
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.parallel import multihost
    from hnd_ghnd_tpu_torch.parallel.train_step import (DetectionStep,
                                                        DistillStep)
    check(_build.load() is not None, "kernel library did not load")
    dev = cards[rank]
    distinct = len({c.index for c in cards}) == len(cards)
    out = {}
    for name, runner, argv, config, port in tasks:
        module = importlib.import_module(
            f"hnd_ghnd_tpu_torch.runners.{runner}")
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(dev.index),
                          WORLD_SIZE=str(len(cards)),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        if not distinct:
            multihost.init_distributed_mode(f"tcp://127.0.0.1:{port}",
                                            len(cards), rank, dev,
                                            backend="gloo",
                                            timeout_s=MP_TIMEOUT_S)
        args = module.get_argparser().parse_args(
            argv + ["--dist_url", "env://",
                    "--device", "cuda" if distinct else str(dev)])
        cls = DetectionStep if runner == "coco_runner" else DistillStep
        norms: list = []
        _record_grad_norms(cls, norms)
        fn_name = "train_coco" if runner == "coco_runner" else "distill_coco"
        loop = getattr(module, fn_name)
        captured = {}

        def capture(*a, **k):
            hist = loop(*a, **k)
            model = a[0] if runner == "coco_runner" else a[1]
            captured.update(params=trainable(model),
                            backend=dist.get_backend(),
                            world=dist.get_world_size())
            return hist

        setattr(module, fn_name, capture)
        try:
            result = module.run(config, args)
        finally:
            setattr(module, fn_name, loop)
            del cls.apply_update     # the base class's again
        if not distinct:
            multihost.destroy()
        hist = result["train" if runner == "coco_runner" else "distill"]
        if rank == 0:
            torch.save(captured["params"],
                       os.path.join(root, f"{name}_rank0.pt"))
        out[name] = {"steps": [tuple(s[1:3]) for s in hist["steps"]],
                     "step_ms": [s[3] for s in hist["steps"]],
                     "grad_norms": norms[0].tolist(),
                     "backend": captured["backend"],
                     "world": captured["world"]}
    return out


def shard_batches(config: dict, kind: str, world: int, dev):
    """Each shard's first train batch on ``dev`` (the shard's rank
    loader), as (batch, targets)."""
    from hnd_ghnd_tpu_torch.runners import common
    out = []
    for r in range(world):
        loader = common.loaders_from_config(config, kind, RANK_BATCH,
                                            shard_index=r,
                                            num_shards=world)[0]
        batch, targets, _ = next(iter(loader))
        out.append((common.to_device(batch, dev),
                    common.to_device(targets, dev)))
    return out


def concatenated_reference(config: dict, world: int, dev) -> tuple:
    """One process's distill steps on the ranks' batches concatenated,
    step by step (the global batch): (the logged (loss, terms) of each
    step, the first update's gradient norms, the trained parameters)."""
    import itertools
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import common, mimic_runner
    teacher = get_model(config["teacher_model"], seed=SEED, device=dev)
    student = get_model(config["student_model"], seed=SEED + 1, device=dev)
    loaders = [common.loaders_from_config(config, student.kind, RANK_BATCH,
                                          shard_index=r, num_shards=world)[0]
               for r in range(world)]
    step = mimic_runner.make_step(teacher, student, config, len(loaders[0]))
    norms: list = []
    _record_grad_norms(step, norms)
    student.train()
    steps = []
    for items in zip(*(itertools.islice(loader, len(loader))
                       for loader in loaders)):
        images = np.concatenate([b["images"] for b, _, _ in items])
        loss, terms = step(common.to_device({"images": images}, dev))
        steps.append((float(loss), {k: float(v) for k, v in terms.items()}))
    return steps, norms[0].tolist(), trainable(student)


def bf16_against_f32(what: str, start: dict, names, ranks: tuple,
                     one: tuple, f32: tuple, zero_grad: dict) -> dict:
    """The ranks' bfloat16 run and one process's, each (reduced gradient
    norms, trained parameters), against one float32 process on the same
    weights and batches, leaf by leaf: the gradient's norm and the move
    from ``start``, each as a fraction of float32's.  The ranks' worst
    must be within BF16_RANK_FACTOR of one process's (at least one bf16
    ulp): the ranks lose no precision that one process does not."""
    out = {}
    for kind in ("gradient norms", "moves"):
        errs = {}
        for tag, (norms, params) in (("ranks", ranks), ("one process", one)):
            if kind == "moves":
                errs[tag] = compare_moves(start, params, f32[1], names,
                                          float("inf"), what, zero_grad)
            else:
                errs[tag] = sorted(((abs(g - w) / max(w, 1e-30), n)
                                    for n, g, w in zip(names, norms, f32[0])
                                    if n not in zero_grad), reverse=True)
        bound = BF16_RANK_FACTOR * max(errs["one process"][0][0], BF16_ULP)
        check(errs["ranks"][0][0] <= bound, f"{what}: the ranks' bf16 "
              f"{kind} {errs['ranks'][0][0]} ({errs['ranks'][0][1]}) of "
              f"float32's away from it, one process's "
              f"{errs['one process'][0][0]} (tol {bound})")
        log(f"[c] {what} {kind} against one float32 process: ranks worst "
            f"{worst(errs['ranks'])}; one bf16 process worst "
            f"{worst(errs['one process'])} (the ranks' tol {bound:.3e})")
        out[kind] = {tag: e[0][0] for tag, e in errs.items()}
    return out


def ranks_phase(root: str, card: str, cards) -> dict:
    """(c): see the module docstring.  Each rank has RANK_BATCH images a
    step (global batch 16) of its shard of the train split; the start
    checkpoints' best value is 1, so that no epoch writes over them."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.models.layers import per_process_batch_norm
    from hnd_ghnd_tpu_torch.parallel.mesh import free_port
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    from hnd_ghnd_tpu_torch.runners import coco_runner, mimic_runner
    dev, world = cards[0], len(cards)
    root = os.path.join(root, "ranks")
    fx = write_runner_fixture(root, np.random.RandomState(SEED + 40),
                              {"train": NCCL_TRAIN, "val": 4},
                              (RUNNER_SHAPES[0],))
    img_dir, ann = fx["train"]
    one_step = os.path.join(root, "instances_train_one_step.json")
    subset_annotations(ann, one_step, RANK_BATCH * world)
    teacher, student = runner_models(dev)
    names = {"distill": [n for n, p in student.named_parameters()
                         if p.requires_grad]}
    ckpts = {"teacher": os.path.join(root, "teacher.pt"),
             "student": os.path.join(root, "student.pt")}
    save_start(ckpts["teacher"], teacher, 1.0)
    save_start(ckpts["student"], student, 1.0)
    del teacher, student
    torch.cuda.empty_cache()
    val = split_of(*fx["val"])
    data = {"name": "fixture", "num_workers": 4, "splits": {
        "train": split_of(img_dir, ann, False), "val": val, "test": val}}
    data_one = dict(data, splits=dict(data["splits"], train=split_of(
        img_dir, one_step, False)))
    base = {"dataset": data,
            "teacher_model": dict(TEACHER_MODEL, ckpt=ckpts["teacher"]),
            "student_model": dict(STUDENT_MODEL, ckpt=ckpts["student"]),
            "train": dict(TRAIN, num_epochs=1, batch_size=RANK_BATCH),
            "test": {"batch_size": 1}, "tpu": GHND_TPU}
    configs = {
        "distill_f32": base,
        "distill_bf16": dict(base, tpu=dict(GHND_TPU,
                                            compute_dtype="bfloat16")),
        "distill_org": dict(base, dataset=data_one, train=dict(
            base["train"], criterion=org_criterion())),
        "detection": {"dataset": data_one,
                      "model": dict(ORG_MODEL, ckpt=ckpts["teacher"]),
                      "train": dict(ORG_TRAIN, num_epochs=1,
                                    batch_size=RANK_BATCH),
                      "test": {"batch_size": 1},
                      "tpu": dict(ORG_TPU, compute_dtype="float32")}}
    mimic = ["--config", GHND_YAML, "-distill", "-student_only"]
    tasks = [(name, "coco_runner" if name == "detection" else
              "mimic_runner",
              ["--config", "config/org/faster_rcnn-backbone_resnet50.yaml",
               "-train"] if name == "detection" else mimic, cfg, free_port())
             for name, cfg in configs.items()]
    t0 = time.perf_counter()
    ranks = spawn_ranks(_nccl_rank, world, (tasks, list(cards), root),
                        MP_TIMEOUT_S * len(tasks))
    wall = time.perf_counter() - t0
    start = ckpt_state(ckpts["student"])
    start_det = ckpt_state(ckpts["teacher"])
    lr = float(TRAIN["optimizer"]["params"]["lr"])
    backend = "nccl" if len({c.index for c in cards}) == world else "gloo"
    out = {"wall_s": wall}
    for name, _, _, cfg, _ in tasks:
        recs = [r[name] for r in ranks]
        for r, rec in enumerate(recs):
            check(rec["backend"] == backend and rec["world"] == world,
                  f"{name} rank {r}: group {rec['backend']} of "
                  f"{rec['world']}")
            check(rec["steps"] == recs[0]["steps"], f"{name}: rank {r} "
                  "logged other losses than rank 0")
            check(rec["grad_norms"] == recs[0]["grad_norms"],
                  f"{name}: rank {r}'s reduced gradient is not rank 0's")
        got = torch.load(os.path.join(root, f"{name}_rank0.pt"))
        steps = [(loss, terms) for loss, terms in recs[0]["steps"]]
        if name in ("distill_f32", "distill_bf16"):
            want, norms, params = concatenated_reference(cfg, world, dev)
            f32 = name == "distill_f32"
            compare_steps(steps, want, name,
                          LOSS_TOL_FIRST if f32 else BF16_TOL,
                          LOSS_TOL_LATER if f32 else BF16_TOL)
            if f32:
                grad_tol, move_tol, f32_ref = MP_GRAD_TOL, MP_MOVE_TOL, (
                    norms, params)
            else:
                total = float(np.linalg.norm(norms))
                got_total = float(np.linalg.norm(recs[0]["grad_norms"]))
                check(abs(got_total - total) <= BF16_TOL * total,
                      f"{name}: the reduced gradient's norm {got_total} "
                      f"against the reference's {total} (tol {BF16_TOL})")
                # each leaf: held against float32 (``bf16_against_f32``)
                grad_tol = move_tol = None
                out[name + "_against_f32"] = bf16_against_f32(
                    name, start, names["distill"],
                    (recs[0]["grad_norms"], got), (norms, params), f32_ref,
                    dict.fromkeys(MP_ZERO_GRAD, 2 * lr * len(steps)))
            leaf_names, s0 = names["distill"], start
        else:
            det = name == "detection"
            model = get_model(cfg["model" if det else "student_model"],
                              seed=SEED if det else SEED + 1, device=dev)
            if det:
                step = coco_runner.make_step(model, cfg, 1, 0)

                def loss_fn(batch, targets, draw):
                    with per_process_batch_norm():
                        terms = model(dict(batch, images=images_to_compute(
                            batch["images"], torch.float32)), targets, draw)
                    return sum(terms.values()), terms
            else:
                teacher = get_model(cfg["teacher_model"], seed=SEED,
                                    device=dev)
                step = mimic_runner.make_step(teacher, model, cfg, 1, 0)

                def loss_fn(batch, targets, draw):
                    with per_process_batch_norm():
                        return step.box.loss(images_to_compute(
                            batch["images"], torch.float32), targets, draw,
                            batch["image_sizes"])
            model.train()
            one, norms = shard_average(model, step, shard_batches(
                cfg, model.kind, world, dev), 0, loss_fn)
            want, params = [one], trainable(model)
            compare_steps(steps, want, name, LOSS_TOL_FIRST, LOSS_TOL_FIRST)
            grad_tol = MP_GRAD_TOL
            move_tol = AVG_MOVE_TOL if det else MP_MOVE_TOL
            leaf_names = [n for n, p in model.named_parameters()
                          if p.requires_grad]
            s0 = start_det if det else start
            del model, step
        grads = sorted(((abs(g - w) / max(w, 1e-30), n) for n, g, w in zip(
            leaf_names, recs[0]["grad_norms"], norms)
            if n not in MP_ZERO_GRAD), reverse=True)
        check(grad_tol is None or grads[0][0] <= grad_tol,
              f"{name}: {grads[0][1]}'s reduced gradient norm is "
              f"{grads[0][0]} of the reference's away from it (tol "
              f"{grad_tol})")
        moves = compare_moves(s0, got, params, leaf_names,
                              move_tol if move_tol is not None else
                              float("inf"), name,
                              dict.fromkeys(MP_ZERO_GRAD,
                                            2 * lr * len(steps)))
        torch.cuda.empty_cache()
        ms = recs[0]["step_ms"]
        log(f"[c] {name}: {world} ranks over {backend}, {len(steps)} "
            f"step(s) at global batch {RANK_BATCH * world}, rank 0's step "
            "ms " + " / ".join(f"{v:.3f}" for v in ms) + "; losses "
            + " ".join(f"{a[0]:.6e}/{b[0]:.6e}" for a, b in zip(steps,
                                                                   want))
            + f" (ranks/one process); reduced gradient norms worst "
            f"{worst(grads)} (tol {grad_tol or 'none: against float32'}); "
            f"moves worst {worst(moves)} (tol "
            f"{move_tol or 'none: against float32'})")
        out[name] = {"step_ms": ms, "grads_worst": grads[0][0],
                     "moves_worst": moves[0][0]}
    log(f"[c] {card}: {len(tasks)} runs of {world} ranks, spawn to exit "
        f"{wall:.3f} s")
    return out


# ---------------------------- (d) the local mode: detection and the ext


def rows(tree: dict, k: int, n: int) -> dict:
    """Rows k of n of each tensor of ``tree`` (``put_batch``'s split)."""
    out = {}
    for key, v in tree.items():
        b = v.shape[0] // n
        out[key] = v[k * b:(k + 1) * b]
    return out


def local_train_phase(root: str, card: str, cards) -> dict:
    """(d): see the module docstring."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.models.layers import per_process_batch_norm
    from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
    from hnd_ghnd_tpu_torch.runners import coco_runner, common, ext_runner
    dev, world = cards[0], len(cards)
    root = os.path.join(root, "local_train")
    out = {}

    # coco_runner -train: one step of global batch LOCAL_BATCH
    fx = write_runner_fixture(os.path.join(root, "det"),
                              np.random.RandomState(SEED + 50),
                              {"train": LOCAL_BATCH, "val": 4},
                              (RUNNER_SHAPES[0],))
    teacher, _ = runner_models(dev)
    ckpt = os.path.join(root, "det.pt")
    start_ckpt = os.path.join(root, "det_start.pt")
    save_start(ckpt, teacher)
    save_start(start_ckpt, teacher)
    del teacher
    torch.cuda.empty_cache()
    val = split_of(*fx["val"])
    cfg = {"dataset": {"name": "fixture", "num_workers": 4, "splits": {
        "train": split_of(*fx["train"], keep_empty=False), "val": val,
        "test": val}},
        "model": dict(ORG_MODEL, ckpt=ckpt),
        "train": dict(ORG_TRAIN, num_epochs=1, batch_size=LOCAL_BATCH),
        "test": {"batch_size": 1},
        "tpu": dict(ORG_TPU, compute_dtype="float32", eval_batch_size=4)}
    t0 = time.perf_counter()
    res = coco_runner.run(cfg, coco_runner.get_argparser().parse_args(
        ["--config", "config/org/faster_rcnn-backbone_resnet50.yaml",
         "-train", "--device", "cuda"]), local_mesh(cards))
    wall = time.perf_counter() - t0
    hist = res["train"]
    check(len(hist["steps"]) == 1 and hist["epochs"][0]["saved"],
          f"coco_runner local mode: {len(hist['steps'])} steps, saved "
          f"{hist['epochs'][0]['saved']}")
    model = get_model(dict(cfg["model"], ckpt=start_ckpt), seed=SEED,
                      device=dev)
    step = coco_runner.make_step(model, cfg, 1, 0)
    model.train()
    batch, targets, _ = next(iter(common.loaders_from_config(
        cfg, model.kind, LOCAL_BATCH)[0]))
    batch, targets = (common.to_device(t, dev) for t in (batch, targets))

    def loss_fn(b, t, draw):
        with per_process_batch_norm():
            terms = model(dict(b, images=images_to_compute(
                b["images"], torch.float32)), t, draw)
        return sum(terms.values()), terms

    (loss, terms), _ = shard_average(
        model, step, [(rows(batch, k, world), rows(targets, k, world))
                      for k in range(world)], 0, loss_fn)
    compare_steps([tuple(hist["steps"][0][1:3])], [(loss, terms)],
                  "coco_runner local mode", LOSS_TOL_FIRST, LOSS_TOL_FIRST)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    moves = compare_moves(ckpt_state(start_ckpt), ckpt_state(ckpt),
                          trainable(model), names, AVG_MOVE_TOL,
                          "coco_runner local mode")
    del model, step
    torch.cuda.empty_cache()
    log(f"[d] coco_runner -train, local mode on {world} cards ({wall:.3f} "
        f"s): loss {hist['steps'][0][1]:.6e} against the average of "
        f"{world} one-process shard steps {loss:.6e}; moves worst "
        f"{worst(moves)} (tol {AVG_MOVE_TOL}); step "
        f"{hist['steps'][0][3]:.3f} ms")
    out["coco_runner"] = {"moves_worst": moves[0][0], "wall_s": wall}

    # ext_runner -train: the filter on the global batch
    ext_root = os.path.join(root, "ext")
    fx = write_runner_fixture(ext_root, np.random.RandomState(SEED + 60),
                              {"train": LOCAL_TRAIN, "val": LOCAL_VAL})
    rng = np.random.RandomState(SEED + 61)
    splits = {}
    for name, (img_dir, ann) in fx.items():
        kp = os.path.join(ext_root, f"person_keypoints_{name}.json")
        write_keypoint_annotations(ann, kp, rng)
        half = os.path.join(ext_root, f"ext_{name}.json")
        drop_every_second_image(kp, half)
        splits[name] = split_of(img_dir, half)
    splits["test"] = splits["val"]
    model_cfg = copy.deepcopy(EXT_MODEL)
    model_cfg["ckpt"] = os.path.join(ext_root, "student.pt")
    student = live_norms_(get_model(dict(KEYPOINT_STUDENT_MODEL, ckpt=None),
                                    seed=SEED + 62, device=dev), SEED + 62)
    save_start(model_cfg["ckpt"], student)
    del student
    model_cfg["backbone"]["ext_config"]["ckpt"] = os.path.join(
        ext_root, "none.pt")
    model = get_model(model_cfg, seed=SEED, device=dev)
    ext_ckpts = {k: os.path.join(ext_root, f"ext_{k}.pt")
                 for k in ("start", "local", "one")}
    for path in ext_ckpts.values():
        save_start(path, model)
    names = [n for n, _ in model.named_parameters()
             if n.startswith(ext_runner.EXT_PREFIX)]
    # the filter's conv biases, each before a train-mode BatchNorm
    layers = list(model.backbone.body.layer1.encoder.ext_classifier
                  .extractor)
    zero_bias = [f"{ext_runner.EXT_PREFIX}extractor.{i}.bias"
                 for i, (a, b) in enumerate(zip(layers, layers[1:]))
                 if isinstance(a, torch.nn.Conv2d)
                 and isinstance(b, torch.nn.BatchNorm2d)]
    del model
    torch.cuda.empty_cache()
    runs = {}
    for tag, device, devices in (("local", "cuda", local_mesh(cards)),
                                 ("one", str(dev), None)):
        mc = copy.deepcopy(model_cfg)
        mc["backbone"]["ext_config"]["ckpt"] = ext_ckpts[tag]
        cfg = {"dataset": {"name": "fixture", "num_workers": 4,
                           "splits": splits}, "model": mc,
               "train": dict(EXT_TRAIN, num_epochs=1,
                             batch_size=LOCAL_BATCH),
               "test": {"batch_size": 1}, "tpu": ORG_TPU}
        t0 = time.perf_counter()
        runs[tag] = ext_runner.run(cfg, ext_runner.get_argparser().parse_args(
            ["--config", "config/ext/keypoint_rcnn-backbone_ext_resnet50-"
             "b3ch.yaml", "-train", "--device", device]), devices)
        runs[tag]["wall_s"] = time.perf_counter() - t0
        check(runs[tag]["train"]["epochs"][0]["saved"],
              f"ext_runner ({tag}): the epoch's filter was not written")
    got = [tuple(s[1:3]) for s in runs["local"]["train"]["steps"]]
    want = [tuple(s[1:3]) for s in runs["one"]["train"]["steps"]]
    compare_steps(got, want, "ext_runner local mode", LOSS_TOL_FIRST,
                  LOSS_TOL_LATER)
    s0, ref = ckpt_state(ext_ckpts["start"]), ckpt_state(ext_ckpts["one"])
    # such a bias within AVG_MOVE_TOL of its conv weight's largest move
    moves = compare_moves(s0, ckpt_state(ext_ckpts["local"]), ref, names,
                          AVG_MOVE_TOL, "ext_runner local mode", {
                              n: AVG_MOVE_TOL * float((
                                  ref[n[:-4] + "weight"]
                                  - s0[n[:-4] + "weight"]).abs().max())
                              for n in zero_bias})
    log(f"[d] ext_runner -train, local mode on {world} cards "
        f"({runs['local']['wall_s']:.3f} s) against one process on the "
        f"global batch {LOCAL_BATCH} ({runs['one']['wall_s']:.3f} s): "
        f"losses " + " ".join(f"{a[0]:.6e}/{b[0]:.6e}" for a, b in
                               zip(got, want))
        + f"; the filter's moves worst {worst(moves)} (tol {AVG_MOVE_TOL}); "
        f"test (accuracy, recall, specificity, ROC-AUC) "
        f"{runs['local']['test']['scores']} / "
        f"{runs['one']['test']['scores']}")
    out["ext_runner"] = {"moves_worst": moves[0][0],
                         "wall_s": runs["local"]["wall_s"]}
    return out


# --------------------------------------------- (e) the sharded tail


def wall_ms(fn, cards) -> float:
    """Median wall ms of ``fn`` over TAIL_REPS calls after a warm-up, every
    card synchronised before and after each."""
    def sync():
        for c in {c.index for c in cards}:
            torch.cuda.synchronize(c)
    fn()
    sync()
    times = []
    for _ in range(TAIL_REPS):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sharded_tail_phase(card: str, cards) -> dict:
    """(e): see the module docstring."""
    from hnd_ghnd_tpu_torch.split import export
    from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN
    dev, world = cards[0], len(cards)
    torch.backends.cudnn.deterministic = True
    try:
        _, model = runner_models(dev)
        model.eval().requires_grad_(False)
        split = SplitRCNN(model, 8)
        gen = torch.Generator(device=dev).manual_seed(SEED + 70)
        h, w = BUCKETS[0]
        images = torch.rand((world, h, w, 3), generator=gen, device=dev)
        sizes = torch.tensor([[800, 1333]] * world, dtype=torch.int32,
                             device=dev)
        packets = [split.head_fn(images[i:i + 1]) for i in range(world)]
        sharded = export.load_exported(export.export_sharded_tail(
            model, BUCKETS[0], cards, batch_per_shard=1))
        args = (torch.cat([p[0] for p in packets]),
                torch.stack([p[1] for p in packets]),
                torch.stack([p[2] for p in packets]), sizes)
        both = sharded.call(cards, *args)
        check({d.index for d in sharded._copies} == {c.index for c in cards},
              f"the tail's copies are on {list(sharded._copies)}")
        for i, p in enumerate(packets):
            ref = split.tail_fn(*p[:3], sizes[i:i + 1], BUCKETS[0])
            for k, v in ref.items():
                check(torch.equal(both[k][i:i + 1], v), f"sharded tail "
                      f"shard {i} on {cards[i]}: {k} differs from the "
                      "eager tail on its packet")
        ms_cards = wall_ms(lambda: sharded.call(cards, *args), cards)
        ms_one = wall_ms(lambda: sharded.call([dev] * world, *args), cards)
    finally:
        torch.backends.cudnn.deterministic = False
    del model, sharded
    torch.cuda.empty_cache()
    log(f"[e] {card}: the sharded tail, {world} packets of 1 image at "
        f"{BUCKETS[0]}: shard k on {', '.join(str(c) for c in cards)} "
        f"equals the eager tail on its packet bit for bit; "
        f"{ms_cards:.3f} ms on {world} cards, {ms_one:.3f} ms on one "
        f"(wall to detections on card 0, median of {TAIL_REPS})")
    return {"ms_cards": ms_cards, "ms_one": ms_one}


# ------------------------------------------------------------- main


PHASES = ("kernels", "local_distill", "ranks", "local_train",
          "sharded_tail")


def run_all(cards, out_path=None, phases=PHASES) -> dict:
    """``phases`` (a)-(e) on ``cards`` (card 0 first); raises on the first
    failed check.  Returns their numbers."""
    from hnd_ghnd_tpu_torch import _build
    from hnd_ghnd_tpu_torch.runners.common import configure_precision
    for i, line in enumerate(nvidia_smi(
            "--query-gpu=name,power.limit",
            "--format=csv,noheader").splitlines()):
        log(f"[setup] card {i}: {line}")
    log("[setup] topology:\n" + nvidia_smi("topo", "-m", check_rc=False))
    card = nvidia_smi("--query-gpu=name,power.limit",
                      "--format=csv,noheader").splitlines()[0]
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    check(_build.load() is not None, "kernel library did not load")
    log(f"[build] {_build.build_info['seconds']:.1f} s "
        f"(cached={_build.build_info['cached']})")
    configure_precision(torch.float32)
    root = tempfile.mkdtemp(prefix="chip_multicard_")
    numbers = {}
    try:
        if "kernels" in phases:
            t = time.perf_counter()
            numbers["kernels"] = {str(c): kernels_on_card(c)
                                  for c in cards[1:]}
            log(f"[a] every kernel on {', '.join(str(c) for c in cards[1:])}"
                f" with {torch.cuda.current_device()} current, direct and "
                f"through its op, against its plain version: "
                f"{numbers['kernels']} ({time.perf_counter() - t:.1f} s)")
        for name, phase in (("local_distill", lambda: local_distill_phase(
                root, card, cards)),
                            ("ranks", lambda: ranks_phase(root, card, cards)),
                            ("local_train", lambda: local_train_phase(
                                root, card, cards)),
                            ("sharded_tail", lambda: sharded_tail_phase(
                                card, cards))):
            if name not in phases:
                continue
            t = time.perf_counter()
            numbers[name] = phase()
            log(f"[{name}] {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    numbers["card"] = card
    numbers["seconds"] = time.perf_counter() - t0
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(numbers, f, indent=1, default=str)
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="write the numbers as JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chip_multicard: needs {CARDS} visible cards, found {n}",
              file=sys.stderr)
        return 1
    numbers = run_all([torch.device("cuda", k) for k in range(CARDS)],
                      args.out)
    print(json.dumps({"multicard": numbers}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
