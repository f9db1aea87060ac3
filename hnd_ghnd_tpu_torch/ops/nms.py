"""Exact NMS, batched over images: the CUDA kernels of csrc/nms.cu on the
card, a fixpoint of masked matrix products on the CPU.

Counterpart of hnd_ghnd_tpu/ops/nms.py.  Box j is suppressed iff a kept box
ranked above it (a higher score, or an equal score and a lower index) of
the same category, both valid, overlaps it by more than the threshold.
The relation is a DAG, so its fixpoint is unique: it is greedy NMS in
descending-score order with index tie-break.

Two ops (ops/library.py), each an entry of the kernel on a CUDA tensor and
the plain version on a CPU one:

  * ``nms_keep`` (``hnd_ghnd::nms_keep``): B problems of N boxes with
    optional categories, the box head's;
  * ``nms_keep_levels`` (``hnd_ghnd::nms_keep_levels``): the RPN's levels
    concatenated along dim 1 and their sizes, one entry for all of them:
    each level a chunk of the kernel's problem (levels never suppress each
    other), equal to ``nms_keep`` on each level.

An entry (``_launch``) is three kernels on the device with no host round
trip: the valid boxes sorted into the scan's order, the suppression bits
of same-segment pairs above the diagonal, a blocked greedy scan a segment
a warp.  ``nms_keep.launches`` counts the entries of either op,
``nms_keep_levels.launches`` those of the levels op.  On a CPU tensor the
plain version runs, the port of JAX's ``lax.while_loop``: ``fixpoint``, a
Python loop run to the exact fixpoint, with no cap on the iterations (each
check of convergence reads the device, and ``fixpoint.iterations`` counts
them).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops._oplib import check_device, define, on_card
from hnd_ghnd_tpu_torch.ops.boxes import pairwise_iou

# csrc/nms.cu kMaxBoxes: boxes per problem (a level's, for the levels op)
# the kernel takes
MAX_BOXES = 16384
# csrc/nms.cu kMaxChunks: levels one entry takes
MAX_LEVELS = 8


_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim in ``jax.lax.top_k``'s order: XLA's total
    order of floats (NaN above +inf, +0.0 above -0.0, -NaN below -inf),
    the lower index first on ties (``torch.topk`` promises no tie order,
    and ``torch.sort`` takes -0.0 and 0.0 as equal)."""
    key = x
    if x.is_floating_point():
        # the bits as a signed integer, the negative ones with all but the
        # sign bit flipped: ordered as the total order orders the floats
        bits = x.view(_INT_OF[x.element_size()])
        key = torch.where(bits < 0, bits ^ torch.iinfo(bits.dtype).max, bits)
    _, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(x, -1, idx), idx


def _suppression(boxes, scores, iou_threshold, valid, categories=None):
    """[B, N, N] bool: i suppresses j if i is kept."""
    n = boxes.shape[-2]
    iou = pairwise_iou(boxes, boxes)
    idx = torch.arange(n, device=boxes.device)
    s_i, s_j = scores[..., :, None], scores[..., None, :]
    ranked_above = (s_i > s_j) | ((s_i == s_j) & (idx[:, None] < idx[None, :]))
    sup = (iou > iou_threshold) & ranked_above
    if categories is not None:
        sup &= categories[..., :, None] == categories[..., None, :]
    return sup & valid[..., :, None] & valid[..., None, :]


def fixpoint(sups: Sequence[torch.Tensor],
             valids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Keep masks [B, N_k] for suppression relations [B, N_k, N_k]."""
    mats = [s.float() for s in sups]
    suppressed = [torch.zeros_like(v) for v in valids]
    while True:
        new = [torch.bmm((v & ~s).float()[:, None, :], m)[:, 0] > 0
               for m, v, s in zip(mats, valids, suppressed)]
        fixpoint.iterations += 1
        changed = torch.stack([(a != b).any() for a, b in zip(new, suppressed)])
        suppressed = new
        if not bool(changed.any()):
            return [v & ~s for v, s in zip(valids, suppressed)]


fixpoint.iterations = 0


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
              valid: torch.Tensor, categories: Optional[torch.Tensor],
              iou_threshold: float) -> torch.Tensor:
    """The keep mask [B, N] of the plain version: the fixpoint, on each
    problem's valid boxes alone.  An invalid box neither suppresses nor is
    kept, and the valid boxes keep their index order, so the relation
    among them (each IoU one element of the same elementwise ops, "ranked
    above" with the same tie-break) and its fixpoint are those of the whole
    problem; the [B, N, N] matrices shrink to [1, V_b, V_b]."""
    rows = [valid[b].nonzero()[:, 0] for b in range(valid.shape[0])]
    sups = [_suppression(boxes[b, r][None], scores[b, r][None], iou_threshold,
                         valid[b, r][None],
                         None if categories is None else categories[b, r][None])
            for b, r in enumerate(rows)]
    keeps = fixpoint(sups, [valid[b, r][None] for b, r in enumerate(rows)])
    keep = torch.zeros_like(valid)
    for b, (r, k) in enumerate(zip(rows, keeps)):
        keep[b, r] = k[0]
    return keep


def _checked(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             categories: Optional[torch.Tensor]):
    """The kernel's operands, checked: boxes [B, N, 4] float32 or
    bfloat16, scores [B, N] float32 or bfloat16, valid [B, N] bool,
    categories [B, N] integers (made int64) or None, all on one CUDA
    device and contiguous."""
    dev = boxes.device
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"nms: boxes must be [B, N, 4], got "
                         f"{tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    if boxes.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nms kernel takes float32 or bfloat16 boxes, got "
                        f"{boxes.dtype}")
    if scores.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"nms kernel takes float32 or bfloat16 scores, got "
                        f"{scores.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"nms: valid must be bool, got {valid.dtype}")
    others = [scores, valid] + ([] if categories is None else [categories])
    for t in others:
        if t.device != dev or tuple(t.shape) != (b, n):
            raise ValueError(f"nms: scores, valid and categories must be "
                             f"[{b}, {n}] on {dev}")
    if categories is not None:
        if categories.dtype.is_floating_point or \
                categories.dtype == torch.bool:
            raise TypeError(f"nms: categories must be integers, got "
                            f"{categories.dtype}")
        # an exact conversion
        categories = categories.to(torch.int64).contiguous()
    return (boxes.contiguous(), scores.contiguous(), valid.contiguous(),
            categories)


def _threshold(iou_threshold: float, dtype: torch.dtype) -> float:
    """The plain version compares the IoU with the threshold cast to the
    IoU's (the boxes') dtype."""
    return float(torch.tensor(float(iou_threshold), dtype=dtype))


def _launch(boxes, scores, valid, categories, sizes: Sequence[int],
            thr: float) -> torch.Tensor:
    """One entry of csrc/nms.cu on checked operands whose boxes are cut
    into chunks of ``sizes``; -> keep [B, M] bool."""
    lib = _build.load()
    dev = boxes.device
    b, m = boxes.shape[:2]
    c_sizes = (ctypes.c_int * len(sizes))(*sizes)
    nbytes = ctypes.c_longlong()
    _build.check(lib.hnd_nms_work_bytes(b, len(sizes), c_sizes,
                                        ctypes.addressof(nbytes)),
                 "hnd_nms_work_bytes")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
    keep = torch.empty((b, m), dtype=torch.bool, device=dev)
    with on_card(dev):
        _build.check(lib.hnd_nms_keep(
            boxes.data_ptr(), int(boxes.dtype == torch.bfloat16),
            scores.data_ptr(), int(scores.dtype == torch.bfloat16),
            valid.data_ptr(),
            None if categories is None else categories.data_ptr(), b,
            len(sizes), c_sizes, thr, work.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream), "hnd_nms_keep")
    return keep


def launch_nms_keep(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, categories: Optional[torch.Tensor],
                    iou_threshold: float) -> torch.Tensor:
    """The keep mask [B, N] from the kernel: boxes [B, N, 4] float32 or
    bfloat16, scores [B, N] float32 or bfloat16, valid [B, N] bool,
    categories [B, N] integers or None, all on one CUDA device."""
    boxes, scores, valid, categories = _checked(boxes, scores, valid,
                                                categories)
    b, n = boxes.shape[:2]
    if n > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes a "
                         f"problem, got {n}")
    if b == 0 or n == 0:
        return torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    keep = _launch(boxes, scores, valid, categories, [n],
                   _threshold(iou_threshold, boxes.dtype))
    nms_keep.launches += 1
    return keep


def nms_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: torch.Tensor,
             categories: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact NMS keep mask [B, N] of B problems: boxes [B, N, 4], scores
    [B, N], valid [B, N] bool, optional integer categories [B, N] (boxes
    of different categories never suppress each other)."""
    check_device(boxes, "nms_keep")
    return nms_keep_op(boxes, scores, valid, categories, float(iou_threshold))


# entries of csrc/nms.cu, through either op
nms_keep.launches = 0


def _nms_keep_fake(boxes, scores, valid, categories, iou_threshold):
    return valid.new_empty(valid.shape, dtype=torch.bool)


# exact NMS keep mask [B, N] bool of B problems of N boxes
nms_keep_op = define(
    "nms_keep(Tensor boxes, Tensor scores, Tensor valid, Tensor? categories, "
    "float iou_threshold) -> Tensor",
    nms_plain, launch_nms_keep, _nms_keep_fake)


def _check_levels(m: int, level_sizes: Sequence[int]) -> None:
    if not 0 < len(level_sizes) <= MAX_LEVELS:
        raise ValueError(f"nms_keep_levels takes 1 to {MAX_LEVELS} levels, "
                         f"got {len(level_sizes)}")
    if sum(level_sizes) != m or min(level_sizes) < 0:
        raise ValueError(f"nms_keep_levels: level sizes {list(level_sizes)} "
                         f"do not cut {m} boxes")


def nms_levels_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor, level_sizes: Sequence[int],
                     iou_threshold: float) -> torch.Tensor:
    """The plain version of ``nms_keep_levels``: the fixpoint of each level
    alone (``nms_plain``), the masks concatenated."""
    _check_levels(boxes.shape[1], level_sizes)
    return torch.cat([nms_plain(b, s, v, None, iou_threshold)
                      for b, s, v in zip(boxes.split(level_sizes, 1),
                                         scores.split(level_sizes, 1),
                                         valid.split(level_sizes, 1))], 1)


def launch_nms_keep_levels(boxes: torch.Tensor, scores: torch.Tensor,
                           valid: torch.Tensor, level_sizes: Sequence[int],
                           iou_threshold: float) -> torch.Tensor:
    """The keep mask [B, M] of the levels from one entry of the kernel:
    each level a chunk of the problem, so levels never suppress each
    other and keep their own index order."""
    boxes, scores, valid, _ = _checked(boxes, scores, valid, None)
    b, m = boxes.shape[:2]
    _check_levels(m, level_sizes)
    if max(level_sizes) > MAX_BOXES:
        raise ValueError(f"nms kernel takes at most {MAX_BOXES} boxes a "
                         f"level, got {max(level_sizes)}")
    if b == 0 or m == 0:
        return torch.empty((b, m), dtype=torch.bool, device=boxes.device)
    keep = _launch(boxes, scores, valid, None, list(level_sizes),
                   _threshold(iou_threshold, boxes.dtype))
    nms_keep.launches += 1
    nms_keep_levels.launches += 1
    return keep


def nms_keep_levels(boxes: torch.Tensor, scores: torch.Tensor,
                    iou_threshold: float, valid: torch.Tensor,
                    level_sizes: Sequence[int]) -> torch.Tensor:
    """Exact NMS keep mask [B, M] of the RPN's levels in one call: boxes
    [B, M, 4], scores [B, M] and valid [B, M] are the levels' [B, N_l]
    problems concatenated along dim 1, ``level_sizes`` their N_l.  Equal
    to ``nms_keep`` on each level, concatenated (JAX's per-level
    ``nms_keep_mask``, hnd_ghnd_tpu/models/rpn.py:143)."""
    check_device(boxes, "nms_keep_levels")
    return nms_keep_levels_op(boxes, scores, valid,
                              [int(n) for n in level_sizes],
                              float(iou_threshold))


# entries through the levels op (each also counts on nms_keep.launches)
nms_keep_levels.launches = 0


def _nms_keep_levels_fake(boxes, scores, valid, level_sizes, iou_threshold):
    return valid.new_empty(valid.shape, dtype=torch.bool)


# exact NMS keep mask [B, M] bool of levels concatenated along dim 1
nms_keep_levels_op = define(
    "nms_keep_levels(Tensor boxes, Tensor scores, Tensor valid, "
    "int[] level_sizes, float iou_threshold) -> Tensor",
    nms_levels_plain, launch_nms_keep_levels, _nms_keep_levels_fake)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                categories: torch.Tensor, iou_threshold: float,
                max_outputs: int, valid: torch.Tensor):
    """Category-aware NMS per image over the ``valid`` [B, N] boxes
    [B, N, 4] -> (indices [B, K], keep_valid [B, K]) of the top
    ``max_outputs`` survivors by score."""
    keep = nms_keep(boxes, scores, iou_threshold, valid, categories)
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
    top_scores, top_idx = stable_topk(masked, max_outputs)
    return top_idx, top_scores > neg_inf
