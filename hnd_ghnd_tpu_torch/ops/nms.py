"""Exact NMS as a fixpoint of masked matrix products, batched over images.

Counterpart of hnd_ghnd_tpu/ops/nms.py.  Box j is suppressed iff a kept box
ranked above it overlaps it by more than the threshold; iterating
S <- F(S) from the empty set reaches the unique fixpoint, which is greedy
NMS in descending-score order with index tie-break.  The JAX
``lax.while_loop`` becomes a Python loop run to the exact fixpoint, with no
cap on the iterations: each check of convergence is one host sync, and
``fixpoint.iterations`` counts them.  All problems handed to one call
advance together, so a call costs as many syncs as its slowest problem.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch.ops.boxes import pairwise_iou


def stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with the lower index first on ties, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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


def nms_keep_masks(boxes: Sequence[torch.Tensor], scores: Sequence[torch.Tensor],
                   iou_threshold: float,
                   valid: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Exact NMS keep masks for several independent [B, N_k] problems (the
    RPN's per-level NMS), solved in one fixpoint loop."""
    sups = [_suppression(b, s, iou_threshold, v)
            for b, s, v in zip(boxes, scores, valid)]
    return fixpoint(sups, list(valid))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                categories: torch.Tensor, iou_threshold: float,
                max_outputs: int, valid: torch.Tensor):
    """Category-aware NMS per image over the ``valid`` [B, N] boxes
    [B, N, 4] -> (indices [B, K], keep_valid [B, K]) of the top
    ``max_outputs`` survivors by score."""
    (keep,) = fixpoint([_suppression(boxes, scores, iou_threshold, valid,
                                     categories)], [valid])
    neg_inf = torch.finfo(scores.dtype).min
    masked = torch.where(keep, scores, torch.full_like(scores, neg_inf))
    top_scores, top_idx = stable_topk(masked, max_outputs)
    return top_idx, top_scores > neg_inf
