"""DistillationBox: the HND/GHND teacher -> student feature matching.

Counterpart of hnd_ghnd_tpu/distill/box.py (reference
src/distillation/tool.py).  The reference hooks the modules named by each
term's ``ts_modules``; here the trunk returns its stage outputs keyed by
the same dotted paths, so the hook is a dictionary lookup.  A term names a
trunk stage (``backbone.body.layer1``..``layer4``) or ``backbone.fpn``:
every level the FPN returns (P2-P5 and the max-pool P6), each flattened
per image in the JAX package's NHWC order, concatenated on axis 1.  The
trunk runs only up to the deepest stage a term names (``_max_stage``: HND
stops after layer1, an FPN term needs all four).

The teacher runs in eval mode under ``torch.no_grad()``; the student's
trunk runs in train mode (bottleneck BNs on batch statistics, no 8-bit
round trip), as the JAX package's ``DistillationBox.loss`` does.

``org_loss_factor != 0`` adds the student's detection losses on the same
batch (``RCNN.feature_losses``), logged as ``org_<name>``.  JAX computes
them in a second full training forward and throws that forward's BN
state away; both of its trunk passes are the same function of the same
inputs, so here one full trunk pass feeds the feature terms and the
detection losses: the same loss and gradients, the bottleneck's BN
running statistics advanced once per step as JAX's are, and one trunk
forward and backward less.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch.distill.losses import get_loss
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.models.rpn import Draw

_LAYER_RE = re.compile(r"backbone\.body\.layer([1-4])")
FPN_PATH = "backbone.fpn"


def _max_stage(paths: Sequence[str]) -> int:
    """Deepest trunk stage any (validated) ts_module path references
    (min 1); 4 for ``backbone.fpn``, which reads all four."""
    best = 1
    for p in paths:
        if p == FPN_PATH:
            return 4
        best = max(best, int(_LAYER_RE.fullmatch(p).group(1)))
    return best


def flatten_levels(levels: Sequence[torch.Tensor]) -> torch.Tensor:
    """NCHW maps -> [B, sum of H x W x C], each map flattened per image in
    NHWC order (the JAX package's layout) and concatenated."""
    return torch.cat([f.permute(0, 2, 3, 1).reshape(f.shape[0], -1)
                      for f in levels], dim=1)


class DistillationBox:
    def __init__(self, teacher: RCNN, student: RCNN,
                 criterion_config: Dict[str, Any]):
        self.teacher = teacher
        self.student = student
        self.criterion = get_loss(criterion_config)
        self.pairs = {name: paths for name, (paths, _, _)
                      in self.criterion.terms.items()}
        all_paths = [p for paths in self.pairs.values() for p in paths]
        for p in all_paths:
            if p != FPN_PATH and _LAYER_RE.fullmatch(p) is None:
                raise ValueError(f"distill term on `{p}`: a term names "
                                 "backbone.body.layer1-4 or backbone.fpn")
        self.upto = _max_stage(all_paths)
        self.needs_fpn = FPN_PATH in all_paths
        self.use_org_loss = self.criterion.org_loss_factor != 0

    def _features(self, model: RCNN, images: torch.Tensor, full: bool = False
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Optional[List[torch.Tensor]]]:
        """({path: output} of the terms' modules, the FPN maps when the
        trunk ran whole): ``full`` runs all four stages and the FPN."""
        body = model.backbone.body(model.normalize(images),
                                   upto=4 if full else self.upto)
        inter = {f"backbone.body.{k}": v for k, v in body.items()}
        fpn = None
        if full or self.needs_fpn:
            fpn = model.backbone.fpn([body[f"layer{i}"] for i in (1, 2, 3, 4)])
            if self.needs_fpn:
                inter[FPN_PATH] = flatten_levels(fpn)
        return inter, fpn

    def loss(self, images: torch.Tensor,
             targets: Optional[Dict[str, torch.Tensor]] = None,
             draw: Optional[Draw] = None,
             image_sizes: Optional[torch.Tensor] = None):
        """images [B, H, W, 3] in [0, 1] -> (total, {term: loss}).  With the
        org term, the student's detection losses on the batch (``targets``
        padded as the loader pads them, ``image_sizes`` [B, 2], the
        samplers' ``draw``) are added to the total and logged as
        ``org_<name>``.  The student's BN running statistics advance once,
        as a side effect."""
        if self.teacher.training or not self.student.training:
            raise RuntimeError("distill: the teacher must be in eval mode and "
                               "the student in train mode")
        if self.use_org_loss and (targets is None or draw is None
                                  or image_sizes is None):
            raise ValueError("org_loss_factor != 0 requires targets, "
                             "image_sizes and draw")
        with torch.no_grad():
            t_inter, _ = self._features(self.teacher, images)
        s_inter, fpn = self._features(self.student, images,
                                      full=self.use_org_loss)
        output_dict = {name: (t_inter[t_path], s_inter[s_path])
                       for name, (t_path, s_path) in self.pairs.items()}
        org_loss_dict = None
        if self.use_org_loss:
            org_loss_dict = self.student.feature_losses(
                fpn, image_sizes, (images.shape[1], images.shape[2]),
                targets, draw)
        total, loss_dict = self.criterion(output_dict, org_loss_dict)
        if org_loss_dict:
            loss_dict = dict(loss_dict, **{f"org_{k}": v
                                           for k, v in org_loss_dict.items()})
        return total, loss_dict
