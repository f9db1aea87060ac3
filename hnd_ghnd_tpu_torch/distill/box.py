"""DistillationBox: the HND/GHND teacher -> student feature matching.

Counterpart of hnd_ghnd_tpu/distill/box.py (reference
src/distillation/tool.py).  The reference hooks the modules named by each
term's ``ts_modules``; here the trunk returns its stage outputs keyed by
the same dotted paths, so the hook is a dictionary lookup.  The trunk runs
only up to the deepest stage a term names (``_max_stage``: HND stops after
layer1).  Terms name trunk stages only: the JAX package's ``backbone.fpn``
term is used by no shipped config and is not ported.

The teacher runs in eval mode under ``torch.no_grad()``; the student's
trunk runs in train mode (bottleneck BNs on batch statistics, no 8-bit
round trip), as the JAX package's ``DistillationBox.loss`` does.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Sequence

import torch

from hnd_ghnd_tpu_torch.distill.losses import get_loss
from hnd_ghnd_tpu_torch.models.rcnn import RCNN

_LAYER_RE = re.compile(r"backbone\.body\.layer([1-4])")


def _max_stage(paths: Sequence[str]) -> int:
    """Deepest trunk stage any ts_module path references."""
    best = 1
    for p in paths:
        m = _LAYER_RE.fullmatch(p)
        if m is None:
            raise NotImplementedError(
                f"distill term on `{p}`: only backbone.body.layer1-4 are "
                "ported")
        best = max(best, int(m.group(1)))
    return best


class DistillationBox:
    def __init__(self, teacher: RCNN, student: RCNN,
                 criterion_config: Dict[str, Any]):
        self.teacher = teacher
        self.student = student
        self.criterion = get_loss(criterion_config)
        self.pairs = {name: paths for name, (paths, _, _)
                      in self.criterion.terms.items()}
        all_paths = [p for paths in self.pairs.values() for p in paths]
        self.upto = _max_stage(all_paths)

    def _features(self, model: RCNN, images: torch.Tensor):
        body = model.backbone.body(model.normalize(images), upto=self.upto)
        return {f"backbone.body.{k}": v for k, v in body.items()}

    def loss(self, images: torch.Tensor):
        """images [B, H, W, 3] in [0, 1] -> (total, {term: loss}).  The
        student's BN running statistics advance as a side effect."""
        if self.teacher.training or not self.student.training:
            raise RuntimeError("distill: the teacher must be in eval mode and "
                               "the student in train mode")
        with torch.no_grad():
            t_inter = self._features(self.teacher, images)
        s_inter = self._features(self.student, images)
        output_dict = {name: (t_inter[t_path], s_inter[s_path])
                       for name, (t_path, s_path) in self.pairs.items()}
        return self.criterion(output_dict)
