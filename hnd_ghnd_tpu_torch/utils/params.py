"""Parameter utilities by dotted module path.

Counterpart of hnd_ghnd_tpu/utils/params.py (``trainable_mask``,
``updatable_param_names``, ``count_params``).  The YAML ``frozen_modules``
list names module paths (``backbone.body.layer2``); every parameter under
one of them is frozen (``requires_grad`` off), every other one trains.
"""
from __future__ import annotations

from typing import List, Sequence

from torch import nn


def _frozen(name: str, frozen_paths: Sequence[str]) -> bool:
    parts = name.split(".")
    return any(parts[:len(f)] == f
               for f in (p.split(".") for p in frozen_paths or []))


def set_trainable(model: nn.Module, frozen_paths: Sequence[str]) -> nn.Module:
    """``requires_grad`` off under ``frozen_paths``, on elsewhere."""
    for name, p in model.named_parameters():
        p.requires_grad_(not _frozen(name, frozen_paths))
    return model


def updatable_param_names(model: nn.Module) -> List[str]:
    """Sorted names of the parameters that train."""
    return sorted(name for name, p in model.named_parameters()
                  if p.requires_grad)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
