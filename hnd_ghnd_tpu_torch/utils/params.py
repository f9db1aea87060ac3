"""Parameter utilities by dotted module path.

Counterpart of hnd_ghnd_tpu/utils/params.py (``trainable_mask``,
``updatable_param_names``, ``count_params``, ``get_by_path``).  The YAML
``frozen_modules`` list names module paths (``backbone.body.layer2``);
every parameter under one of them is frozen (``requires_grad`` off), every
other one trains.

``get_by_path`` and ``count_tree_params`` walk the JAX-layout params tree
of models/convert.jax_params_from_state_dict, which cost_analyzer counts:
the JAX package counts that tree (its frozen BNs folded to a scale and a
bias), not the port's parameters, whose frozen-BN statistics are buffers.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
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


def get_by_path(tree: Dict[str, Any], dotted: str):
    """The subtree of a nested dict at a dotted path (``backbone.body``)."""
    node = tree
    for part in dotted.split("."):
        node = node[part]
    return node


def count_tree_params(tree) -> int:
    """Elements of every array leaf of a nested dict (or of one array)."""
    if isinstance(tree, dict):
        return sum(count_tree_params(v) for v in tree.values())
    return int(np.prod(np.shape(tree)))
