"""Distillation criteria from the reference YAML criterion schema.

Counterpart of hnd_ghnd_tpu/distill/losses.py (reference
src/distillation/loss.py): ``GeneralizedCustomLoss`` is the weighted sum of
per-term criteria over (teacher output, student output) pairs, plus
``org_loss_factor`` x the sum of the student's detection losses when the
factor is not 0 and those losses are given (skipped at 0, as in the JAX
package).  HND has one term (layer1), GHND four (layer1..layer4), each
``MSELoss(reduction=sum)`` in the shipped configs, all of which set the
factor to 0.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "sum":
        return x.sum()
    if reduction == "mean":
        return x.mean()
    if reduction == "none":
        return x
    raise ValueError(f"unknown reduction `{reduction}`")


def _diff(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return target.float() - pred.float()


def mse_loss(reduction: str = "mean") -> Callable:
    def fn(target, pred):
        d = _diff(target, pred)
        return _reduce(d * d, reduction)
    return fn


def l1_loss(reduction: str = "mean") -> Callable:
    def fn(target, pred):
        return _reduce(_diff(target, pred).abs(), reduction)
    return fn


def smooth_l1_loss(reduction: str = "mean", beta: float = 1.0) -> Callable:
    def fn(target, pred):
        d = _diff(target, pred).abs()
        v = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
        return _reduce(v, reduction)
    return fn


ELEMENTWISE_LOSSES = {
    "MSELoss": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
}


def get_elementwise_loss(loss_type: str, params: Dict[str, Any]) -> Callable:
    if loss_type not in ELEMENTWISE_LOSSES:
        raise KeyError(f"loss type `{loss_type}` is not expected")
    return ELEMENTWISE_LOSSES[loss_type](**(params or {}))


class GeneralizedCustomLoss:
    """Callable over {term: (teacher tensor, student tensor)} and the
    student's detection losses -> (total, {term: factor * criterion})."""

    def __init__(self, criterion_config: Dict[str, Any]):
        self.org_loss_factor = float(
            (criterion_config.get("params", {}) or {}).get("org_loss_factor",
                                                          0.0))
        self.terms = {}
        for name, term_cfg in criterion_config["terms"].items():
            sub = term_cfg["criterion"]
            fn = get_elementwise_loss(sub["type"], sub.get("params"))
            self.terms[name] = (tuple(term_cfg["ts_modules"]), fn,
                                float(term_cfg["factor"]))

    def __call__(self, output_dict: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 org_loss_dict: Optional[Dict[str, torch.Tensor]] = None):
        loss_dict = {}
        for name, (t_out, s_out) in output_dict.items():
            _, fn, factor = self.terms[name]
            loss_dict[name] = fn(t_out, s_out) * factor
        total = sum(loss_dict.values())
        if self.org_loss_factor != 0 and org_loss_dict:
            total = total + self.org_loss_factor * sum(org_loss_dict.values())
        return total, loss_dict


LOSS_DICT = {"general": GeneralizedCustomLoss}


def get_loss(criterion_config: Dict[str, Any]) -> GeneralizedCustomLoss:
    ctype = criterion_config["type"]
    if ctype not in LOSS_DICT:
        raise ValueError(f"criterion type `{ctype}` is not expected")
    return LOSS_DICT[ctype](criterion_config)
