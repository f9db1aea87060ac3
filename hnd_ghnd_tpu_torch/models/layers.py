"""Layers the detector needs beyond torch.nn, and the seeded initializers.

Counterpart of hnd_ghnd_tpu/models/layers.py.  The JAX package keeps
activations NHWC and kernels HWIO; here modules are NCHW ``nn.Module``s with
OIHW weights, and models/convert.py moves weights between the two.

``FrozenBatchNorm2d`` is torchvision 0.4.2's, eps=0: it folds to
``x * scale + bias`` with scale = weight / sqrt(var) and
bias = bias - mean * scale.  Its statistics are buffers; its ``weight``
and ``bias`` are parameters, as the JAX package's folded ``scale`` and
``bias`` are leaves of the params tree: the distill step trains those of
the student's stem ``bn1``, which the reference keeps frozen (ROADMAP
C6), and every other one is frozen by ``requires_grad``.  Weights from
the JAX package arrive with mean 0 and variance 1, so scale = weight and
the gradients land on the same leaves as in JAX.

The trainable BatchNorm of the bottleneck is ``BatchNorm2d`` (eps=1e-5,
momentum 0.1).  In train mode it normalises with the batch mean and the
biased variance and updates the running variance with the unbiased one,
as hnd_ghnd_tpu/models/layers.py:batch_norm does.

The compute dtype follows the input, as in the JAX package
(layers.py:70, 79, 87, 112-113, 127-128, 158-175): ``Conv2d`` and
``Linear`` cast their float32 weight and bias to ``x.dtype``; the frozen BN
folds in float32 and casts scale and bias; the trainable BN computes in
float32 and returns ``x.dtype``.  A bfloat16 image therefore runs the
whole network in bfloat16 with float32 parameters, without
``torch.autocast``, whose op lists would run softmax and the losses in
float32 and so compute another function than JAX's explicit casts.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` computed in float32, returned in the input's
    dtype (statistics and affine stay float32)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d with fixed statistics (eps=0); the affine is trainable
    unless ``requires_grad`` is off."""

    def __init__(self, channels: int, eps: float = 0.0):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self):
        """(scale, bias) with x * scale + bias the normalisation."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias = self.folded()
        return (x * scale.to(x.dtype)[None, :, None, None]
                + bias.to(x.dtype)[None, :, None, None])


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def kaiming_uniform_(w: torch.Tensor, gen: torch.Generator,
                     a: float = math.sqrt(5)) -> None:
    """torch's default Conv2d/Linear weight init (fan_in of the weight)."""
    fan_in = w[0].numel()
    gain = math.sqrt(2.0 / (1 + a * a))
    _uniform_(w, gain * math.sqrt(3.0 / fan_in), gen)


def fan_out_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """torchvision ResNet conv init: kaiming_normal(fan_out)."""
    fan_out = w.shape[0] * w[0, 0].numel()
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)


def normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> None:
    with torch.no_grad():
        w.normal_(0.0, std, generator=gen)


def linear_init_(m: nn.Linear, gen: torch.Generator) -> None:
    kaiming_uniform_(m.weight, gen)
    _uniform_(m.bias, 1.0 / math.sqrt(m.in_features), gen)
