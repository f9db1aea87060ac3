"""Layers the detector needs beyond torch.nn, and the seeded initializers.

Counterpart of hnd_ghnd_tpu/models/layers.py.  The JAX package keeps
activations NHWC and kernels HWIO; here modules are NCHW ``nn.Module``s with
OIHW weights, and models/convert.py moves weights between the two.

``FrozenBatchNorm2d`` is torchvision 0.4.2's, eps=0: it folds to
``x * scale + bias`` with scale = weight / sqrt(var) and
bias = bias - mean * scale.  The trainable BatchNorm of the bottleneck is
``nn.BatchNorm2d`` (eps=1e-5) in eval mode.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm2d with fixed statistics and affine parameters (eps=0)."""

    def __init__(self, channels: int, eps: float = 0.0):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


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
