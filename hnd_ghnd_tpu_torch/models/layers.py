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
as hnd_ghnd_tpu/models/layers.py:batch_norm does.  With more than one
rank, those are the global batch's statistics (``_CrossProcessBatchNorm``),
except under ``per_process_batch_norm``.

The compute dtype follows the input, as in the JAX package
(layers.py:70, 79, 87, 112-113, 127-128, 158-175): ``Conv2d``,
``ConvTranspose2d`` and ``Linear`` cast their float32 weight and bias to
``x.dtype``; the frozen BN
folds in float32 and casts scale and bias; the trainable BN computes in
float32 and returns ``x.dtype``.  A bfloat16 image therefore runs the
whole network in bfloat16 with float32 parameters, without
``torch.autocast``, whose op lists would run softmax and the losses in
float32 and so compute another function than JAX's explicit casts.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from hnd_ghnd_tpu_torch.parallel import multihost


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight and bias are cast to the input's
    dtype; torch's geometry, out = (in - 1) * stride - 2 * pad + kernel, as
    hnd_ghnd_tpu/models/layers.py:conv_transpose2d computes it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride, self.padding)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


_CROSS_PROCESS = contextvars.ContextVar("cross_process_batch_norm",
                                        default=True)


@contextlib.contextmanager
def per_process_batch_norm():
    """Inside it, a training ``BatchNorm2d`` takes its statistics from its
    own rank's batch, as a ``shard_map`` step's BNs do (the detection
    step: hnd_ghnd_tpu/parallel/mesh.py:322-396)."""
    token = _CROSS_PROCESS.set(False)
    try:
        yield
    finally:
        _CROSS_PROCESS.reset(token)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` computed in float32, returned in the input's
    dtype (statistics and affine stay float32).

    In training, with a process group of more than one rank up (and outside
    ``per_process_batch_norm``), the statistics are those of the global
    batch, every rank's, as JAX's GSPMD steps take them
    (hnd_ghnd_tpu/models/layers.py:151-170): ``_CrossProcessBatchNorm``.
    One process computes what ``nn.BatchNorm2d`` computes, bit for bit."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (self.training and _CROSS_PROCESS.get()
                and multihost.get_world_size() > 1):
            if self.weight is None or self.running_mean is None:
                raise NotImplementedError("cross-process BatchNorm2d needs "
                                          "an affine and running statistics")
            self.num_batches_tracked.add_(1)
            return _CrossProcessBatchNorm.apply(
                x, self.weight, self.bias,
                (self.running_mean, self.running_var), self.eps,
                self.momentum)
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


def _channel_sum(t: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=(0, 2, 3))


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


class _CrossProcessBatchNorm(torch.autograd.Function):
    """Training BatchNorm over the global batch of every rank.

    Forward: the element count and the per-channel sum are all-reduced,
    then the per-channel sum of squares about the global mean (two passes,
    as ``xf.var`` is, not E[x^2] - E[x]^2); y = (x - mean) * (rsqrt(var +
    eps) * weight) + bias in JAX's order.  The running statistics take
    JAX's momentum update with the unbiased variance of the global count.
    Backward: Sum(dy) and Sum(dy * xhat) are all-reduced; the affine's
    gradients stay this rank's partial sums, for the step's gradient
    all-reduce to combine.  Cross-rank sums travel in float64."""

    @staticmethod
    def forward(ctx, x, weight, bias, running, eps, momentum):
        running_mean, running_var = running
        xf = x.float()
        f64 = torch.float64
        count = torch.full((1,), xf.numel() // xf.shape[1], dtype=f64,
                           device=x.device)
        first = torch.cat([_channel_sum(xf).to(f64), count])
        multihost.all_reduce_([first], "sum")
        n = first[-1:]
        mean = (first[:-1] / n).float()
        centred = xf - _per_channel(mean)
        second = _channel_sum(centred * centred).to(f64)
        multihost.all_reduce_([second], "sum")
        var = (second / n).float()
        invstd = torch.rsqrt(var + eps)
        y = centred * _per_channel(invstd * weight) + _per_channel(bias)
        with torch.no_grad():
            nf = n.float()
            unbiased = var * nf / torch.clamp(nf - 1, min=1)
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean)
            running_var.copy_((1 - momentum) * running_var
                              + momentum * unbiased)
        ctx.save_for_backward(centred * _per_channel(invstd), invstd,
                              weight, n)
        ctx.x_dtype = x.dtype
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        xhat, invstd, weight, n = ctx.saved_tensors
        g = gy.float()
        d_bias = _channel_sum(g)
        d_weight = _channel_sum(g * xhat)
        sums = torch.cat([d_bias, d_weight]).to(torch.float64)
        multihost.all_reduce_([sums], "sum")
        means = (sums / n).float()
        c = d_bias.shape[0]
        gx = (g - _per_channel(means[:c])
              - xhat * _per_channel(means[c:])) * _per_channel(invstd * weight)
        return gx.to(ctx.x_dtype), d_weight, d_bias, None, None, None


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


def adaptive_avg_pool_matrices(in_size: int, out_size: int) -> torch.Tensor:
    """Pooling matrix P [in, out] with torch AdaptiveAvgPool2d's bin edges:
    bin i averages input[floor(i * in / out) : ceil((i + 1) * in / out)]
    (hnd_ghnd_tpu/models/layers.py:adaptive_avg_pool_matrices)."""
    p = torch.zeros((in_size, out_size), dtype=torch.float32)
    for i in range(out_size):
        lo = (i * in_size) // out_size
        hi = -(-((i + 1) * in_size) // out_size)
        p[lo:hi, i] = 1.0 / (hi - lo)
    return p


@functools.lru_cache(maxsize=16)
def _pool_matrix(in_size: int, out_size: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Made once per device: a copy from host memory on every forward would
    block the host until the stream drains."""
    return adaptive_avg_pool_matrices(in_size, out_size).to(device, dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """AdaptiveAvgPool2d of NCHW ``x`` as two products, H then W, each
    accumulated in float32 and cast back to ``x.dtype``, as the JAX
    package's einsums with ``preferred_element_type=float32`` compute it
    (hnd_ghnd_tpu/models/layers.py:adaptive_avg_pool).  Bins that overlap
    (in / out not an integer) sum in another order than
    ``F.adaptive_avg_pool2d``."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    ph = _pool_matrix(x.shape[2], out_hw[0], x.dtype, x.device)
    pw = _pool_matrix(x.shape[3], out_hw[1], x.dtype, x.device)
    y = torch.einsum("nchw,hH->ncHw", x.to(acc), ph.to(acc)).to(x.dtype)
    return torch.einsum("ncHw,wW->ncHW", y.to(acc), pw.to(acc)).to(x.dtype)
