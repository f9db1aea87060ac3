"""The fused stem over the CUDA kernels of csrc/stem.cu, and its gradient.

Replaces hnd_ghnd_tpu/ops/pallas_stem.py: ``stem_conv_bn_relu`` with its
custom VJP.  What bounds the kernels and how they are laid out is noted in
the CUDA source.  The plain versions are ops/stem.py's ``stem_forward`` and
``stem_weight_grad``: a CPU tensor goes to them, a CUDA tensor to the
kernel, and anything the kernel does not take raises.  The kernels take
float32 or (R12) bfloat16 activations, as JAX's Pallas stem runs in the
input's dtype: the weight, scale, bias and dW stay float32.  Each
wrapper's ``launches`` counts its kernel's launches by x's dtype.

  * ``stem_fwd``: relu(conv * scale + bias), the primal (JAX's
    ``_stem_fwd_kernel``): the frozen teacher's stem, and any stem run
    without gradient; the ``hnd_ghnd::stem_fwd`` op defined here
    (ops/library.py), whose CUDA implementation is ``launch_stem_fwd``;
  * ``stem_fwd_res``: the same plus the pre-affine conv (JAX's
    ``_stem_fwd_res_kernel``), the forward of ``StemConvBnRelu``;
  * ``stem_dw``: the conv's weight gradient (JAX's ``_stem_dw_kernel``),
    in ``StemConvBnRelu.backward``.  dscale, dbias and the conv's
    cotangent stay plain PyTorch there, as they stay XLA in JAX; dx is
    computed only when the input needs it (the stem's input is the image,
    so on the distill path it never does).
"""
from __future__ import annotations

from collections import Counter

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops._oplib import check_device, define, on_card
from hnd_ghnd_tpu_torch.ops.stem import (KERNEL, OUT_CHANNELS, PADDING,
                                         STRIDE, stem_forward,
                                         stem_weight_grad)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_DTYPES = (torch.float32, torch.bfloat16)


def _check(t: torch.Tensor, shape, what: str, device: torch.device,
           dtype: torch.dtype = torch.float32):
    if t.device != device:
        raise ValueError(f"{what} must be on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: the stem kernels take {dtype} here, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} must be {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_input(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"stem kernel: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] % 2 or x.shape[3] % 2 \
            or x.shape[0] == 0:
        raise ValueError(f"stem kernel takes [B, 3, H, W] with B > 0 and H, W "
                         f"even, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: the stem kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    _check(x, x.shape, "x", x.device, x.dtype)


def _launch_fwd(x, weight, scale, bias, with_conv: bool):
    _check_input(x)
    _check(weight, (OUT_CHANNELS, 3, KERNEL, KERNEL), "weight", x.device)
    _check(scale, (OUT_CHANNELS,), "scale", x.device)
    _check(bias, (OUT_CHANNELS,), "bias", x.device)
    b, _, h, w = x.shape
    lib = _build.load()
    out = torch.empty((b, OUT_CHANNELS, h // 2, w // 2), dtype=x.dtype,
                      device=x.device)
    conv = torch.empty_like(out) if with_conv else None
    with on_card(x.device):
        _build.check(lib.hnd_stem_fwd(
            x.data_ptr(), weight.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(),
            None if conv is None else conv.data_ptr(), b, h, w,
            int(x.dtype == torch.bfloat16), _stream(x.device)),
            "hnd_stem_fwd")
    return out, conv


def stem_fwd(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W] (float32 or bfloat16), weight [64, 3, 7, 7],
    scale/bias [64] (float32) -> relu(conv7x7s2(x) * scale + bias)
    [B, 64, H/2, W/2] in x's dtype."""
    check_device(x, "stem_fwd")
    return stem_fwd_op(x, weight, scale, bias)


stem_fwd.launches = Counter()


def launch_stem_fwd(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    out, _ = _launch_fwd(x, weight, scale, bias, with_conv=False)
    stem_fwd.launches[x.dtype] += 1
    return out


def _stem_fwd_fake(x, weight, scale, bias):
    b, _, h, w = x.shape
    return x.new_empty((b, OUT_CHANNELS, h // 2, w // 2))


# relu(conv7x7s2(x) * scale + bias): x [B, 3, H, W] -> [B, 64, H/2, W/2]
stem_fwd_op = define(
    "stem_fwd(Tensor x, Tensor weight, Tensor scale, Tensor bias) -> Tensor",
    stem_forward, launch_stem_fwd, _stem_fwd_fake)


def stem_fwd_res(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor):
    """``stem_fwd``'s output and the pre-affine conv, both [B, 64, H/2, W/2]."""
    if x.device.type == "cpu":
        return stem_forward(x, weight, scale, bias, with_conv=True)
    out, conv = _launch_fwd(x, weight, scale, bias, with_conv=True)
    stem_fwd_res.launches[x.dtype] += 1
    return out, conv


stem_fwd_res.launches = Counter()


def stem_dw(x: torch.Tensor, g_conv: torch.Tensor) -> torch.Tensor:
    """dW [64, 3, 7, 7] float32 of the stem conv from x [B, 3, H, W] and the
    conv's cotangent g_conv [B, 64, H/2, W/2], both float32 or both
    bfloat16."""
    if x.device.type == "cpu":
        return stem_weight_grad(x, g_conv)
    _check_input(x)
    b, _, h, w = x.shape
    _check(g_conv, (b, OUT_CHANNELS, h // 2, w // 2), "g_conv", x.device,
           x.dtype)
    lib = _build.load()
    dw = torch.empty((OUT_CHANNELS, 3, KERNEL, KERNEL), dtype=torch.float32,
                     device=x.device)
    # the partials' count follows the card's SM count
    with on_card(x.device):
        partials = torch.empty(lib.hnd_stem_dw_partials_size(b, h, w),
                               dtype=torch.float32, device=x.device)
        _build.check(lib.hnd_stem_dw(x.data_ptr(), g_conv.data_ptr(),
                                     partials.data_ptr(), dw.data_ptr(), b,
                                     h, w, int(x.dtype == torch.bfloat16),
                                     _stream(x.device)), "hnd_stem_dw")
    stem_dw.launches[x.dtype] += 1
    return dw


stem_dw.launches = Counter()


class StemConvBnRelu(torch.autograd.Function):
    """relu(conv7x7s2(x) * scale + bias) with the backward of
    pallas_stem._stem_vjp_bwd: from the saved conv (bf16 for bf16 x) the
    affine, the ReLU's cut, dscale and dbias in float32; the conv's
    cotangent rounded to x's dtype for dW (float32); dx from the float32
    cotangent, cast to x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias):
        out, conv = stem_fwd_res(x, weight, scale, bias)
        ctx.save_for_backward(x, weight, scale, bias, conv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, scale, bias, conv = ctx.saved_tensors
        wide = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
        convf = conv.to(wide)
        scale4 = scale.to(wide)[None, :, None, None]
        pre = convf * scale4 + bias.to(wide)[None, :, None, None]
        g_pre = g.to(wide) * (pre > 0)
        dbias = g_pre.sum(dim=(0, 2, 3)).to(bias.dtype)
        dscale = (g_pre * convf).sum(dim=(0, 2, 3)).to(scale.dtype)
        g_conv = g_pre * scale4
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = stem_dw(x, g_conv.to(x.dtype).contiguous()).to(weight.dtype)
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(
                x.shape, weight.to(wide), g_conv, stride=STRIDE,
                padding=PADDING).to(x.dtype)
        return dx, dw, dscale, dbias


def stem_conv_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The fused stem.  Under autograd with a tensor that needs a gradient
    it runs ``StemConvBnRelu`` (forward with the residual, dW in the
    backward); otherwise the primal ``stem_fwd``, as JAX runs the primal
    kernel outside ``value_and_grad``'s differentiated arguments."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, weight, scale, bias)):
        return StemConvBnRelu.apply(x, weight, scale, bias)
    return stem_fwd(x, weight, scale, bias)
