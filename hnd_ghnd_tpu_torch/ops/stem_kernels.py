"""The fused stem over the CUDA kernels of csrc/stem.cu, and its gradient.

Replaces hnd_ghnd_tpu/ops/pallas_stem.py: ``stem_conv_bn_relu`` with its
custom VJP.  What bounds the kernels and how they are laid out is noted in
the CUDA source.  The plain versions are ops/stem.py's ``stem_forward`` and
``stem_weight_grad``: a CPU tensor goes to them, a CUDA tensor to the
kernel, and anything the kernel does not take raises.

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

import torch

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops._oplib import check_device, define
from hnd_ghnd_tpu_torch.ops.stem import (KERNEL, OUT_CHANNELS, PADDING,
                                         STRIDE, stem_forward,
                                         stem_weight_grad)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_f32(t: torch.Tensor, shape, what: str, device: torch.device):
    if t.device != device:
        raise ValueError(f"{what} must be on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what}: the stem kernels take float32, got {t.dtype}")
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
    _check_f32(x, x.shape, "x", x.device)


def _launch_fwd(x, weight, scale, bias, with_conv: bool):
    _check_input(x)
    _check_f32(weight, (OUT_CHANNELS, 3, KERNEL, KERNEL), "weight", x.device)
    _check_f32(scale, (OUT_CHANNELS,), "scale", x.device)
    _check_f32(bias, (OUT_CHANNELS,), "bias", x.device)
    b, _, h, w = x.shape
    lib = _build.load()
    out = torch.empty((b, OUT_CHANNELS, h // 2, w // 2), dtype=torch.float32,
                      device=x.device)
    conv = torch.empty_like(out) if with_conv else None
    _build.check(lib.hnd_stem_fwd(
        x.data_ptr(), weight.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if conv is None else conv.data_ptr(), b, h, w,
        _stream(x.device)), "hnd_stem_fwd")
    return out, conv


def stem_fwd(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """x [B, 3, H, W], weight [64, 3, 7, 7], scale/bias [64] ->
    relu(conv7x7s2(x) * scale + bias) [B, 64, H/2, W/2]."""
    check_device(x, "stem_fwd")
    return stem_fwd_op(x, weight, scale, bias)


stem_fwd.launches = 0


def launch_stem_fwd(x: torch.Tensor, weight: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    out, _ = _launch_fwd(x, weight, scale, bias, with_conv=False)
    stem_fwd.launches += 1
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
    stem_fwd_res.launches += 1
    return out, conv


stem_fwd_res.launches = 0


def stem_dw(x: torch.Tensor, g_conv: torch.Tensor) -> torch.Tensor:
    """dW [64, 3, 7, 7] of the stem conv from x [B, 3, H, W] and the conv's
    cotangent g_conv [B, 64, H/2, W/2]."""
    if x.device.type == "cpu":
        return stem_weight_grad(x, g_conv)
    _check_input(x)
    b, _, h, w = x.shape
    _check_f32(g_conv, (b, OUT_CHANNELS, h // 2, w // 2), "g_conv", x.device)
    lib = _build.load()
    partials = torch.empty(lib.hnd_stem_dw_partials_size(b, h, w),
                           dtype=torch.float32, device=x.device)
    dw = torch.empty((OUT_CHANNELS, 3, KERNEL, KERNEL), dtype=torch.float32,
                     device=x.device)
    _build.check(lib.hnd_stem_dw(x.data_ptr(), g_conv.data_ptr(),
                                 partials.data_ptr(), dw.data_ptr(), b, h, w,
                                 _stream(x.device)), "hnd_stem_dw")
    stem_dw.launches += 1
    return dw


stem_dw.launches = 0


class StemConvBnRelu(torch.autograd.Function):
    """relu(conv7x7s2(x) * scale + bias) with the backward of
    pallas_stem._stem_vjp_bwd."""

    @staticmethod
    def forward(ctx, x, weight, scale, bias):
        out, conv = stem_fwd_res(x, weight, scale, bias)
        ctx.save_for_backward(x, weight, scale, bias, conv)
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, scale, bias, conv = ctx.saved_tensors
        scale4 = scale[None, :, None, None]
        pre = conv * scale4 + bias[None, :, None, None]
        g_pre = g * (pre > 0)
        dbias = g_pre.sum(dim=(0, 2, 3))
        dscale = (g_pre * conv).sum(dim=(0, 2, 3))
        g_conv = (g_pre * scale4).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = stem_dw(x, g_conv)
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(x.shape, weight, g_conv,
                                            stride=STRIDE, padding=PADDING)
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
