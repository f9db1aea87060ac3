"""The int8 server tail's convolution: int8 codes by int8 weights into int32.

Replaces the XLA op of hnd_ghnd_tpu/split/int8.py:_QuantKit._acc (:206,
``lax.conv_general_dilated`` with ``preferred_element_type=jnp.int32``).
``int8_conv`` sends a CUDA tensor to the kernel of csrc/int8_conv.cu (an
implicit GEMM on the tensor cores; what bounds it is noted there) and a CPU
tensor to ``int8_conv_plain``; anything the kernel does not take raises.

Layouts are the kernel's: codes NHWC ``[B, H, W, C]``, weights ``[C_out,
kh, kw, C / groups]`` (K contiguous), sums NHWC ``[B, Ho, Wo, C_out]``.
Spatial padding pads the codes with 0, as lax zero-padding of the codes
does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops.quant_kernels import _stream


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def int8_conv_plain(q: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                    pad: int = 0, groups: int = 1) -> torch.Tensor:
    """The exact int32 sums, as a float64 convolution of the codes rounded
    back: every partial sum is an integer far below 2^53, so float64 holds
    it exactly in any order of summation, on the card too (TF32 never
    applies to float64)."""
    x = q.permute(0, 3, 1, 2).to(torch.float64)
    w = qw.permute(0, 3, 1, 2).to(torch.float64)
    y = F.conv2d(x, w, stride=stride, padding=pad, groups=groups)
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def int8_conv(q: torch.Tensor, qw: torch.Tensor, stride: int = 1,
              pad: int = 0, groups: int = 1) -> torch.Tensor:
    """int32 NHWC sums of ``q`` (NHWC int8) by ``qw`` (int8 ``[C_out, kh,
    kw, C / groups]``); bit-exact with ``int8_conv_plain``."""
    if q.device.type == "cpu":
        return int8_conv_plain(q, qw, stride, pad, groups)
    if q.device.type != "cuda":
        raise ValueError(f"int8_conv: unsupported device {q.device}")
    if q.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"int8_conv kernel takes int8 codes and weights, got "
                        f"{q.dtype} and {qw.dtype}")
    if qw.device != q.device:
        raise ValueError("int8_conv: codes and weights on different devices")
    if q.dim() != 4 or qw.dim() != 4:
        raise ValueError("int8_conv kernel takes 4-D codes and weights")
    if not (q.is_contiguous() and qw.is_contiguous()):
        raise ValueError("int8_conv kernel takes contiguous NHWC codes and "
                         "contiguous [C_out, kh, kw, C/groups] weights")
    b, h, w, c = q.shape
    n, kh, kw, cg = qw.shape
    if (groups < 1 or c % groups or n % groups or cg * groups != c
            or stride < 1 or pad < 0):
        raise ValueError(f"int8_conv: codes {tuple(q.shape)}, weights "
                         f"{tuple(qw.shape)}, groups {groups}, stride "
                         f"{stride}, pad {pad} do not fit")
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    if ho < 1 or wo < 1 or q.numel() == 0:
        raise ValueError(f"int8_conv: empty output from {tuple(q.shape)}")
    lib = _build.load()
    out = torch.empty((b, ho, wo, n), dtype=torch.int32, device=q.device)
    _build.check(lib.hnd_int8_conv(q.data_ptr(), qw.data_ptr(),
                                   out.data_ptr(), b, h, w, c, n, kh, kw,
                                   stride, pad, groups, _stream(q.device)),
                 "hnd_int8_conv")
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
