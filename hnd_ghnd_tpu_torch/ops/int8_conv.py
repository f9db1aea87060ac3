"""The int8 server tail's convolution: int8 codes by int8 weights, the
int32 sums requantized in the kernel's store.

Replaces the XLA op of hnd_ghnd_tpu/split/int8.py:_QuantKit._acc (:206,
``lax.conv_general_dilated`` with ``preferred_element_type=jnp.int32``) and
the float32 ops JAX's walk applies to its sums.  ``int8_conv`` (the int32
sums) and ``int8_conv_requant`` (the sums requantized: a site's codes, the
float32 values, or a residual block's output) send a CUDA tensor to the
kernel of csrc/int8_conv.cu (what bounds it, and its two main loops, are
noted there) and a CPU tensor to their plain versions; anything the kernel
does not take raises.

Layouts are the kernel's: codes NHWC ``[B, H, W, C]``, weights ``[C_out,
kh, kw, C / groups]`` (K contiguous), outputs NHWC ``[B, Ho, Wo, C_out]``,
features NCHW ``[B, C_out, Ho, Wo]``.  Spatial padding pads the codes with
0, as lax zero-padding of the codes does.

The wrapper picks the kernel's main loop from the shape before the launch
(``template_for``): wgmma fed by TMA where it applies, else mma.sync; each
launch adds one to its entry's ``launches`` and to ``template_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.ops._oplib import on_card
from hnd_ghnd_tpu_torch.ops.quant_kernels import _stream

ZP = 128  # zero point of an unsigned (post-ReLU) site: value = (q + 128) s
MODES = {"int32": 0, "site": 1, "float": 2, "residual": 3}
# launches of each main loop of the kernel, over both entries
template_launches = {"wgmma": 0, "mma_sync": 0}

# a residual's identity: float32 NHWC, or (codes NHWC int8, scale, zero point)
Identity = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, int]]


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


def requantize_plain(y: torch.Tensor, s: torch.Tensor,
                     unsigned: bool) -> torch.Tensor:
    """A site's int8 codes of float32 ``y`` (JAX's ``_QuantKit.site``): an
    IEEE division by the site's scale (a tensor: a Python divisor becomes a
    reciprocal multiply on the card), rounded half to even, clamped to [0,
    255] minus 128 or to [-127, 127]; NaN becomes code 0, as XLA's
    convert makes it."""
    if unsigned:
        q = torch.clamp(torch.round(y / s), 0, 255) - ZP
    else:
        q = torch.clamp(torch.round(y / s), -127, 127)
    return torch.nan_to_num(q, nan=0.0).to(torch.int8)


def dequantize_codes(q: torch.Tensor, s: torch.Tensor,
                     zp: int) -> torch.Tensor:
    """(q + zp) s in float32 (JAX's ``_QuantKit.to_fp``)."""
    return (q.float() + zp) * s


def int8_conv_requant_plain(q: torch.Tensor, qw: torch.Tensor,
                            stride: int = 1, pad: int = 0, groups: int = 1,
                            *, mode: str, scale: torch.Tensor = None,
                            bias: torch.Tensor = None,
                            zp: Optional[torch.Tensor] = None,
                            site_scale: Optional[torch.Tensor] = None,
                            relu: bool = False, unsigned: bool = False,
                            identity: Optional[Identity] = None,
                            features: bool = False):
    """``int8_conv_plain`` followed by the int8 walk's float32 ops, one
    eager op each in JAX's order: y = (float(acc) + zp) scale + bias, with
    ``zp`` the zero point's share ([C_out], or the border map [1, Ho, Wo,
    C_out] of a padded conv; None for a signed input).  ``mode``:

      * "int32": the sums;
      * "float": y, float32 NHWC;
      * "site": y (ReLU'd where ``relu``) as the codes of a site of scale
        ``site_scale``, unsigned (zero point 128) or signed;
      * "residual": relu(y + identity) as an unsigned site's codes, the
        identity float32 NHWC or (codes, scale, zero point) dequantized.

    With ``features`` the site modes return (codes, the codes dequantized
    as NCHW float32)."""
    if mode not in MODES:
        raise ValueError(f"int8_conv_requant: unknown mode {mode!r}")
    acc = int8_conv_plain(q, qw, stride, pad, groups)
    if mode == "int32":
        return acc
    y = acc.float()
    if zp is not None:
        y = y + zp
    y = y * scale
    y = y + bias
    if mode == "float":
        return y
    if mode == "residual":
        ident = identity if torch.is_tensor(identity) \
            else dequantize_codes(*identity)
        y = torch.relu(y + ident)
        unsigned = True
    elif relu:
        y = torch.relu(y)
    codes = requantize_plain(y, site_scale, unsigned)
    if not features:
        return codes
    feat = dequantize_codes(codes, site_scale, ZP if unsigned else 0)
    return codes, feat.permute(0, 3, 1, 2).contiguous()


def template_for(q: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                 groups: int = 1) -> str:
    """The kernel's main loop for these codes and weights, by shape and
    alignment: "wgmma" (TMA and wgmma: groups 1, C a multiple of 64, C_out
    a multiple of 128, stride 1 or 2, 16-byte aligned codes and weights)
    or "mma_sync" (any other shape)."""
    _, h, w, c = q.shape
    n = qw.shape[0]
    if (groups == 1 and c % 64 == 0 and n % 128 == 0 and stride in (1, 2)
            and h >= stride and w >= stride and q.data_ptr() % 16 == 0
            and qw.data_ptr() % 16 == 0):
        return "wgmma"
    return "mma_sync"


def _checked_shape(q, qw, stride, pad, groups, what):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.dtype != torch.int8 or qw.dtype != torch.int8:
        raise TypeError(f"{what} kernel takes int8 codes and weights, got "
                        f"{q.dtype} and {qw.dtype}")
    if qw.device != q.device:
        raise ValueError(f"{what}: codes and weights on different devices")
    if q.dim() != 4 or qw.dim() != 4:
        raise ValueError(f"{what} kernel takes 4-D codes and weights")
    if not (q.is_contiguous() and qw.is_contiguous()):
        raise ValueError(f"{what} kernel takes contiguous NHWC codes and "
                         "contiguous [C_out, kh, kw, C/groups] weights")
    b, h, w, c = q.shape
    n, kh, kw, cg = qw.shape
    if (groups < 1 or c % groups or n % groups or cg * groups != c
            or stride < 1 or pad < 0):
        raise ValueError(f"{what}: codes {tuple(q.shape)}, weights "
                         f"{tuple(qw.shape)}, groups {groups}, stride "
                         f"{stride}, pad {pad} do not fit")
    ho, wo = out_size(h, kh, stride, pad), out_size(w, kw, stride, pad)
    if ho < 1 or wo < 1 or q.numel() == 0:
        raise ValueError(f"{what}: empty output from {tuple(q.shape)}")
    return b, h, w, c, n, kh, kw, ho, wo


def _operand(t: Optional[torch.Tensor], dtype, shapes, device, what: str):
    """The pointer of an epilogue operand after its checks (None: null)."""
    if t is None:
        return None
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"int8_conv_requant: {what} must be a contiguous "
                         f"{dtype} tensor on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) not in shapes:
        raise ValueError(f"int8_conv_requant: {what} has shape "
                         f"{tuple(t.shape)}, not one of {shapes}")
    return t.data_ptr()


def _launch(q, qw, stride, pad, groups, dims, mode, out, ptrs=None,
            flags=(0, 0), id_zp=0.0):
    b, h, w, c, n, kh, kw, _, _ = dims
    path = template_for(q, qw, stride, groups)
    p = ptrs or {}
    with on_card(q.device):
        _build.check(_build.load().hnd_int8_conv_fused(
            q.data_ptr(), qw.data_ptr(), b, h, w, c, n, kh, kw, stride, pad,
            groups, 1 if path == "wgmma" else 0, MODES[mode], out.data_ptr(),
            p.get("zp"), p.get("zp_map"), p.get("scale"), p.get("bias"),
            p.get("site_scale"), flags[0], flags[1], p.get("id_codes"),
            p.get("id_scale"), ctypes.c_float(id_zp), p.get("id_float"),
            p.get("feat"), _stream(q.device)), "hnd_int8_conv_fused")
    template_launches[path] += 1


def int8_conv(q: torch.Tensor, qw: torch.Tensor, stride: int = 1,
              pad: int = 0, groups: int = 1) -> torch.Tensor:
    """int32 NHWC sums of ``q`` (NHWC int8) by ``qw`` (int8 ``[C_out, kh,
    kw, C / groups]``); bit-exact with ``int8_conv_plain``."""
    if q.device.type == "cpu":
        return int8_conv_plain(q, qw, stride, pad, groups)
    dims = _checked_shape(q, qw, stride, pad, groups, "int8_conv")
    b, _, _, _, n, _, _, ho, wo = dims
    out = torch.empty((b, ho, wo, n), dtype=torch.int32, device=q.device)
    _launch(q, qw, stride, pad, groups, dims, "int32", out)
    int8_conv.launches += 1
    return out


int8_conv.launches = 0


def int8_conv_requant(q: torch.Tensor, qw: torch.Tensor, stride: int = 1,
                      pad: int = 0, groups: int = 1, *, mode: str,
                      scale: torch.Tensor = None, bias: torch.Tensor = None,
                      zp: Optional[torch.Tensor] = None,
                      site_scale: Optional[torch.Tensor] = None,
                      relu: bool = False, unsigned: bool = False,
                      identity: Optional[Identity] = None,
                      features: bool = False):
    """The convolution with the int8 walk's epilogue in its store (see
    ``int8_conv_requant_plain`` for the arguments); bit-exact with
    ``int8_conv_requant_plain``, which a CPU tensor goes to after the same
    checks of its operands.  On the card no int32 sum reaches device
    memory."""
    if mode not in MODES:
        raise ValueError(f"int8_conv_requant: unknown mode {mode!r}")
    dims = _checked_shape(q, qw, stride, pad, groups, "int8_conv_requant")
    b, _, _, _, n, _, _, ho, wo = dims
    dev = q.device
    f32 = torch.float32
    if mode == "residual":
        unsigned = relu = True
    sites = mode in ("site", "residual")
    if features and not sites:
        raise ValueError("int8_conv_requant: features come with the site "
                         "and residual modes")
    ptrs = {}
    id_zp = 0.0
    if mode != "int32":
        ptrs["scale"] = _operand(scale, f32, [(n,)], dev, "scale")
        ptrs["bias"] = _operand(bias, f32, [(n,)], dev, "bias")
        if zp is not None and zp.dim() == 1:
            ptrs["zp"] = _operand(zp, f32, [(n,)], dev, "zp")
        else:
            ptrs["zp_map"] = _operand(zp, f32, [(1, ho, wo, n)], dev, "zp")
    if sites:
        ptrs["site_scale"] = _operand(site_scale.reshape(()), f32, [()],
                                      dev, "site_scale")
    if mode == "residual":
        if torch.is_tensor(identity):
            ptrs["id_float"] = _operand(identity, f32, [(b, ho, wo, n)], dev,
                                        "identity")
        else:
            codes, id_scale, id_zp = identity
            ptrs["id_codes"] = _operand(codes, torch.int8, [(b, ho, wo, n)],
                                        dev, "identity codes")
            ptrs["id_scale"] = _operand(id_scale.reshape(()), f32, [()], dev,
                                        "identity scale")
            id_zp = float(id_zp)
    if dev.type == "cpu":
        return int8_conv_requant_plain(
            q, qw, stride, pad, groups, mode=mode, scale=scale, bias=bias,
            zp=zp, site_scale=site_scale, relu=relu, unsigned=unsigned,
            identity=identity, features=features)
    out = torch.empty((b, ho, wo, n), device=dev, dtype={
        "int32": torch.int32, "float": f32}.get(mode, torch.int8))
    feat = None
    if features:
        feat = torch.empty((b, n, ho, wo), device=dev, dtype=f32)
        ptrs["feat"] = feat.data_ptr()
    _launch(q, qw, stride, pad, groups, dims, mode, out, ptrs,
            (int(relu), int(unsigned)), id_zp)
    int8_conv_requant.launches += 1
    return (out, feat) if features else out


int8_conv_requant.launches = 0
