"""The int8 server tail: post-training static quantization of the trunk.

Counterpart of hnd_ghnd_tpu/split/int8.py.  The server tail's trunk (the
bottleneck decoder and ResNet layers 2-4) runs with int8 weights and int8
activations; the FPN, the RPN and the RoI heads stay float32.

  * weights: symmetric per-output-channel int8, with the adjacent
    normalization (the decoder's trainable BNs over their running
    statistics, eps 1e-5; the frozen BNs of layers 2-4 through
    ``FrozenBatchNorm2d.folded``) folded into the weights first;
  * activations: per-tensor int8 with calibrated scales (max-abs / 127
    over calibration batches at each of the 44 requantization sites).
    Post-ReLU sites (all but ``dec0`` and ``dec2``) quantize with zero
    point -128: q = round(x / (s 127/255)) - 128 over [0, 255].  A conv
    that reads such an input adds 128 times the sum of its weights over
    the in-image taps: a constant per channel without padding, a border
    map (integer, computed exactly once per input size) with it;
  * integer: the convolutions, int8 codes by int8 weights summed in int32
    with the codes zero-padded, and float32 in the JAX package's order:
    the int32 sum to float, the zero point's share, the scale s_in sw, the
    bias, the residual add, ReLU, and the requantization (an IEEE
    division by the site's scale, rounded half to even, clamped, cast).
    ``ops/int8_conv.int8_conv_requant`` does both in one call: on the card
    the CUDA kernel of csrc/int8_conv.cu, whose store applies the float
    steps to the sums in its registers; on the CPU its plain version, the
    same steps as eager torch ops.

The walk keeps NHWC int8 codes between sites (the wire's layout); the
stage outputs come out of their convolutions as NCHW float32 for the
model's own FPN.  The calibration walk and the quantized walk share one
traversal (``_trunk_walk``) parameterized by an ops kit, so their sites
align by construction.

Bit-exactness: the fold and the weight quantization run on the CPU (the
card's rsqrt is not the CPU's), the scales are float32 tensors on the
walk's device (a Python divisor would become a multiply by its reciprocal
on the card), and the integer sums are exact, so the card's walk and the
CPU's give the same codes at every site.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.ops import quant_kernels
from hnd_ghnd_tpu_torch.ops.int8_conv import (ZP as _ZP, int8_conv_requant,
                                               out_size, requantize_plain)
from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN

Folded = Dict[str, Any]

_BN_EPS = 1e-5  # the decoder's BatchNorm eps
# the decoder Sequential: bn_in at 0, then each conv and its BN; ReLU after
# the second and the fourth conv (models/bottleneck.py)
_DEC_CONV_BN = ((2, 3), (4, 5), (7, 8), (9, 10))
_DEC_RELU_AFTER = (1, 3)


# ---------------------------------------------------------------------------
# BN folding, on the CPU: per-conv effective (w, b)
# ---------------------------------------------------------------------------

def _fold_conv_bn(conv: torch.nn.Conv2d, scale: torch.Tensor,
                  bias: torch.Tensor, relu: bool) -> Folded:
    """y = bn(conv(x)) = conv(x; w scale) + (scale conv_b + bias), with w
    as [C_out, kh, kw, C / groups]."""
    w = conv.weight.detach().cpu().float().permute(0, 2, 3, 1) \
        * scale[:, None, None, None]
    b = bias.float()
    if conv.bias is not None:
        b = b + scale * conv.bias.detach().cpu().float()
    return {"w": w.contiguous(), "b": b, "relu": relu,
            "groups": conv.groups}


def _frozen_bn_affine(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """``FrozenBatchNorm2d.folded`` of a CPU copy (the card's rsqrt is not
    the CPU's)."""
    scale, bias = copy.deepcopy(bn).cpu().folded()
    return scale.detach().float(), bias.detach().float()


def _batch_norm_affine(bn: torch.nn.BatchNorm2d
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An eval-mode trainable BN as (scale, bias) from its running stats."""
    inv = bn.weight.detach().cpu().float() * torch.rsqrt(
        bn.running_var.detach().cpu().float() + _BN_EPS)
    return inv, (bn.bias.detach().cpu().float()
                 - bn.running_mean.detach().cpu().float() * inv)


@torch.no_grad()
def fold_tail(model: RCNN) -> Folded:
    """The tail's trunk (decoder + layers 2-4) as per-conv effective
    weights on the CPU: {"dec_in": (scale, bias), "dec": [convs],
    "stages": [[blocks]]}."""
    body = model.backbone.body
    if not body.injected:
        raise ValueError("the int8 tail needs a bottleneck (custom_resnet) "
                         "model")
    dec = body.layer1.decoder
    out: Folded = {"dec_in": _batch_norm_affine(dec[0])}
    out["dec"] = [_fold_conv_bn(dec[c], *_batch_norm_affine(dec[b]),
                                relu=i in _DEC_RELU_AFTER)
                  for i, (c, b) in enumerate(_DEC_CONV_BN)]
    stages: List[List[Folded]] = []
    for stage in (2, 3, 4):
        blocks = []
        for blk in getattr(body, f"layer{stage}"):
            f = {"conv1": _fold_conv_bn(blk.conv1, *_frozen_bn_affine(blk.bn1),
                                        relu=True),
                 "conv2": _fold_conv_bn(blk.conv2, *_frozen_bn_affine(blk.bn2),
                                        relu=True),
                 "conv3": _fold_conv_bn(blk.conv3, *_frozen_bn_affine(blk.bn3),
                                        relu=False)}
            if blk.downsample is not None:
                f["downsample"] = _fold_conv_bn(
                    blk.downsample[0], *_frozen_bn_affine(blk.downsample[1]),
                    relu=False)
            blocks.append(f)
        stages.append(blocks)
    out["stages"] = stages
    return out


def _map_convs(folded: Folded, fn) -> Folded:
    return {"dec_in": folded["dec_in"],
            "dec": [fn(fw) for fw in folded["dec"]],
            "stages": [[{k: fn(v) for k, v in blk.items()} for blk in blocks]
                       for blocks in folded["stages"]]}


def quantize_folded(folded: Folded) -> Folded:
    """Symmetric per-output-channel int8 weights: each conv entry gains
    ``qw`` (int8 [C_out, kh, kw, C / groups]) and ``sw`` ([C_out]
    float32)."""
    def quant_conv(fw: Folded) -> Folded:
        w = fw["w"]
        amax = w.abs().amax(dim=(1, 2, 3))
        sw = torch.where(amax > 0, amax / torch.tensor(127.0, device=w.device),
                         torch.ones_like(amax))
        qw = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127)
        return dict(fw, qw=torch.nan_to_num(qw, nan=0.0).to(torch.int8),
                    sw=sw)
    return _map_convs(folded, quant_conv)


def _to_device(folded: Folded, device: torch.device) -> Folded:
    """The folded tail on ``device``; a quantized conv also gets its zero
    point's share without padding (128 x the sum of its weights, per
    channel: 128 x an integer below 2^24, exact in float32) and the sum of
    its weights over the input channels (float64, for the border maps)."""
    def move(fw: Folded) -> Folded:
        out = {k: (v.to(device) if torch.is_tensor(v) else v)
               for k, v in fw.items()}
        if "qw" in fw:
            wsum = fw["qw"].to(torch.int64).sum(dim=3)  # [C_out, kh, kw]
            out["zp_sum"] = (_ZP * wsum.sum(dim=(1, 2))).to(
                torch.float32).to(device)
            out["wsum"] = wsum.to(torch.float64).to(device)
            out["zp_maps"] = {}
        return out
    moved = _map_convs(folded, move)
    if folded["dec_in"] is not None:
        moved["dec_in"] = tuple(t.to(device) for t in folded["dec_in"])
    return moved


# ---------------------------------------------------------------------------
# The shared trunk traversal, parameterized by an ops kit
# ---------------------------------------------------------------------------

def _conv_fp(x: torch.Tensor, fw: Folded, stride: int,
             pad: int) -> torch.Tensor:
    """Float32 conv of NHWC ``x`` with the folded weights, plus the bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), fw["w"].permute(0, 3, 1, 2),
                 stride=stride, padding=pad, groups=fw["groups"])
    return y.permute(0, 2, 3, 1) + fw["b"]


@contextlib.contextmanager
def _no_tf32():
    """Float32 convolutions in float32 (ROADMAP C4)."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


class _CalibKit:
    """Float32 walk recording max |x| at every requantization site."""

    def __init__(self):
        self.amax: Dict[str, torch.Tensor] = {}

    def site(self, name, x, unsigned=False):
        self.amax[name] = x.abs().amax()
        return x

    def conv(self, name, x, fw, stride=1, pad=0, relu=False, feature=False):
        y = _conv_fp(x, fw, stride, pad)
        if relu:
            y = torch.relu(y)
        return self.site(name, y)

    def conv_fp_out(self, x, fw, stride=1, pad=0):
        return _conv_fp(x, fw, stride, pad)

    def conv_residual(self, name, x, fw, identity, feature=False):
        """relu(conv3(x) + identity) at the block's output site."""
        return self.site(name, torch.relu(_conv_fp(x, fw, 1, 0) + identity),
                         unsigned=True)

    def feature(self, name, x):
        return x


class _QuantKit:
    """int8 walk: activations are (codes NHWC int8, scale, zero point)
    triples between sites, value = (q + zero point) scale with the zero
    point 0 or 128.  ``scales`` maps a site to its (s, s 127/255) as 0-d
    float32 tensors on the walk's device; ``sites``, when given, receives
    each site's codes.  Every convolution is one ``int8_conv_requant``
    call, its epilogue in its store; a stage output's convolution also
    writes the output dequantized, NCHW (``feature``)."""

    def __init__(self, scales: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                 sites: Optional[Dict[str, torch.Tensor]] = None):
        self.scales = scales
        self.sites = sites
        self.features: Dict[str, torch.Tensor] = {}

    def _record(self, name, codes, unsigned):
        s, su = self.scales[name]
        if self.sites is not None:
            self.sites[name] = codes
        return (codes, su, _ZP) if unsigned else (codes, s, 0)

    def site(self, name, x_fp, unsigned=False):
        s, su = self.scales[name]
        return self._record(name, requantize_plain(x_fp, su if unsigned
                                                   else s, unsigned),
                            unsigned)

    @staticmethod
    def _border_map(fw: Folded, hw: Tuple[int, int], stride: int,
                    pad: int) -> torch.Tensor:
        """128 x the sum of the weights over each output pixel's in-image
        taps, [1, Ho, Wo, C_out] float32 (128 x an integer below 2^24:
        exact); cached in ``fw`` per input size."""
        m = fw["zp_maps"].get(hw)
        if m is None:
            wsum = fw["wsum"]
            kh, kw = wsum.shape[1:]

            def inside(n, k):  # [out, k]: tap k of output i is in the image
                pos = (torch.arange(out_size(n, k, stride, pad),
                                    device=wsum.device)[:, None] * stride
                       - pad + torch.arange(k, device=wsum.device)[None, :])
                return ((pos >= 0) & (pos < n)).to(torch.float64)

            m = torch.einsum("hi,wj,cij->hwc", inside(hw[0], kh),
                             inside(hw[1], kw), wsum)
            m = (_ZP * m).to(torch.float32)[None].contiguous()
            fw["zp_maps"][hw] = m
        return m

    def _requant(self, xq, fw, stride, pad, mode, **epilogue):
        """The conv of ``xq`` by ``fw`` with the epilogue of ``mode``: y =
        (float(acc) + zero point's share) (s_in sw) + b, then the mode's
        steps.  True x = (q + 128) s: the share is 128 x the weights of the
        in-image taps (zero-padded codes contribute 0, the true
        padding)."""
        q, s_in, zp = xq
        share = None
        if zp:
            share = fw["zp_sum"] if pad == 0 else self._border_map(
                fw, tuple(q.shape[1:3]), stride, pad)
        return int8_conv_requant(q, fw["qw"], stride, pad, fw["groups"],
                                 mode=mode, scale=s_in * fw["sw"],
                                 bias=fw["b"], zp=share, **epilogue)

    def _acc(self, xq, fw, stride, pad):
        return self._requant(xq, fw, stride, pad, "float")

    def _site_out(self, name, out, unsigned, feature):
        codes = out
        if feature:
            codes, self.features[name] = out
        return self._record(name, codes, unsigned)

    def conv(self, name, xq, fw, stride=1, pad=0, relu=False, feature=False):
        s, su = self.scales[name]
        out = self._requant(xq, fw, stride, pad, "site",
                            site_scale=su if relu else s, relu=relu,
                            unsigned=relu, features=feature)
        return self._site_out(name, out, relu, feature)

    def conv_fp_out(self, xq, fw, stride=1, pad=0):
        return self._acc(xq, fw, stride, pad)

    def conv_residual(self, name, xq, fw, identity, feature=False):
        """relu(conv3(xq) + identity) at the block's output site, the
        identity the downsample's float32 or the block input's codes."""
        out = self._requant(xq, fw, 1, 0, "residual",
                            site_scale=self.scales[name][1],
                            identity=identity, features=feature)
        return self._site_out(name, out, True, feature)

    def feature(self, name, xq):
        """The stage output ``name`` dequantized, NHWC (a view of the NCHW
        tensor its convolution wrote)."""
        return self.features.pop(name).permute(0, 2, 3, 1)


def _trunk_walk(kit, z_fp: torch.Tensor, folded: Folded
                ) -> List[torch.Tensor]:
    """decoder -> layers 2-4 on the NHWC wire tensor; returns the NHWC
    float features of layer1..layer4.  The sites, in order: dec_in,
    dec0-dec3, then per block c1, c2 and out (relu(conv3 + identity))."""
    inv, shift = folded["dec_in"]
    x = kit.site("dec_in", torch.relu(z_fp.float() * inv + shift),
                 unsigned=True)
    last = len(folded["dec"]) - 1
    for i, fw in enumerate(folded["dec"]):
        # decoder convs: kernel 2, stride 1, no padding
        x = kit.conv(f"dec{i}", x, fw, relu=fw["relu"], feature=i == last)
    feats = [kit.feature(f"dec{last}", x)]
    for s_i, blocks in enumerate(folded["stages"]):
        for b_i, blk in enumerate(blocks):
            stride = 2 if b_i == 0 else 1
            name = f"s{s_i}b{b_i}"
            y = kit.conv(name + "c1", x, blk["conv1"], relu=True)
            y = kit.conv(name + "c2", y, blk["conv2"], stride=stride, pad=1,
                         relu=True)
            identity = x if "downsample" not in blk else kit.conv_fp_out(
                x, blk["downsample"], stride=stride)
            x = kit.conv_residual(name + "out", y, blk["conv3"], identity,
                                  feature=b_i == len(blocks) - 1)
        feats.append(kit.feature(name + "out", x))
    return feats


def _device(model: RCNN) -> torch.device:
    return next(model.parameters()).device


def _site_scales(act_scales: Dict[str, float], device: torch.device
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Each site's (s, su = s float32(127/255)) as 0-d float32 tensors on
    ``device``, made on the CPU in one copy (the walk never waits for the
    host)."""
    names = sorted(act_scales)
    s = torch.tensor([act_scales[n] for n in names], dtype=torch.float32)
    su = s * torch.tensor(127.0 / 255.0, dtype=torch.float32)  # = amax/255
    both = torch.stack([s, su]).to(device)
    return {n: (both[0, i], both[1, i]) for i, n in enumerate(names)}


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_tail(model: RCNN, z_batches: Sequence) -> Dict[str, float]:
    """The float32 folded walk over calibration bottleneck tensors (the
    dequantized wire, NHWC [B, H', W', C']: what the tail will see), TF32
    off; returns each site's scale, max |x| / 127 (1 where that max is
    0)."""
    dev = _device(model)
    folded = _to_device(fold_tail(model), dev)
    amax: Dict[str, float] = {}
    with _no_tf32():
        for z in z_batches:
            kit = _CalibKit()
            _trunk_walk(kit, torch.as_tensor(z, dtype=torch.float32).to(dev),
                        folded)
            names = list(kit.amax)
            values = torch.stack([kit.amax[n] for n in names]).cpu().tolist()
            for k, v in zip(names, values):
                amax[k] = max(amax.get(k, 0.0), v)
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in amax.items()}


def _dequantized(q: torch.Tensor, scale: torch.Tensor,
                 zero_point: torch.Tensor) -> torch.Tensor:
    """The wire tensor as float32 NHWC: the dequantize kernel for codes."""
    if q.dtype != torch.uint8:
        return q.float()  # a float16 / float32 wire carries no codes
    return quant_kernels.dequantize(QuantizedTensor(q, scale, zero_point))


def calibrate_from_images(model: RCNN, image_batches: Sequence,
                          quant_bits: int = 8) -> Dict[str, float]:
    """SplitRCNN's head (the wire codec included) on calibration images
    -> the dequantized wire tensors -> ``calibrate_tail``."""
    split = SplitRCNN(model, quant_bits)
    zs = []
    for images in image_batches:
        q, scale, zp, _ = split.head_fn(torch.as_tensor(images)
                                        .to(split.device))
        zs.append(_dequantized(q, scale, zp))
    return calibrate_tail(model, zs)


# ---------------------------------------------------------------------------
# The deployable int8 tail
# ---------------------------------------------------------------------------

class Int8SplitTail:
    """Server tail with an integer trunk; a drop-in for SplitRCNN's
    tail_call (the same 8-bit wire in, the same detection dict out)."""

    def __init__(self, model: RCNN, act_scales: Dict[str, float]):
        self.model = model.eval()
        self.device = _device(model)
        self.qfolded = _to_device(quantize_folded(fold_tail(model)),
                                  self.device)
        self.act_scales = dict(act_scales)
        self.scales = _site_scales(self.act_scales, self.device)

    def trunk(self, z: torch.Tensor,
              sites: Optional[Dict[str, torch.Tensor]] = None
              ) -> List[torch.Tensor]:
        """The int8 walk on NHWC float ``z``: NHWC float features (views of
        the NCHW ones)."""
        return _trunk_walk(_QuantKit(self.scales, sites), z, self.qfolded)

    def trunk_nchw(self, z: torch.Tensor) -> List[torch.Tensor]:
        """The int8 walk's features as the FPN reads them: contiguous NCHW
        float32, as the stage outputs' convolutions wrote them."""
        return [f.permute(0, 3, 1, 2) for f in self.trunk(z)]

    @torch.no_grad()
    def tail_fn(self, q_tensor: torch.Tensor, scale: torch.Tensor,
                zero_point: torch.Tensor, image_sizes: torch.Tensor,
                bucket_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """dequantize -> the int8 trunk -> FPN -> RPN -> RoI heads, on the
        device; ``q_tensor`` is the NHWC uint8 wire tensor."""
        if q_tensor.dtype != torch.uint8:
            raise ValueError(f"the int8 tail takes the 8-bit wire, not "
                             f"{q_tensor.dtype}")
        model = self.model
        fpn = model.backbone.fpn(self.trunk_nchw(
            _dequantized(q_tensor, scale, zero_point)))
        proposals, prop_valid, _ = model.rpn.propose(fpn, image_sizes,
                                                     tuple(bucket_hw))
        return model.roi_heads.infer(fpn, proposals, prop_valid, image_sizes,
                                     tuple(bucket_hw))

    def build(self):
        """tail_call(wire tensor, scale, zero_point, image_sizes,
        bucket_hw) -> the detections as numpy (SplitRCNN.build's
        tail_call)."""
        dev = self.device

        def tail_call(q_tensor, scale, zero_point, image_sizes, bucket_hw):
            dets = self.tail_fn(
                torch.from_numpy(np.array(q_tensor)).to(dev),  # writable
                torch.tensor(scale, dtype=torch.float32, device=dev),
                torch.tensor(zero_point, dtype=torch.float32, device=dev),
                torch.from_numpy(np.asarray(image_sizes, np.int32)).to(dev),
                bucket_hw)
            return {k: v.cpu().numpy() for k, v in dets.items()}
        return tail_call


@torch.no_grad()
def trunk_features_fp(model: RCNN, z_fp) -> List[torch.Tensor]:
    """The float32 folded walk's features, NHWC (the reference for the
    int8 walk: the model's own eval-mode decode + layers 2-4)."""
    dev = _device(model)
    folded = _to_device(fold_tail(model), dev)
    with _no_tf32():
        return _trunk_walk(_CalibKit(), torch.as_tensor(
            z_fp, dtype=torch.float32).to(dev), folded)


@torch.no_grad()
def trunk_features_int8(model: RCNN, z_fp, act_scales: Dict[str, float],
                        sites: Optional[Dict[str, torch.Tensor]] = None
                        ) -> List[torch.Tensor]:
    """The int8 walk's features (dequantized at the stage outputs),
    NHWC; ``sites``, when given, receives each site's codes."""
    tail = Int8SplitTail(model, act_scales)
    return tail.trunk(torch.as_tensor(z_fp, dtype=torch.float32)
                      .to(tail.device), sites)
