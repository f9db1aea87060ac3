"""Split-computing deployment: the edge head, the server tail and the byte
wire between them.

Counterpart of hnd_ghnd_tpu/split/deploy.py (reference
src/models/mimic/split_rcnn.py).  The head is the model's own stem, ext
filter (when it has one) and bottleneck encoder, and the 8-bit quantizer
(or a float16 cast, or nothing); the tail is the dequantizer, the
bottleneck decoder, layers 2-4, the FPN, the RPN and the RoI heads.  Both
run on the model's device and call its modules, so head -> bytes -> tail
computes what ``RCNN.detect`` with ``use_bottleneck_transformer`` computes,
bit for bit: the same kernels (quant_kernels.quantize in the head,
dequantize in the tail) on the same codes.

The wire is the JAX package's, byte for byte (``HGW1``): a JSON header
with the tensor's dtype and NHWC shape, the scale and zero point, the valid
and original image sizes and the ext filter's output, then the tensor.
The head quantizes the dense NCHW encoder output (the batch-global scale,
bucket padding included, ROADMAP C3) and makes the codes NHWC-contiguous
before the copy to the host; the tail makes them contiguous NCHW again
before the dequantize kernel, whose scale and zero point it hands over as
0-d float32 tensors on the device (the float32 scale crosses as a Python
float in JSON, which is exact).

``JpegInputSplit`` is the RGB-over-wire baseline (``HGJ1``): the edge
JPEG-encodes each image's valid crop, the server decodes them into the
bucket and runs the whole detector without the bottleneck round trip.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from hnd_ghnd_tpu_torch.codec.quantizer import QuantizedTensor
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.ops import quant_kernels
from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute

StateDict = Dict[str, torch.Tensor]

_MAGIC = b"HGW1"  # hnd-ghnd wire format v1

# The wire crosses a network boundary, so the decoder fails clean on
# malformed input.  Only these payload dtypes are ever produced by the head
# (8-bit codes, the float16 wire, float32 without quantization):
_WIRE_DTYPES = ("uint8", "float16", "float32")
_MAX_META_BYTES = 1 << 20          # metadata is a few hundred bytes in practice
_MAX_TENSOR_BYTES = 1 << 31        # 2 GB, far above any real bottleneck


class WireError(ValueError):
    """Malformed split-wire packet (bad magic, truncation, inconsistent
    metadata): raised before any byte is read as tensor data."""


class WirePacket(NamedTuple):
    """What crosses the edge -> server boundary."""
    tensor: np.ndarray        # uint8 [B, H', W', C'] (float16 / float32)
    scale: float
    zero_point: float
    image_sizes: np.ndarray   # [B, 2] valid sizes in the padded bucket
    original_sizes: np.ndarray  # [B, 2]
    ext_logits: Optional[np.ndarray]  # [B, 2] or None


def pack_wire(p: WirePacket) -> bytes:
    meta = {
        "dtype": str(p.tensor.dtype), "shape": list(p.tensor.shape),
        "scale": float(p.scale), "zero_point": float(p.zero_point),
        "image_sizes": np.asarray(p.image_sizes).tolist(),
        "original_sizes": np.asarray(p.original_sizes).tolist(),
        "ext": None if p.ext_logits is None
               else np.asarray(p.ext_logits).tolist(),
    }
    mb = json.dumps(meta).encode()
    body = np.ascontiguousarray(p.tensor).tobytes()
    return _MAGIC + struct.pack("<I", len(mb)) + mb + body


def _sizes_array(meta: dict, key: str, batch: int) -> np.ndarray:
    try:
        arr = np.asarray(meta[key], np.int32)
    except (KeyError, TypeError, ValueError, OverflowError) as e:
        raise WireError(f"wire metadata `{key}` is not an int array") from e
    if arr.shape != (batch, 2) or (arr <= 0).any():
        raise WireError(f"wire metadata `{key}` has shape {arr.shape}, "
                        f"expected ({batch}, 2) of positive sizes")
    return arr


def unpack_wire(buf: bytes) -> WirePacket:
    """Decode and validate a wire packet.  Every corruption (wrong magic,
    truncated header, metadata or body, oversized or non-JSON metadata, a
    dtype outside the head's, a shape that disagrees with the body) raises
    ``WireError`` before any byte is read as tensor data."""
    if len(buf) < 8:
        raise WireError(f"wire packet truncated: {len(buf)} bytes < 8-byte header")
    if buf[:4] != _MAGIC:
        raise WireError(f"bad wire magic {buf[:4]!r} (expected {_MAGIC!r})")
    (mlen,) = struct.unpack("<I", buf[4:8])
    if mlen > _MAX_META_BYTES:
        raise WireError(f"wire metadata length {mlen} exceeds "
                        f"{_MAX_META_BYTES} byte cap")
    if len(buf) < 8 + mlen:
        raise WireError(f"wire packet truncated inside metadata "
                        f"({len(buf)} bytes, header claims {mlen})")
    try:
        meta = json.loads(buf[8:8 + mlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError("wire metadata is not valid JSON") from e
    if not isinstance(meta, dict):
        raise WireError("wire metadata is not a JSON object")

    dtype_name = meta.get("dtype")
    if dtype_name not in _WIRE_DTYPES:
        raise WireError(f"wire dtype {dtype_name!r} not in {_WIRE_DTYPES}")
    dtype = np.dtype(dtype_name)
    shape = meta.get("shape")
    if (not isinstance(shape, list) or len(shape) != 4
            or not all(isinstance(d, int) and d > 0 for d in shape)):
        raise WireError(f"wire tensor shape {shape!r} is not a positive "
                        "4-entry [B, H, W, C] list")
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if nbytes > _MAX_TENSOR_BYTES:
        raise WireError(f"wire tensor claims {nbytes} bytes, above the "
                        f"{_MAX_TENSOR_BYTES} cap")
    body = buf[8 + mlen:]
    if len(body) != nbytes:
        raise WireError(f"wire body is {len(body)} bytes but shape/dtype "
                        f"metadata implies {nbytes}")
    try:
        scale = float(meta["scale"])
        zero_point = float(meta["zero_point"])
    except (KeyError, TypeError, ValueError) as e:
        raise WireError("wire scale/zero_point missing or non-numeric") from e
    tensor = np.frombuffer(body, dtype=dtype).reshape(shape)
    image_sizes = _sizes_array(meta, "image_sizes", shape[0])
    original_sizes = _sizes_array(meta, "original_sizes", shape[0])
    ext = meta.get("ext")
    if ext is not None:
        try:
            ext = np.asarray(ext, np.float32)
        except (TypeError, ValueError) as e:
            raise WireError("wire ext logits are not a float array") from e
        if ext.shape != (shape[0], 2):
            raise WireError(f"wire ext logits have shape {ext.shape}, "
                            f"expected ({shape[0]}, 2)")
    return WirePacket(tensor, scale, zero_point, image_sizes, original_sizes,
                      ext)


_HEAD = ("backbone.body.conv1.", "backbone.body.bn1.",
         "backbone.body.layer1.encoder.")


def _split_head_params(sd: StateDict) -> StateDict:
    """The edge's entries of a model's ``state_dict``: the stem, the
    encoder and the ext filter (it lives under the encoder)."""
    return {k: v for k, v in sd.items() if k.startswith(_HEAD)}


def _split_tail_params(sd: StateDict) -> StateDict:
    """Every other entry: the decoder, layers 2-4, FPN, RPN, RoI heads."""
    return {k: v for k, v in sd.items() if not k.startswith(_HEAD)}


def _to_original(dets: Dict[str, np.ndarray], image_sizes: np.ndarray,
                 original_sizes: np.ndarray) -> Dict[str, np.ndarray]:
    """Boxes from the padded bucket to each image's original size, with
    ``boxes_model`` keeping the bucket's (RCNN.detect's float32 steps)."""
    scale = original_sizes.astype(np.float32) / image_sizes.astype(np.float32)
    sy, sx = scale[:, 0][:, None], scale[:, 1][:, None]
    b = dets["boxes"]
    dets["boxes_model"] = b
    dets["boxes"] = np.stack([b[..., 0] * sx, b[..., 1] * sy,
                              b[..., 2] * sx, b[..., 3] * sy], axis=-1)
    return dets


class SplitRCNN:
    """The head and tail of a trained bottleneck RCNN, on its device."""

    def __init__(self, model: RCNN, quant_bits: Optional[int] = 8):
        if not model.backbone.body.injected:
            raise ValueError("split deployment needs a bottleneck "
                             "(custom_resnet) model")
        self.model = model.eval()
        self.quant_bits = quant_bits
        self.device = next(model.parameters()).device

    # ----------------------------------------------------------------- head
    @torch.no_grad()
    def head_fn(self, images: torch.Tensor):
        """normalize -> stem -> (ext) -> encoder -> quantize, on the
        device.  Returns (the wire tensor NHWC-contiguous, scale, zero
        point, the ext filter's probabilities or zeros [B, 2])."""
        model = self.model
        body = model.backbone.body
        bott = body.layer1
        y = body.stem(model.normalize(images_to_compute(images,
                                                        torch.float32)))
        ext = bott.encoder.ext_classifier
        if ext is None:
            ext_out = torch.zeros((images.shape[0], 2), dtype=torch.float32,
                                  device=y.device)
        else:
            ext.train(False)
            ext_out = ext(y)
        z = bott.encode(y)
        if self.quant_bits in (None, 16):
            # no codec: scale 1 and zero point 0 on the wire, as in JAX
            wire = z if self.quant_bits is None else z.half()
            return (wire.permute(0, 2, 3, 1).contiguous(),
                    torch.ones((), device=y.device),
                    torch.zeros((), device=y.device), ext_out)
        q = quant_kernels.quantize(z, self.quant_bits)
        return (q.tensor.permute(0, 2, 3, 1).contiguous(), q.scale,
                q.zero_point, ext_out)

    # ----------------------------------------------------------------- tail
    @torch.no_grad()
    def tail_fn(self, q_tensor: torch.Tensor, scale: torch.Tensor,
                zero_point: torch.Tensor, image_sizes: torch.Tensor,
                bucket_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
        """dequantize -> decoder -> layers 2-4 -> FPN -> RPN -> RoI heads,
        on the device.  ``q_tensor`` is the NHWC wire tensor; returns the
        fixed-shape detections in the bucket's coordinates."""
        model = self.model
        body = model.backbone.body
        z = q_tensor.permute(0, 3, 1, 2).contiguous()
        if self.quant_bits == 16:
            z = z.float()
        elif self.quant_bits is not None:
            z = quant_kernels.dequantize(QuantizedTensor(z, scale, zero_point))
        y = body.layer1.decode(z)
        feats = [y]
        for stage in (2, 3, 4):
            y = getattr(body, f"layer{stage}")(y)
            feats.append(y)
        fpn = model.backbone.fpn(feats)
        proposals, prop_valid, _ = model.rpn.propose(fpn, image_sizes,
                                                     tuple(bucket_hw))
        return model.roi_heads.infer(fpn, proposals, prop_valid, image_sizes,
                                     tuple(bucket_hw))

    # --------------------------------------------------------------- calls
    def build(self):
        """(head_call, tail_call, (head entries, tail entries) of the
        model's ``state_dict``).

        head_call(images [B, H, W, 3] in [0, 1] or uint8) -> the head's
        outputs on the host (numpy wire tensor, float scale and zero
        point, numpy ext output); tail_call(wire tensor, scale, zero_point,
        image_sizes, bucket_hw) -> the detections as numpy."""
        sd = self.model.state_dict()
        dev = self.device

        def head_call(images):
            q, scale, zp, ext = self.head_fn(
                torch.as_tensor(images).to(dev))
            return (q.cpu().numpy(), float(scale), float(zp),
                    ext.cpu().numpy())

        def tail_call(q_tensor, scale, zero_point, image_sizes, bucket_hw):
            dets = self.tail_fn(
                torch.from_numpy(np.array(q_tensor)).to(dev),  # writable
                torch.tensor(scale, dtype=torch.float32, device=dev),
                torch.tensor(zero_point, dtype=torch.float32, device=dev),
                torch.from_numpy(np.asarray(image_sizes, np.int32)).to(dev),
                bucket_hw)
            return {k: v.cpu().numpy() for k, v in dets.items()}

        return head_call, tail_call, (_split_head_params(sd),
                                      _split_tail_params(sd))

    # ------------------------------------------------------- host protocol
    def run_edge(self, head_call, images, image_sizes, original_sizes,
                 ext_threshold: Optional[float] = None) -> Optional[bytes]:
        """The edge: the wire bytes, or None when the ext filter stops a
        batch of one image (the reference's RcnnHead returning None,
        split_rcnn.py:29-33).  A larger batch is never stopped."""
        q, scale, zp, ext_np = head_call(images)
        if (ext_threshold is not None
                and self.model.backbone.body.layer1.encoder.ext_classifier
                is not None
                and q.shape[0] == 1 and ext_np[0, 1] < ext_threshold):
            return None
        return pack_wire(WirePacket(q, scale, zp, np.asarray(image_sizes),
                                    np.asarray(original_sizes), ext_np))

    def run_server(self, tail_call, wire: bytes,
                   bucket_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """The server: wire bytes -> detections, ``boxes`` in original-image
        coordinates and ``boxes_model`` in the bucket's."""
        p = unpack_wire(wire)
        dets = tail_call(p.tensor, p.scale, p.zero_point, p.image_sizes,
                         bucket_hw)
        return _to_original(dets, p.image_sizes, p.original_sizes)


def split_rcnn_model(model: RCNN, quantization: Optional[int] = 8):
    """The reference API (split_rcnn.py:215-221): (head_call, tail_call,
    the state_dict's head and tail entries)."""
    return SplitRCNN(model, quantization).build()


_MAGIC_JPEG = b"HGJ1"  # RGB-over-wire format v1


class JpegInputSplit:
    """RGB-over-wire baseline: the edge JPEG-encodes each resized frame's
    valid crop and the server runs the whole detector on the decoded
    pixels (the input compression the reference's cost analyzer prices
    the bottleneck against, src/cost_analyzer.py:89-137).  PIL is imported
    by the functions that encode and decode."""

    def __init__(self, model: Optional[RCNN], quality: int = 95):
        self.model = model
        self.quality = int(quality)

    # ----------------------------------------------------------------- edge
    def run_edge(self, images, image_sizes, original_sizes) -> bytes:
        """images: [B, H, W, 3] float in [0, 1] (the padded bucket).  Each
        image is cropped to its valid size: padding never crosses."""
        from PIL import Image

        images = np.asarray(images)
        image_sizes = np.asarray(image_sizes, np.int32)
        blobs = []
        for i in range(images.shape[0]):
            h, w = int(image_sizes[i, 0]), int(image_sizes[i, 1])
            u8 = np.clip(np.asarray(images[i, :h, :w]) * 255.0 + 0.5,
                         0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(u8).save(buf, format="JPEG",
                                     quality=self.quality)
            blobs.append(buf.getvalue())
        meta = {
            "quality": self.quality,
            "lengths": [len(b) for b in blobs],
            "image_sizes": image_sizes.tolist(),
            "original_sizes": np.asarray(original_sizes).tolist(),
        }
        mb = json.dumps(meta).encode()
        return _MAGIC_JPEG + struct.pack("<I", len(mb)) + mb + b"".join(blobs)

    # --------------------------------------------------------------- server
    def build_server(self):
        """server_call(images, image_sizes, original_sizes) -> the whole
        detector's detections as numpy, without the bottleneck round
        trip, on the model's device."""
        model = self.model.eval()
        dev = next(model.parameters()).device

        def server_call(images, image_sizes, original_sizes):
            batch = {"images": torch.from_numpy(np.asarray(images)).to(dev),
                     "image_sizes": torch.from_numpy(
                         np.asarray(image_sizes, np.int32)).to(dev),
                     "original_sizes": torch.from_numpy(
                         np.asarray(original_sizes, np.int32)).to(dev)}
            dets = model(batch, use_bottleneck_transformer=False)
            return {k: v.cpu().numpy() for k, v in dets.items()}
        return server_call

    def run_server(self, server_call, wire: bytes,
                   bucket_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """Decode the JPEG payload into the bucket and run the whole
        detector; boxes come back in original-image coordinates."""
        if len(wire) < 8:
            raise WireError("jpeg-wire packet truncated before header")
        if wire[:4] != _MAGIC_JPEG:
            raise WireError(f"bad jpeg-wire magic {wire[:4]!r}")
        (mlen,) = struct.unpack("<I", wire[4:8])
        if mlen > _MAX_META_BYTES or len(wire) < 8 + mlen:
            raise WireError("jpeg-wire metadata truncated or oversized")
        try:
            meta = json.loads(wire[8:8 + mlen].decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise WireError("jpeg-wire metadata is not valid JSON") from e
        lengths = meta.get("lengths")
        if (not isinstance(lengths, list)
                or not all(isinstance(n, int) and n >= 0 for n in lengths)):
            raise WireError("jpeg-wire lengths metadata malformed")
        if sum(lengths) != len(wire) - 8 - mlen:
            raise WireError("jpeg-wire body length disagrees with metadata")
        batch = len(lengths)
        image_sizes = _sizes_array(meta, "image_sizes", batch)
        original_sizes = _sizes_array(meta, "original_sizes", batch)
        bh, bw = bucket_hw
        if (image_sizes[:, 0] > bh).any() or (image_sizes[:, 1] > bw).any():
            raise WireError("jpeg-wire image sizes exceed the bucket")
        from PIL import Image

        body = wire[8 + mlen:]
        images = np.zeros((batch, bh, bw, 3), np.float32)
        off = 0
        for i, n in enumerate(lengths):
            u8 = np.asarray(Image.open(io.BytesIO(body[off:off + n]))
                            .convert("RGB"), np.uint8)
            off += n
            h, w = int(image_sizes[i, 0]), int(image_sizes[i, 1])
            images[i, :h, :w] = u8.astype(np.float32) / 255.0
        return server_call(images, image_sizes, original_sizes)
