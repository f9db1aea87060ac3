"""Ahead-of-time export of the split head/tail programs (torch.export).

Counterpart of hnd_ghnd_tpu/split/export.py, with its names.  The edge
HEAD and the server TAIL of split/deploy.py's ``SplitRCNN`` are traced by
``torch.export.export`` at static shapes on the model's device, each from a
module that holds only its own half of the weights, and serialized with
``torch.export.save`` inside JAX's pickle envelope.  A serving process
loads them and calls them without the model code or its config.

Unlike JAX's StableHLO, an artifact is not self-contained: the port's
kernels are ``torch.library`` custom ops (ops/library.py: the quantizer
pair, the RoIAlign forward on float32 and int8 tables, the level quantizer,
the fused stem when ``HND_TPU_PALLAS_STEM=1`` was set at export, and the
NMS), recorded as calls by name.  Loading one needs
``hnd_ghnd_tpu_torch.ops.library`` imported (this module imports it), and
its CUDA implementations build the kernel library from the checkout's
sources at their first launch.  An artifact runs on the device type it was
exported on: a CUDA artifact on a machine without a card raises, and
nothing falls back to the CPU.  A CPU artifact runs the ops' plain
versions.

Artifact layout (single file, pickle):
  {"format": "hnd-ghnd-split-torch-v1",
   "bucket_hw": (H, W), "batch": B, "quant_bits": int|None,
   "device": "cuda" | "cpu", "fused_stem": bool,
   "head": bytes (torch.export.save), "tail": bytes (torch.export.save),
   "meta": {model kind, num_classes, bottleneck channels}}

Head signature:  images [B, H, W, 3] f32 in [0,1]
              -> (q_tensor NHWC, scale, zero_point, ext)
Tail signature:  (q_tensor, scale, zero_point, image_sizes [B,2] i32)
              -> detection dict (padded-bucket coords)

``export_sharded_tail`` exports the tail for ``batch_per_shard`` images,
and ``ExportedShardedTail.call`` runs one copy of it per device, each shard
with its own edge's scale and zero point: the port's counterpart of JAX's
``shard_map`` over a mesh.
"""
from __future__ import annotations

import contextlib
import copy
import io
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from hnd_ghnd_tpu_torch.models.resnet import use_fused_stem
from hnd_ghnd_tpu_torch.ops import library  # noqa: F401 (the custom ops)
from hnd_ghnd_tpu_torch.split import deploy
from hnd_ghnd_tpu_torch.split.deploy import SplitRCNN

FORMAT = "hnd-ghnd-split-torch-v1"
FORMAT_SET = "hnd-ghnd-splitset-torch-v2"
FORMAT_SHARDED = "hnd-ghnd-sharded-tail-torch-v1"
# the JAX package's formats (jax.export StableHLO), which the port refuses
JAX_FORMATS = ("hnd-ghnd-split-v1", "hnd-ghnd-splitset-v2",
               "hnd-ghnd-sharded-tail-v1")

# the edge's submodules (split/deploy.py's head/tail split of the weights)
_HEAD_ONLY = tuple(p.rstrip(".") for p in deploy._HEAD)


def _outside(module: torch.nn.Module, keep: Sequence[str],
             prefix: str = "") -> List[str]:
    """The dotted paths of ``module``'s largest submodules that neither
    hold nor lie in one of the paths ``keep``."""
    out = []
    for name, child in module.named_children():
        path = prefix + name
        if path in keep:
            continue
        if any(k.startswith(path + ".") for k in keep):
            out += _outside(child, keep, path + ".")
        else:
            out.append(path)
    return out


def _without(module: torch.nn.Module, drop: Sequence[str]) -> torch.nn.Module:
    """A shallow copy of ``module`` without the submodules at the dotted
    paths ``drop``; the modules it keeps are shared, not copied."""
    out = copy.copy(module)
    out._modules = dict(module._modules)
    groups: Dict[str, List[str]] = {}
    for path in drop:
        name, _, rest = path.partition(".")
        groups.setdefault(name, []).append(rest)
    for name, rests in groups.items():
        out._modules[name] = (None if "" in rests
                              else _without(module._modules[name], rests))
    return out


class _Head(torch.nn.Module):
    def __init__(self, split: SplitRCNN):
        super().__init__()
        self.model = split.model
        self.split = split

    def forward(self, images):
        return self.split.head_fn(images)


class _Tail(torch.nn.Module):
    def __init__(self, split: SplitRCNN, bucket_hw: Tuple[int, int]):
        super().__init__()
        self.model = split.model
        self.split = split
        self.bucket_hw = tuple(bucket_hw)

    def forward(self, q, scale, zero_point, image_sizes):
        return self.split.tail_fn(q, scale, zero_point, image_sizes,
                                  self.bucket_hw)


def _save(ep) -> bytes:
    # without the example inputs, which the archive would otherwise hold
    # (a batch-8 bucket of images is 107 MB)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _meta(model) -> Dict[str, Any]:
    return {"kind": model.kind,
            "num_classes": model.roi_heads.num_classes,
            "bottleneck_channel":
                model.backbone.body.layer1.decoder[0].num_features}


def _export_halves(model, bucket_hw, batch: int, quant_bits,
                   with_head: bool = True):
    """The (head, tail) programs of one (bucket, batch); the head None
    without ``with_head``."""
    split = SplitRCNN(model, quant_bits)
    dev = split.device
    h, w = bucket_hw
    images = torch.zeros((batch, h, w, 3), dtype=torch.float32, device=dev)
    head_model = _without(model, _outside(model, _HEAD_ONLY))
    tail_model = _without(model, _HEAD_ONLY)
    halves = [set(m.state_dict()) for m in (head_model, tail_model)]
    if halves[0] & halves[1] or halves[0] | halves[1] != set(
            model.state_dict()):
        raise ValueError("the head's and the tail's weights do not "
                         "partition the model's")
    head = _Head(SplitRCNN(head_model, quant_bits))
    tail = _Tail(SplitRCNN(tail_model, quant_bits), bucket_hw)
    sizes = torch.full((batch, 2), 1, dtype=torch.int32, device=dev)
    with torch.no_grad():
        # one eager run first: it gives the wire's specs, and it makes the
        # model's cached constants (normalization, anchors, pooling
        # matrices: made once per device and bucket) as real tensors, which
        # the traces then capture; made inside a trace they would be fake
        q, scale, zp, _ = split.head_fn(images)
        tail_args = (q, scale, zp, sizes)
        split.tail_fn(*tail_args, bucket_hw)
        head_ep = (torch.export.export(head, (images,), strict=False)
                   if with_head else None)
        tail_ep = torch.export.export(tail, tail_args, strict=False)
    return head_ep, tail_ep


def export_split(model, bucket_hw: Tuple[int, int], batch: int = 1,
                 quant_bits: Optional[int] = 8) -> bytes:
    """Serialize head+tail for one (bucket, batch) configuration, on the
    model's device."""
    dev = next(model.parameters()).device
    head_ep, tail_ep = _export_halves(model, tuple(bucket_hw), batch,
                                      quant_bits)
    return pickle.dumps({
        "format": FORMAT,
        "bucket_hw": tuple(bucket_hw),
        "batch": batch,
        "quant_bits": quant_bits,
        "device": dev.type,
        "fused_stem": use_fused_stem(),
        "head": _save(head_ep),
        "tail": _save(tail_ep),
        "meta": _meta(model),
    })


def _load_program(blob: bytes, device_type: str,
                  device: Optional[torch.device] = None):
    """The callable module of a saved program, on ``device`` (the device it
    was exported on when None)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this split artifact was exported on a CUDA "
                           "device and this machine has none; it does not "
                           "fall back to the CPU")
    ep = torch.export.load(io.BytesIO(blob))
    if device is not None:
        from torch.export.passes import move_to_device_pass
        ep = move_to_device_pass(ep, device)
    return ep.module()


def _payload(blob, fmt: str) -> Dict[str, Any]:
    payload = blob if isinstance(blob, dict) else pickle.loads(blob)
    if payload.get("format") != fmt:
        raise ValueError(f"unknown artifact format {payload.get('format')!r}"
                         f" (expected {fmt!r})")
    return payload


class ExportedSplit:
    """Deserialized split pair — callable without model code."""

    def __init__(self, blob):
        """Accepts the serialized bytes or an already-decoded payload dict
        (load_exported decodes once and passes the dict through)."""
        payload = _payload(blob, FORMAT)
        self.bucket_hw = payload["bucket_hw"]
        self.batch = payload["batch"]
        self.quant_bits = payload["quant_bits"]
        self.device_type = payload["device"]
        self.fused_stem = payload["fused_stem"]
        self.meta = payload["meta"]
        self._head = _load_program(payload["head"], self.device_type)
        self._tail = _load_program(payload["tail"], self.device_type)
        self.device = next(iter(self._tail.state_dict().values())).device

    def head(self, images):
        """images [B, H, W, 3] f32 -> (q, scale, zero_point, ext)."""
        return self._head(torch.as_tensor(images).to(self.device))

    def tail(self, q, scale, zero_point, image_sizes):
        """wire fields -> detection dict in padded-bucket coords."""
        dev = self.device
        return self._tail(
            torch.as_tensor(q).to(dev),
            torch.as_tensor(scale, dtype=torch.float32).to(dev),
            torch.as_tensor(zero_point, dtype=torch.float32).to(dev),
            torch.as_tensor(image_sizes, dtype=torch.int32).to(dev))


def export_split_set(model, buckets, batch: int = 1,
                     quant_bits: Optional[int] = 8) -> bytes:
    """Serialize head+tail programs for a SET of buckets in one artifact;
    the server dispatches on the incoming wire's bucket."""
    entries = {tuple(b): export_split(model, tuple(b), batch, quant_bits)
               for b in buckets}
    return pickle.dumps({"format": FORMAT_SET, "batch": batch,
                         "quant_bits": quant_bits, "buckets": entries})


class ExportedSplitSet:
    """Bucket-dispatching wrapper over a set of exported split pairs."""

    def __init__(self, blob):
        payload = _payload(blob, FORMAT_SET)
        self.batch = payload["batch"]
        self.quant_bits = payload["quant_bits"]
        self._splits: Dict[Tuple[int, int], ExportedSplit] = {
            k: ExportedSplit(v) for k, v in payload["buckets"].items()}
        self.buckets = sorted(self._splits)

    def for_bucket(self, bucket_hw) -> ExportedSplit:
        return self._splits[tuple(int(v) for v in bucket_hw)]

    def head(self, images):
        """Dispatch on the padded image shape."""
        return self.for_bucket(images.shape[1:3]).head(images)

    def tail(self, bucket_hw, q, scale, zero_point, image_sizes):
        return self.for_bucket(bucket_hw).tail(q, scale, zero_point,
                                               image_sizes)


def export_sharded_tail(model, bucket_hw: Tuple[int, int],
                        devices: Sequence, batch_per_shard: int = 1,
                        quant_bits: Optional[int] = 8) -> bytes:
    """The serving TAIL for ``len(devices)`` shards of ``batch_per_shard``
    images, one copy per device (the multi-device serving artifact).  n
    edges each send one wire packet quantized with that edge's own scale;
    the server runs packet k on device k.  The artifact records the number
    of devices; ``ExportedShardedTail.call`` takes them explicitly."""
    bucket_hw = tuple(bucket_hw)
    _, tail_ep = _export_halves(model, bucket_hw, batch_per_shard, quant_bits,
                                with_head=False)
    return pickle.dumps({
        "format": FORMAT_SHARDED,
        "bucket_hw": bucket_hw,
        "n_devices": len(devices),
        "batch_per_shard": batch_per_shard,
        "quant_bits": quant_bits,
        "device": next(model.parameters()).device.type,
        "fused_stem": use_fused_stem(),
        "tail": _save(tail_ep),
        "meta": _meta(model),
    })


class ExportedShardedTail:
    """Deserialized sharded tail — callable without model code on any
    devices of the recorded number and type."""

    def __init__(self, blob):
        payload = _payload(blob, FORMAT_SHARDED)
        self.bucket_hw = payload["bucket_hw"]
        self.n_devices = payload["n_devices"]
        self.batch_per_shard = payload["batch_per_shard"]
        self.quant_bits = payload["quant_bits"]
        self.device_type = payload["device"]
        self.meta = payload["meta"]
        self._blob = payload["tail"]
        self._copies: Dict[torch.device, Any] = {}

    def _copy(self, device: torch.device):
        if device.type != self.device_type:
            raise ValueError(f"artifact was exported on {self.device_type}; "
                             f"got device {device}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if device not in self._copies:
            self._copies[device] = _load_program(self._blob,
                                                 self.device_type, device)
        return self._copies[device]

    def call(self, devices, q, scales, zero_points, image_sizes):
        """Run shard k of the batch on ``devices[k]`` (their number must
        match the exported one; a device may repeat), under that card's
        device guard: each shard's copies and its tail are queued on its
        own card before any shard is read back (host inputs go through
        pinned memory, so no copy waits).

        q: [n*batch_per_shard, H', W', C'] wire tensors (edge order),
        scales/zero_points: [n] per-edge quantization params,
        image_sizes: [n*batch_per_shard, 2].  Returns the detection dict of
        the whole batch on ``devices[0]``.
        """
        devices = [torch.device(d) for d in devices]
        if len(devices) != self.n_devices:
            raise ValueError(
                f"artifact was exported for {self.n_devices} devices; "
                f"got {len(devices)}")
        cuda = devices[0].type == "cuda"

        def staged(t):
            return t.pin_memory() if cuda and t.device.type == "cpu" else t

        q = staged(torch.as_tensor(q))
        scales = staged(torch.as_tensor(scales, dtype=torch.float32))
        zero_points = staged(torch.as_tensor(zero_points,
                                             dtype=torch.float32))
        image_sizes = staged(torch.as_tensor(image_sizes, dtype=torch.int32))
        n = self.batch_per_shard
        outs = []
        # no host sync inside a tail: every shard is queued before any ends
        for k, dev in enumerate(devices):
            rows = slice(k * n, (k + 1) * n)
            program = self._copy(dev)
            with torch.cuda.device(dev) if dev.type == "cuda" \
                    else contextlib.nullcontext():
                outs.append(program(*(
                    t.to(dev, non_blocking=True) for t in (
                        q[rows], scales[k], zero_points[k],
                        image_sizes[rows]))))
        return {key: torch.cat([o[key].to(devices[0]) for o in outs])
                for key in outs[0]}


def load_exported(blob: bytes):
    """Load a single-bucket, bucket-set or sharded-tail artifact; a JAX
    artifact raises ValueError."""
    payload = pickle.loads(blob)
    if not isinstance(payload, dict):
        raise ValueError("not a split artifact: its payload is not a dict")
    fmt = payload.get("format")
    if fmt in JAX_FORMATS:
        raise ValueError(f"{fmt!r} is a JAX package artifact (jax.export "
                         f"StableHLO); the port loads {FORMAT!r}, "
                         f"{FORMAT_SET!r} and {FORMAT_SHARDED!r}")
    if fmt == FORMAT_SET:
        return ExportedSplitSet(payload)
    if fmt == FORMAT_SHARDED:
        return ExportedShardedTail(payload)
    return ExportedSplit(payload)


def main(argv=None):
    """CLI: serialize a trained bottleneck model's split pair.

    python -m hnd_ghnd_tpu_torch.split.export --config config/ghnd/... \\
        --out artifact.hgsplit [--bucket 832,1344] [--batch 1] [--bits 8] \\
        [--device cuda]
    """
    import argparse
    from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util

    p = argparse.ArgumentParser(description="AOT split export")
    p.add_argument("--config", required=True)
    p.add_argument("--json", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--bucket", default="832,1344",
                   help="H,W — or a set 'H1,W1;H2,W2' to bundle one "
                        "program per bucket")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--bits", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="the device the artifact runs on: cuda, cuda:K or "
                        "cpu")
    args = p.parse_args(argv)

    config = overwrite_config(load_config(args.config), args.json)
    model_cfg = config.get("student_model", config.get("model"))
    # get_model loads model_cfg["ckpt"] when it exists
    model = get_model(model_cfg, seed=args.seed,
                      device=args.device).requires_grad_(False)
    if ckpt_util.check_if_exists(model_cfg.get("ckpt")):
        print(f"loaded trained weights from {model_cfg['ckpt']}")
    buckets = [tuple(int(v) for v in part.split(","))
               for part in args.bucket.split(";") if part]
    bits = args.bits if args.bits > 0 else None
    if len(buckets) == 1:
        blob = export_split(model, buckets[0], args.batch, bits)
    else:
        blob = export_split_set(model, buckets, args.batch, bits)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {len(blob) / 1e6:.1f} MB split artifact to {args.out} "
          f"(buckets {buckets}, batch {args.batch}, {args.bits}-bit wire, "
          f"{torch.device(args.device).type})")


if __name__ == "__main__":
    main()
