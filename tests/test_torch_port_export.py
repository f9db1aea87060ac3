"""The port's ahead-of-time split export (split/export.py) on the CPU.

The b3ch student (chip_smoke.STUDENT_MODEL) at full width from a seed, with
live BNs and its class logits spread x300 (real detections through the
thresholds and NMS), at 96x128, batch 2 with the second image padded:

  * ``export_split`` -> bytes -> ``load_exported``: the loaded head gives
    the codes, scale, zero point and ext output of ``SplitRCNN.head_fn``
    bit for bit, and the loaded tail every detection key of ``tail_fn`` on
    the same wire, bit for bit (tests/test_torch_port_split.py and
    tests/test_torch_port_slice.py hold that eager split against JAX's);
    the artifact's programs call the port's custom ops, and its envelope
    names the device and the stem switch;
  * the sharded-tail format for two CPU shards of two images, its
    envelope around that artifact's tail program (the same program
    ``export_sharded_tail`` traces at that batch), each packet quantized
    by its own head (other scales): each shard equals the eager tail on
    its own packet, and one device raises as JAX's does;
  * ``load_exported`` dispatches the single, the bucket-set and the sharded
    formats, and refuses the JAX package's format strings.

The export runs in a spawned process on two torch threads
(tests/test_torch_port_multiprocess.py's ``Ranks``), leaving this
process's threads alone.  The two-bucket set and ``export_sharded_tail``'s
own trace (shards of one image) are a slow test (the JAX package's
precedent, tests/test_export.py); chip_smoke.py exports and checks both on
the card.
"""
import pickle

import numpy as np
import pytest

from tests.test_torch_port_multiprocess import Ranks

SHAPE = (96, 128)
LOGIT_SPREAD = 300.0
TASK_TIMEOUT_S = 300.0


def _images(seed, b=2, shape=SHAPE):
    """[b, H, W, 3] float32 in [0, 1], every image but the first padded;
    their valid sizes."""
    rng = np.random.RandomState(seed)
    images = rng.rand(b, *shape, 3).astype(np.float32)
    sizes = np.tile(np.asarray(shape, np.int32), (b, 1))
    for i in range(1, b):
        sizes[i] = (shape[0] - 16 * i, shape[1] - 28 * i)
        images[i, sizes[i, 0]:] = 0.0
        images[i, :, sizes[i, 1]:] = 0.0
    return images, sizes


def _model():
    import torch
    from chip_smoke import STUDENT_MODEL, live_norms_
    from hnd_ghnd_tpu_torch.models.factory import get_model
    model = live_norms_(get_model(dict(STUDENT_MODEL, ckpt=None), seed=0,
                                  device="cpu"), 0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(LOGIT_SPREAD)
    return model.requires_grad_(False)


def _equal(a, b) -> bool:
    import torch
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _sharded_checks(split, art, images, sizes, whole=None) -> dict:
    """Two edges' packets through the sharded artifact ``art`` of two
    devices, against the eager tail on each packet (``whole``, where given,
    is the eager tail on the first edge's, all of ``images``); one device
    refused.  The first edge sends the first images of ``images``, the
    second as many other images."""
    import torch
    n = art.batch_per_shard
    images = torch.cat([images[:n], torch.from_numpy(_images(10, b=n)[0])])
    sizes = torch.cat([sizes[:n]] * 2)
    packets = [split.head_fn(images[i * n:(i + 1) * n]) for i in range(2)]
    out = {"sharded_type": type(art).__name__,
           "scales": [float(p[1]) for p in packets]}
    q = torch.cat([p[0] for p in packets])
    scales = torch.stack([p[1] for p in packets])
    zero_points = torch.stack([p[2] for p in packets])
    both = art.call(["cpu", "cpu"], q, scales, zero_points, sizes)
    out["shards"] = []
    for i, p in enumerate(packets):
        rows = slice(i * n, (i + 1) * n)
        ref = (whole if i == 0 and whole is not None
               else split.tail_fn(*p[:3], sizes[rows], SHAPE))
        out["shards"].append({k: _equal(both[k][rows], ref[k]) for k in ref})
    try:
        art.call(["cpu"], q, scales, zero_points, sizes)
        out["one_device"] = "no error"
    except ValueError as e:
        out["one_device"] = str(e)
    return out


def task_export(slow: bool = False):
    """Export and load the split on the CPU; every comparison with the
    eager ``SplitRCNN`` of the same model, and the artifacts' facts."""
    import torch
    from hnd_ghnd_tpu_torch.split import deploy, export

    model = _model()
    split = deploy.SplitRCNN(model, 8)
    images, sizes = _images(0)
    images, sizes = torch.from_numpy(images), torch.from_numpy(sizes)
    out = {}
    if slow:
        out.update(_sharded_checks(split, export.load_exported(
            export.export_sharded_tail(model, SHAPE, ["cpu", "cpu"],
                                       batch_per_shard=1)),
            images, sizes))
        portrait = _images(1, shape=SHAPE[::-1])
        blob = export.export_split_set(model, [SHAPE, SHAPE[::-1]], batch=2)
        art = export.load_exported(blob)
        out["set_buckets"] = art.buckets
        for im, sz in ((images, sizes),
                       tuple(torch.from_numpy(a) for a in portrait)):
            bucket = tuple(im.shape[1:3])
            got = art.head(im)
            want = split.head_fn(im)
            out[f"head {bucket}"] = [_equal(g, w) for g, w in zip(got, want)]
            dets = art.tail(bucket, *got[:3], sz)
            ref = split.tail_fn(*want[:3], sz, bucket)
            out[f"tail {bucket}"] = {k: _equal(dets[k], ref[k]) for k in ref}
        return out

    blob = export.export_split(model, SHAPE, batch=2)
    payload = pickle.loads(blob)
    out["envelope"] = {k: v for k, v in payload.items()
                       if k not in ("head", "tail")}
    out["head_bytes"], out["tail_bytes"] = (len(payload[k])
                                            for k in ("head", "tail"))
    art = export.load_exported(blob)
    out["type"] = type(art).__name__
    targets = {str(n.target) for prog in (art._head, art._tail)
               for n in prog.graph.nodes if n.op == "call_function"}
    out["ops"] = sorted(t for t in targets if t.startswith("hnd_ghnd."))
    got = art.head(images)
    want = split.head_fn(images)
    out["head"] = [_equal(g, w) for g, w in zip(got, want)]
    dets = art.tail(*got[:3], sizes)
    whole = split.tail_fn(*want[:3], sizes, SHAPE)
    out["tail"] = {k: _equal(dets[k], whole[k]) for k in whole}
    out["detections"] = int(whole["valid"].sum())

    # two edges, two images each, each packet with its own scale, through
    # the artifact's own tail program in the sharded format (the traced
    # sharded tail is the slow test)
    sharded = dict(payload, format=export.FORMAT_SHARDED, n_devices=2,
                   batch_per_shard=2)
    for key in ("head", "batch"):
        del sharded[key]
    out.update(_sharded_checks(split, export.load_exported(
        pickle.dumps(sharded)), images, sizes, whole))

    # the bucket-set format, dispatched on the wire's bucket: one bucket
    # of the artifact above (the two-bucket export is the slow test)
    one_bucket = pickle.dumps({"format": export.FORMAT_SET, "batch": 2,
                               "quant_bits": 8, "buckets": {SHAPE: blob}})
    art_set = export.load_exported(one_bucket)
    out["set_type"] = type(art_set).__name__
    got = art_set.head(images)
    out["set_head"] = [_equal(g, w) for g, w in zip(got, want)]
    dets = art_set.tail(SHAPE, *got[:3], sizes)
    out["set_tail"] = {k: _equal(dets[k], whole[k]) for k in whole}
    refused = []
    for fmt in export.JAX_FORMATS:
        try:
            export.load_exported(pickle.dumps({"format": fmt}))
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["jax_formats"] = refused
    return out


@pytest.fixture(scope="module")
def exported():
    pool = Ranks(world=1, module=__name__, init_group=False)
    try:
        (result,) = pool.run("task_export", timeout=TASK_TIMEOUT_S)
    finally:
        pool.close()
    return result


def test_head_and_tail_equal_the_eager_split(exported):
    assert exported["type"] == "ExportedSplit"
    assert exported["head"] == [True] * 4
    assert exported["tail"] == {k: True for k in
                                ("boxes", "scores", "labels", "valid")}
    assert exported["detections"] > 0


def test_artifact_calls_the_ops_and_names_its_device(exported):
    env = exported["envelope"]
    assert env["format"] == "hnd-ghnd-split-torch-v1"
    assert env["bucket_hw"] == SHAPE and env["batch"] == 2
    assert env["quant_bits"] == 8 and env["device"] == "cpu"
    assert env["fused_stem"] is False
    assert env["meta"] == {"kind": "faster_rcnn", "num_classes": 91,
                           "bottleneck_channel": 3}
    # the stem switch is off: no stem_fwd; no int8 tables
    assert exported["ops"] == ["hnd_ghnd.dequantize.default",
                               "hnd_ghnd.nms_keep.default",
                               "hnd_ghnd.nms_keep_levels.default",
                               "hnd_ghnd.quantize.default",
                               "hnd_ghnd.roi_align.default"]
    # each half holds its own weights: the head's stem and encoder are a
    # small part of the tail's trunk and heads
    assert exported["head_bytes"] * 50 < exported["tail_bytes"]


def _check_sharded(out):
    assert out["sharded_type"] == "ExportedShardedTail"
    assert out["scales"][0] != out["scales"][1]
    for shard in out["shards"]:
        assert shard == {k: True for k in
                         ("boxes", "scores", "labels", "valid")}
    assert "exported for 2 devices" in out["one_device"]


def test_sharded_tail_equals_the_single_tail_per_shard(exported):
    _check_sharded(exported)


def test_load_exported_dispatches_formats_and_refuses_jax(exported):
    assert exported["set_type"] == "ExportedSplitSet"
    assert exported["set_head"] == [True] * 4
    assert all(exported["set_tail"].values())
    for fmt, msg in zip(("hnd-ghnd-split-v1", "hnd-ghnd-splitset-v2",
                         "hnd-ghnd-sharded-tail-v1"),
                        exported["jax_formats"]):
        assert msg is not None and fmt in msg and "JAX" in msg


@pytest.mark.slow
def test_two_bucket_set_and_the_traced_sharded_tail():
    pool = Ranks(world=1, module=__name__, init_group=False)
    try:
        (out,) = pool.run("task_export", timeout=TASK_TIMEOUT_S, slow=True)
    finally:
        pool.close()
    _check_sharded(out)
    assert out["set_buckets"] == sorted([SHAPE, SHAPE[::-1]])
    for bucket in (SHAPE, SHAPE[::-1]):
        assert out[f"head {bucket}"] == [True] * 4
        assert all(out[f"tail {bucket}"].values())
