"""The port's split deployment, wire and bottleneck chains against the JAX
package's, on the CPU.

  * the byte wire: ``pack_wire`` of one ``WirePacket`` gives the same bytes
    in both packages, each package's ``unpack_wire`` reads the other's, and
    every malformed packet of tests/test_split.py (the JPEG wire's too)
    raises the port's ``WireError`` on the same bytes as JAX's;
  * the head against JAX's jitted ``head_fn`` at 96x128, batch 2 with one
    image padded, on the b3ch student's seeded weights with live BNs
    (``live_norms_``) carried to JAX by the JAX package's converter (the
    weights of ``live_models`` without its JAX init, ~16 s of it): scale
    and zero point within 1e-6 relative, codes within one level (the
    share that moves is stated), and the ext filter's output within 1e-5
    on the Keypoint R-CNN of config/ext;
  * head -> bytes -> tail equal to ``RCNN.detect`` with the round trip,
    bit for bit, on the 8-bit wire (batch 2, one image padded) and the
    16-bit and unquantized ones (batch 1), port only
    (tests/test_torch_port_slice.py holds that forward against JAX's);
  * the head and tail entries partition the ``state_dict``, and through
    ``jax_params_from_state_dict`` they are JAX's head and tail trees;
  * the ext filter stops a batch of one at threshold 1.1, sends it at 0.0,
    and never stops a batch of two;
  * ``JpegInputSplit``: the edge's bytes are JAX's, and the server's
    detections are the full forward's without the round trip on the
    decoded pixels;
  * the JPEG chains: the same NHWC tensor gives the same output through
    both packages' chains, and a ``[jpeg_compressor, jpeg_decompressor]``
    config built by the factory JPEG-encodes inside the model, with an
    output that differs from the plain path by less than 0.25 on average
    (tests/test_codec.py's bound for JAX);
  * ``DataLogger``'s sizes and shapes are JAX's, an ext-stopped image too.
"""
import copy
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EXT_MODEL, STUDENT_MODEL, live_norms_
from hnd_ghnd_tpu.codec import quantizer as jax_quantizer
from hnd_ghnd_tpu.codec.datalogger import DataLogger as JaxDataLogger
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.split import deploy as jax_deploy
from hnd_ghnd_tpu_torch.codec import jpeg
from hnd_ghnd_tpu_torch.codec import quantizer as port_quantizer
from hnd_ghnd_tpu_torch.codec.datalogger import DataLogger
from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
from hnd_ghnd_tpu_torch.runners.common import evaluate
from hnd_ghnd_tpu_torch.split import deploy

SHAPE = (96, 128)
LOGIT_SPREAD = 300.0
QUANT_PARAM_TOL = 1e-6
EXT_TOL = 1e-5
JPEG_MEAN_DIFF = 0.25
JPEG_CHAIN = {"order": ["jpeg_compressor", "jpeg_decompressor"],
              "components": {"jpeg_compressor": {"params": {
                                 "jpeg_quality": 95, "tmp_dir_path": "x"}},
                             "jpeg_decompressor": {"params": {}}}}
QUANT_JPEG_CHAIN = {
    "order": ["quantizer", "jpeg_compressor", "jpeg_decompressor",
              "dequantizer"],
    "components": {"quantizer": {"params": {"num_bits": 8}},
                   "jpeg_compressor": {"params": {}},
                   "jpeg_decompressor": {"params": {}},
                   "dequantizer": {"params": {"num_bits": 8}}}}


def _images(seed, b=2, shape=SHAPE):
    """[b, H, W, 3] float32 in [0, 1], every image but the first padded;
    valid and original sizes."""
    rng = np.random.RandomState(seed)
    images = rng.rand(b, *shape, 3).astype(np.float32)
    sizes = np.tile(np.asarray(shape, np.int32), (b, 1))
    for i in range(1, b):
        sizes[i] = (shape[0] - 16 * i, shape[1] - 28 * i)
        images[i, sizes[i, 0]:] = 0.0
        images[i, :, sizes[i, 1]:] = 0.0
    return images, sizes, np.round(sizes * 1.5).astype(np.int32)


def _packet(mod, dtype=np.uint8, ext=True):
    t = (np.arange(2 * 6 * 4 * 3) % 251).astype(dtype).reshape(2, 6, 4, 3)
    return mod.WirePacket(
        t, 0.5, 3.0, np.asarray([[96, 128], [80, 100]], np.int32),
        np.asarray([[48, 64], [40, 50]], np.int32),
        np.asarray([[0.1, 0.9], [0.7, 0.3]], np.float32) if ext else None)


def _both(cfg, seed):
    """``cfg``'s model with seeded weights and live BNs in the port, and
    JAX's with the same weights (the JAX package's converter):
    (JAX model, params, state, port model)."""
    pm = live_norms_(get_model(cfg, seed=seed, device="cpu"), seed)
    pm.requires_grad_(False)
    params, state = convert_state_dict(pm.state_dict())
    return jax_build_model(cfg), params, state, pm


# The tier-1 run shares the machine's cores among its workers; torch's
# default of one thread a core then oversubscribes them.  This file's CPU
# forwards run on two.
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def models():
    """The b3ch student (``_both``), and the port model's copy with the
    class logits spread x300 (real detections through the thresholds and
    NMS)."""
    jm, params, state, pm = _both(dict(STUDENT_MODEL, ckpt=None), 0)
    spread = copy.deepcopy(pm)
    with torch.no_grad():
        spread.roi_heads.box_predictor.cls_score.weight.mul_(LOGIT_SPREAD)
    return jm, params, state, pm, spread


@pytest.fixture(scope="module")
def ext_models():
    """config/ext's Keypoint R-CNN (``_both``)."""
    cfg = copy.deepcopy(EXT_MODEL)
    cfg.pop("ckpt")
    cfg["backbone"]["ext_config"].pop("ckpt")
    return _both(cfg, 3)


# ------------------------------------------------------------------ wire
@pytest.mark.parametrize("dtype,ext", [(np.uint8, True), (np.uint8, False),
                                       (np.float16, True),
                                       (np.float32, False)],
                         ids=["u8", "u8_no_ext", "f16", "f32"])
def test_wire_bytes_equal_jax_both_ways(dtype, ext):
    port = deploy.pack_wire(_packet(deploy, dtype, ext))
    ref = jax_deploy.pack_wire(_packet(jax_deploy, dtype, ext))
    assert port == ref
    for got in (deploy.unpack_wire(ref), jax_deploy.unpack_wire(port)):
        want = _packet(deploy, dtype, ext)
        np.testing.assert_array_equal(got.tensor, want.tensor)
        assert got.tensor.dtype == want.tensor.dtype
        assert (got.scale, got.zero_point) == (want.scale, want.zero_point)
        np.testing.assert_array_equal(got.image_sizes, want.image_sizes)
        np.testing.assert_array_equal(got.original_sizes,
                                      want.original_sizes)
        assert (got.ext_logits is None) == (not ext)
        if ext:
            np.testing.assert_array_equal(got.ext_logits, want.ext_logits)


def _good():
    t = np.arange(2 * 3 * 4 * 3, dtype=np.uint8).reshape(1, 6, 4, 3)
    return deploy.pack_wire(deploy.WirePacket(
        t, 0.5, 3.0, np.asarray([[96, 128]], np.int32),
        np.asarray([[48, 64]], np.int32),
        np.asarray([[0.1, 0.9]], np.float32)))


def _tamper(**kv):
    buf = _good()
    (mlen,) = struct.unpack("<I", buf[4:8])
    meta = json.loads(buf[8:8 + mlen].decode())
    meta.update(kv)
    mb = json.dumps(meta).encode()
    return buf[:4] + struct.pack("<I", len(mb)) + mb + buf[8 + mlen:]


def _non_json():
    mb = b"\xff\xfe not json"
    return b"HGW1" + struct.pack("<I", len(mb)) + mb + b"\x00" * 16


# every malformed packet of tests/test_split.py::TestMalformedWire
MALFORMED = {
    "bad_magic": (lambda: b"XXXX" + _good()[4:], "magic"),
    "truncated_header": (lambda: b"HGW", "truncated"),
    "truncated_metadata": (lambda: _good()[:10], "truncated"),
    "truncated_body": (lambda: _good()[:-5], "body"),
    "oversized_body": (lambda: _good() + b"\x00" * 8, "body"),
    "oversized_meta_length": (lambda: _good()[:4] + struct.pack(
        "<I", 1 << 24) + _good()[8:], "cap|truncated"),
    "non_json_metadata": (_non_json, "JSON"),
    "dtype_object": (lambda: _tamper(dtype="object"), "dtype"),
    "dtype_int64": (lambda: _tamper(dtype="int64"), "dtype"),
    "shape_body_mismatch": (lambda: _tamper(shape=[1, 100, 100, 3]),
                            "body|shape"),
    "negative_shape": (lambda: _tamper(shape=[1, -6, 4, 3]), "shape"),
    "three_entry_shape": (lambda: _tamper(shape=[6, 4, 3]), "shape"),
    "string_shape": (lambda: _tamper(shape="evil"), "shape"),
    "huge_tensor": (lambda: _tamper(shape=[1 << 20, 1 << 12, 1 << 12, 3]),
                    "cap|body"),
    "zero_image_size": (lambda: _tamper(image_sizes=[[0, 128]]),
                        "image_sizes"),
    "image_sizes_batch": (lambda: _tamper(
        image_sizes=[[96, 128], [96, 128]]), "image_sizes"),
    "string_image_sizes": (lambda: _tamper(image_sizes="evil"),
                           "image_sizes"),
    "bad_scale": (lambda: _tamper(scale="evil"), "scale"),
    "bad_ext_logits": (lambda: _tamper(ext=[[1.0, 2.0, 3.0]]), "ext"),
}

_JPEG_META = (b'{"lengths": [999], "image_sizes": [[56, 88]], '
              b'"original_sizes": [[112, 176]]}')
MALFORMED_JPEG = {
    "jpeg_bad_magic": (b"XXXX" + b"\x00" * 16, "magic"),
    "jpeg_truncated": (b"HGJ", "truncated"),
    "jpeg_length": (b"HGJ1" + struct.pack("<I", len(_JPEG_META)) + _JPEG_META
                    + b"\x00" * 8, "length"),
}


def test_good_packet_decodes():
    assert deploy.unpack_wire(_good()).tensor.shape == (1, 6, 4, 3)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_wire_raises_wire_error(case):
    make, match = MALFORMED[case]
    buf = make()
    with pytest.raises(deploy.WireError, match=match):
        deploy.unpack_wire(buf)
    with pytest.raises(jax_deploy.WireError, match=match):
        jax_deploy.unpack_wire(buf)


@pytest.mark.parametrize("case", sorted(MALFORMED_JPEG))
def test_malformed_jpeg_wire_raises_wire_error(case):
    buf, match = MALFORMED_JPEG[case]
    with pytest.raises(deploy.WireError, match=match):
        deploy.JpegInputSplit(None).run_server(None, buf, (64, 96))
    with pytest.raises(jax_deploy.WireError, match=match):
        jax_deploy.JpegInputSplit(None).run_server(None, buf, (64, 96))


# ------------------------------------------------------ head against JAX
def _heads(jm, params, state, pm, images):
    head_jit, _, _ = jax_deploy.SplitRCNN(jm, 8).build(params, state)
    want = [np.asarray(v) for v in head_jit(jnp.asarray(images))]
    got = deploy.SplitRCNN(pm, 8).head_fn(torch.from_numpy(images))
    return [t.numpy() for t in got], want


def _assert_codes_close(got, want):
    (q, scale, zp, ext), (jq, jscale, jzp, jext) = got, want
    assert q.shape == jq.shape and q.dtype == jq.dtype == np.uint8
    np.testing.assert_allclose(scale, jscale, rtol=QUANT_PARAM_TOL)
    np.testing.assert_allclose(zp, jzp, rtol=QUANT_PARAM_TOL)
    moved = np.abs(q.astype(np.int32) - jq.astype(np.int32))
    assert moved.max() <= 1
    share = float((moved > 0).mean())
    print(f"codes differing from JAX's by one level: {share:.3%}")
    # the float noise of two frameworks moves a few codes, not many
    assert share < 0.01
    return ext, jext


def test_head_matches_jax_head(models):
    jm, params, state, pm, _ = models
    images, _, _ = _images(0)
    ext, jext = _assert_codes_close(*_heads(jm, params, state, pm, images))
    assert not ext.any() and not jext.any()  # no filter: zeros


def test_ext_head_matches_jax_head(ext_models):
    jm, params, state, pm = ext_models
    images, _, _ = _images(1)
    ext, jext = _assert_codes_close(*_heads(jm, params, state, pm, images))
    np.testing.assert_allclose(ext, jext, rtol=EXT_TOL, atol=EXT_TOL)
    np.testing.assert_allclose(ext.sum(1), 1.0, rtol=1e-6)


# --------------------------------------------- split against the full model
@pytest.mark.parametrize("bits", [8, 16, None], ids=["8bit", "16bit",
                                                     "no_quant"])
def test_split_equals_full_forward(models, bits):
    pm = models[4]
    images, sizes, orig = _images(2, b=2 if bits == 8 else 1)
    layer1 = pm.backbone.body.layer1
    layer1.quant_bits = bits or 8
    try:
        (rec,) = evaluate(pm, [{"images": images, "image_sizes": sizes,
                                "original_sizes": orig}],
                          use_bottleneck_transformer=bits is not None)
    finally:
        layer1.quant_bits = 8
    split = deploy.SplitRCNN(pm, bits)
    head, tail, _ = split.build()
    wire = split.run_edge(head, images, sizes, orig)
    p = deploy.unpack_wire(wire)
    assert p.tensor.shape == (len(images), SHAPE[0] // 4 + 4,
                              SHAPE[1] // 4 + 4, 3)
    assert p.tensor.dtype == {8: np.uint8, 16: np.float16,
                              None: np.float32}[bits]
    dets = split.run_server(tail, wire, SHAPE)
    assert set(dets) == set(rec["dets"])
    assert rec["dets"]["valid"].sum() > 0
    for k, v in rec["dets"].items():
        assert torch.equal(torch.from_numpy(dets[k]), torch.from_numpy(v)), k


def test_head_tail_partition_is_jax_trees(models):
    pm = models[3]
    sd = pm.state_dict()
    head = deploy._split_head_params(sd)
    tail = deploy._split_tail_params(sd)
    assert not set(head) & set(tail) and set(head) | set(tail) == set(sd)
    assert any(".layer1.encoder." in k for k in head)
    assert any(".layer1.decoder." in k for k in tail)
    params, _ = jax_params_from_state_dict(sd)
    for part, want in ((head, jax_deploy._split_head_params(params)),
                       (tail, jax_deploy._split_tail_params(params))):
        got, _ = jax_params_from_state_dict(part)
        _assert_trees_equal(got, want)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_ext_filter_stops_only_a_batch_of_one(ext_models):
    pm = ext_models[3]
    split = deploy.SplitRCNN(pm, 8)
    head, _, _ = split.build()
    images, sizes, orig = _images(4)
    one = (images[:1], sizes[:1], orig[:1])
    assert split.run_edge(head, *one, ext_threshold=1.1) is None
    wire = split.run_edge(head, *one, ext_threshold=0.0)
    assert deploy.unpack_wire(wire).ext_logits.shape == (1, 2)
    assert split.run_edge(head, images, sizes, orig,
                          ext_threshold=1.1) is not None


# ----------------------------------------------------------- JPEG input
def test_jpeg_input_split_matches_jax_edge_and_full_forward(models):
    pm = models[4]
    rng = np.random.RandomState(0)
    images = rng.rand(1, 64, 96, 3).astype(np.float32)
    sizes = np.asarray([[56, 88]], np.int32)
    orig = np.asarray([[112, 176]], np.int32)
    split = deploy.JpegInputSplit(pm, quality=95)
    wire = split.run_edge(images, sizes, orig)
    assert wire == jax_deploy.JpegInputSplit(None, 95).run_edge(
        images, sizes, orig)
    assert len(wire) < 56 * 88 * 3 * 4
    dets = split.run_server(split.build_server(), wire, (64, 96))
    # the server's input, decoded on the host
    import io

    from PIL import Image
    (mlen,) = struct.unpack("<I", wire[4:8])
    u8 = np.asarray(Image.open(io.BytesIO(wire[8 + mlen:])).convert("RGB"))
    direct = np.zeros((1, 64, 96, 3), np.float32)
    direct[0, :56, :88] = u8.astype(np.float32) / 255.0
    (rec,) = evaluate(pm, [{"images": direct, "image_sizes": sizes,
                            "original_sizes": orig}])
    assert set(dets) == set(rec["dets"])
    for k, v in rec["dets"].items():
        np.testing.assert_array_equal(dets[k], v, err_msg=k)


# ---------------------------------------------------------- JPEG chains
@pytest.mark.parametrize("cfg", [JPEG_CHAIN, QUANT_JPEG_CHAIN],
                         ids=["jpeg", "quantizer_jpeg"])
def test_host_chain_equals_jax_chain(cfg):
    z = np.random.RandomState(5).randn(24, 36, 3).astype(np.float32) * 2
    port = port_quantizer.get_bottleneck_transformer(cfg)
    ref = jax_quantizer.get_bottleneck_transformer(cfg)
    assert port.host_side and ref.host_side
    got, _ = port(z)
    want, _ = ref(z)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_factory_jpeg_chain_encodes_inside_the_model(monkeypatch):
    cfg = copy.deepcopy(STUDENT_MODEL)
    cfg["bottleneck_transformer"] = JPEG_CHAIN
    model = get_model(dict(cfg, ckpt=None), seed=0, device="cpu")
    layer1 = model.backbone.body.layer1
    assert layer1.host_transformer is not None
    assert layer1.host_transformer.host_side
    encoded = []
    call = jpeg.JpegCompressor.__call__

    def spy(self, z, target=None):
        out = call(self, z, target)
        encoded.append(out[0])
        return out

    monkeypatch.setattr(jpeg.JpegCompressor, "__call__", spy)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 8, 10)
                         .astype(np.float32))
    with torch.no_grad():
        y_jpeg, _ = layer1(x, use_bottleneck_transformer=True)
        y_plain, _ = layer1(x, use_bottleneck_transformer=False)
    # one JPEG a [H, W, 3] image: an NCHW image would pass through untouched
    assert len(encoded) == 2
    for payload, scale, zp in encoded:
        assert payload[:2] == b"\xff\xd8" and scale > 0  # a JPEG stream
    assert torch.isfinite(y_jpeg).all()
    diff = (y_jpeg - y_plain).abs()
    assert diff.max() > 0
    assert diff.mean() < JPEG_MEAN_DIFF


def test_quantizer_chain_keeps_the_kernel_round_trip():
    model = build_model(STUDENT_MODEL)
    layer1 = model.backbone.body.layer1
    assert layer1.host_transformer is None and layer1.quant_bits == 8
    chain = port_quantizer.get_bottleneck_transformer(
        STUDENT_MODEL["bottleneck_transformer"])
    assert not chain.host_side
    z = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 7, 9)
                         .astype(np.float32))
    got, _ = chain(z)
    assert torch.equal(got, port_quantizer.roundtrip(z, 8))


# ------------------------------------------------------------ DataLogger
def test_datalogger_matches_jax():
    z = np.random.RandomState(0).randn(1, 10, 12, 3).astype(np.float32)
    port, ref = DataLogger(8), JaxDataLogger(8)
    for logger in (port, ref):
        logger(z)
        logger(None)  # an image the ext filter stopped
    assert port.get_data() == ref.get_data()
    fp32, fp16, q8, shapes = port.get_data()
    assert fp32[0] > fp16[0] > q8[0] > 0 and fp32[1] == 0.0
    assert shapes == [(3, 10, 12), (0, 0, 0)]
    port.clear()
    assert port.get_data() == ([], [], [], [])
