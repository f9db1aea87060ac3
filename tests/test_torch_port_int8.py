"""The port's int8 server tail (split/int8.py) and its int8 convolution
(ops/int8_conv.py) against the JAX package's, on the CPU.

The b3ch student is seeded with live BNs (``live_norms_``) and carried to
JAX by the JAX package's converter; the wire is the port's head on a
64x64 image (tests/test_int8.py's size), dequantized, and both packages
read the same numpy tensor.

  * ``fold_tail``'s weights and biases equal JAX's within rtol 1e-6 (the
    biases also within 1e-6 of their largest magnitude: a bias near zero
    is a difference of two rounded products);
  * ``quantize_folded``: ``sw`` within rtol 1e-6, ``qw`` equal but for
    one level at rounding boundaries, the share that moves at most 1e-6
    (3e-7 measured: 7 of 23.6 M weights);
  * ``int8_conv_plain`` equals JAX's int32 ``conv_general_dilated`` bit
    for bit at (pad, stride, groups) (0, 1, 1), (1, 1, 1), (1, 2, 1),
    (1, 2, 2), on a k2 decoder shape and on sums past 2^24, where a float32
    sum would round;
  * the zero-point conv equals the float conv of the dequantized tensors
    within JAX's TestZeroPointExactness bound (rtol 2e-4, atol 2e-3);
  * ``trunk_features_fp`` equals the model's own decode + layers 2-4
    within rtol 1e-5 and 1e-5 of each stage's largest magnitude (only the
    rounding of the folded products differs);
  * ``calibrate_tail``: JAX's 44 site names, scales within rtol 1e-5;
  * every site's codes equal JAX's eager ``_QuantKit`` walk's on the same
    wire with the same quantized weights and scales (0 of 504,291 codes
    move; the bound is one level on at most 1e-3 of them).  The walk is
    handed JAX's quantized weights because the fold's one-ulp differences
    (above) flip a few codes at rounding boundaries from ``s0b3c1`` on,
    and the random-weight trunk amplifies them: with the port's own fold
    6.2% of the codes differ by the last site (up to 4 levels);
  * the int8 walk tracks the float walk: cosine > 0.95 at every stage
    output (tests/test_int8.py's criterion);
  * the int8 tail of the Faster, Mask and Keypoint R-CNN students gives the
    float tail's keys and shapes, finite;
  * ``int8_conv_requant_plain`` (the fused convolution's plain version) in
    each mode equals ``int8_conv_plain`` followed by the walk's float32 ops
    as eager torch ops (the int8 tail's sequence before the epilogue moved
    into the kernel), bit for bit, with NaN, +-inf and half-way quotients,
    and the border map of a padded conv; ``template_for`` sends 45 of the
    trunk's 46 convolutions to the wgmma main loop;
  * the kernel's branch-free site quotient (csrc/int8_conv.cu
    ``quotient<true>``: RN(y RN(1/s)) and two fused corrections), emulated
    with exact rational rounding, equals the IEEE quotient RN(y / s) on
    quotients at and beside half-way points, where a one-ulp error would
    move a code.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (BUCKETS, EVAL_BATCH, INT8_CONV_ODD,
                        INT8_EPILOGUE_CASES, KEYPOINT_STUDENT_MODEL,
                        MASK_STUDENT_MODEL, STUDENT_MODEL, int8_epilogue,
                        int8_outputs_equal, int8_trunk_convs, live_norms_)
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.split import int8 as jq
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.ops import int8_conv as IC
from hnd_ghnd_tpu_torch.ops import quant_kernels
from hnd_ghnd_tpu_torch.split import deploy
from hnd_ghnd_tpu_torch.split import int8 as pq
from tests.test_torch_port_multiprocess import omp_threads

SHAPE = (64, 64)
FOLD_TOL = 1e-6
SCALE_TOL = 1e-5
QW_SHARE_MAX = 1e-6
FEAT_TOL = 1e-5
CODE_SHARE_MAX = 1e-3
COS_MIN = 0.95
# JAX's TestZeroPointExactness bound
ZP_RTOL, ZP_ATOL = 2e-4, 2e-3
CPU = torch.device("cpu")

# The tier-1 run shares the machine's cores among its workers; torch's
# default of one thread a core then oversubscribes them.  This file's CPU
# forwards run on two OpenMP threads (``omp_threads``: not through
# torch.set_num_threads, which would change MKL's sums for every later test
# of the worker, ROADMAP C14).
@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with omp_threads():
        yield


@pytest.fixture(scope="module")
def weights():
    """(port model, JAX model, params, state) with the same weights."""
    pm = live_norms_(get_model(STUDENT_MODEL, seed=0, device="cpu"), 0)
    pm = pm.eval().requires_grad_(False)
    params, state = convert_state_dict(pm.state_dict())
    return pm, jax_build_model(STUDENT_MODEL), params, state


def _images(seed):
    return np.random.RandomState(seed).rand(1, *SHAPE, 3).astype(np.float32)


@pytest.fixture(scope="module")
def wire_z(weights):
    """The dequantized 8-bit wire of the port's head, NHWC numpy."""
    q, scale, zp, _ = deploy.SplitRCNN(weights[0], 8).head_fn(
        torch.from_numpy(_images(1)))
    return quant_kernels.dequantize(
        deploy.QuantizedTensor(q, scale, zp)).numpy()


def _quantized_by_k(folded):
    """JAX's eager ``quantize_folded`` (as JAX's Int8SplitTail calls it)
    over the fold, with the convs of one K (= kh kw C) stacked along their
    output channels into one: the quantization is per output channel, so
    each channel's codes and scale are those of its own conv, and the
    eager ops compile 11 shapes instead of 22.  Returns a copy of the fold
    with ``qw`` and ``sw`` on every conv."""
    out = {"dec_in": folded["dec_in"],
           "dec": [dict(fw) for fw in folded["dec"]],
           "stages": [[{k: dict(v) for k, v in blk.items()} for blk in blocks]
                      for blocks in folded["stages"]]}
    convs = _convs(out)
    by_k = {}
    for i, fw in enumerate(convs):
        kh, kw, c, _ = fw["w"].shape
        by_k.setdefault(kh * kw * c, []).append(i)
    for k, idx in by_k.items():
        w = np.concatenate([np.asarray(convs[i]["w"]).reshape(1, 1, k, -1)
                            for i in idx], axis=-1)
        (q,) = jq.quantize_folded({"dec_in": None, "stages": [],
                                   "dec": [{"w": jnp.asarray(w)}]})["dec"]
        qw, sw = np.asarray(q["qw"]), np.asarray(q["sw"])
        start = 0
        for i in idx:
            shape = convs[i]["w"].shape
            stop = start + shape[-1]
            convs[i]["qw"] = qw[..., start:stop].reshape(shape)
            convs[i]["sw"] = sw[start:stop]
            start = stop
    return out


@pytest.fixture(scope="module")
def jax_folded(weights):
    """JAX's fold, and a copy with its quantized weights."""
    _, jm, params, state = weights
    folded = jq.fold_tail(jm, params, state)
    return folded, _quantized_by_k(folded)


@pytest.fixture(scope="module")
def jax_scales(weights, wire_z):
    _, jm, params, state = weights
    return jq.calibrate_tail(jm, params, state, [wire_z])


def _convs(folded):
    out = list(folded["dec"])
    for blocks in folded["stages"]:
        for blk in blocks:
            out += [blk[k] for k in ("conv1", "conv2", "conv3", "downsample")
                    if k in blk]
    return out


def _ohwi(w):
    """JAX's HWIO weights as the port's [C_out, kh, kw, C / groups]."""
    return np.asarray(w).transpose(3, 0, 1, 2)


def _port_from_jax(qfolded):
    """JAX's quantized fold in the port's layout, on the CPU."""
    def conv(fw):
        return {"qw": torch.from_numpy(_ohwi(fw["qw"]).copy()),
                "sw": torch.from_numpy(np.array(fw["sw"])),
                "b": torch.from_numpy(np.array(fw["b"])),
                "relu": fw["relu"], "groups": fw.get("groups", 1)}
    out = {"dec_in": tuple(torch.from_numpy(np.array(t))
                           for t in qfolded["dec_in"]),
           "dec": [conv(fw) for fw in qfolded["dec"]],
           "stages": [[{k: conv(v) for k, v in blk.items()}
                       for blk in blocks] for blocks in qfolded["stages"]]}
    return pq._to_device(out, CPU)


def test_site_codes_are_int8_with_their_zero_points():
    kit = pq._QuantKit(pq._site_scales({"x": 0.1}, CPU))
    q, s, zp = kit.site("x", torch.tensor([[0.35, -0.2]]))
    assert q.dtype == torch.int8 and zp == 0
    assert q.tolist() == [[4, -2]]
    # post-ReLU sites use [0, 255] with zero point -128: 0.1 / su = 2.008
    qu, su, zpu = kit.site("x", torch.tensor([[0.0, 0.1]]), unsigned=True)
    assert qu.dtype == torch.int8 and zpu == 128
    assert qu.tolist() == [[-128, -126]]
    assert float(su) == float(np.float32(0.1) * np.float32(127.0 / 255.0))


def test_fold_tail_equals_jax(weights, jax_folded):
    got = pq.fold_tail(weights[0])
    want = jax_folded[0]
    for a, b in zip(got["dec_in"], want["dec_in"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FOLD_TOL)
    got_c, want_c = _convs(got), _convs(want)
    assert len(got_c) == len(want_c) == 46
    for g, w in zip(got_c, want_c):
        np.testing.assert_allclose(g["w"].numpy(), _ohwi(w["w"]),
                                   rtol=FOLD_TOL)
        b = np.asarray(w["b"])
        np.testing.assert_allclose(g["b"].numpy(), b, rtol=FOLD_TOL,
                                   atol=FOLD_TOL * np.abs(b).max())
        assert (g["relu"], g["groups"]) == (w["relu"], w.get("groups", 1))


def test_quantize_folded_equals_jax(weights, jax_folded):
    got = _convs(pq.quantize_folded(pq.fold_tail(weights[0])))
    want = _convs(jax_folded[1])
    moved = total = 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["sw"].numpy(), np.asarray(w["sw"]),
                                   rtol=FOLD_TOL)
        assert g["qw"].dtype == torch.int8
        d = g["qw"].numpy().astype(np.int32) - _ohwi(w["qw"]).astype(np.int32)
        assert np.abs(d).max() <= 1
        moved += int((d != 0).sum())
        total += d.size
    assert moved / total <= QW_SHARE_MAX, (moved, total)


def _lax_int32(q, w_ohwi, stride, pad, groups):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(q), jnp.asarray(w_ohwi.transpose(1, 2, 3, 0)),
        window_strides=(stride, stride), padding=((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))


@pytest.mark.parametrize("shape,cout,k,stride,pad,groups,lo", [
    ((2, 9, 9, 8), 12, 3, 1, 0, 1, -128),
    ((2, 9, 9, 8), 12, 3, 1, 1, 1, -128),
    ((2, 9, 9, 8), 12, 3, 2, 1, 1, -128),
    ((2, 9, 9, 8), 12, 3, 2, 1, 2, -128),
    ((2, 13, 11, 3), 64, 2, 1, 0, 1, -128),   # the decoder's first conv
    ((1, 6, 7, 512), 16, 3, 1, 1, 1, 100),    # sums past 2^24
], ids=["p0s1g1", "p1s1g1", "p1s2g1", "p1s2g2", "dec0_k2", "past_2_24"])
def test_int8_conv_plain_equals_lax_int32(shape, cout, k, stride, pad, groups,
                                          lo):
    rng = np.random.RandomState(sum(shape) + cout)
    q = rng.randint(-128, 128, shape).astype(np.int8)
    w = rng.randint(-127, 128, (cout, k, k, shape[3] // groups)).astype(
        np.int8)
    if lo > 0:  # same-signed extremes: every sum far past 2^24
        q = -rng.randint(lo, 129, shape).astype(np.int8)
        w = -rng.randint(lo, 128, w.shape).astype(np.int8)
    got = IC.int8_conv_plain(torch.from_numpy(q), torch.from_numpy(w), stride,
                             pad, groups)
    want = _lax_int32(q, w, stride, pad, groups)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if lo > 0:
        assert want.min() > 2 ** 24
        # a float32 sum would have rounded these
        assert (want.astype(np.float32).astype(np.int64) != want).any()


def test_int8_conv_on_the_cpu_is_the_plain_version():
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randint(-128, 128, (1, 5, 6, 16)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (8, 3, 3, 16)).astype(np.int8))
    n = IC.int8_conv.launches
    assert torch.equal(IC.int8_conv(q, w, 1, 1),
                       IC.int8_conv_plain(q, w, 1, 1))
    assert IC.int8_conv.launches == n


@pytest.mark.parametrize("pad,stride,groups", [(0, 1, 1), (1, 1, 1),
                                               (1, 2, 1), (1, 2, 2)])
def test_zero_point_conv_equals_dequantized_conv(pad, stride, groups):
    """The zero-point conv, with the border map of a padded conv, is the
    float conv of the dequantized codes and weights (tests/test_int8.py's
    TestZeroPointExactness)."""
    rng = np.random.RandomState(0)
    cin, cout, k = 8, 12, 3
    w = torch.from_numpy(rng.randn(cout, k, k, cin // groups)
                         .astype(np.float32))
    b = torch.from_numpy(rng.randn(cout).astype(np.float32))
    qf = pq._to_device(pq.quantize_folded({"dec_in": None, "stages": [],
                                           "dec": [{"w": w, "b": b,
                                                    "relu": True,
                                                    "groups": groups}]}),
                       CPU)
    fw = qf["dec"][0]
    x = torch.from_numpy(np.abs(rng.randn(2, 9, 9, cin)).astype(np.float32))
    kit = pq._QuantKit(pq._site_scales({"in": float(x.abs().max()) / 127.0},
                                       CPU))
    xq = kit.site("in", x, unsigned=True)
    got = kit._acc(xq, fw, stride, pad)
    q, s, zp = xq
    x_deq = (q.float() + zp) * s
    w_deq = fw["qw"].float() * fw["sw"][:, None, None, None]
    want = F.conv2d(x_deq.permute(0, 3, 1, 2), w_deq.permute(0, 3, 1, 2),
                    stride=stride, padding=pad, groups=groups)
    want = want.permute(0, 2, 3, 1) + fw["b"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=ZP_RTOL,
                               atol=ZP_ATOL)


def test_trunk_features_fp_equals_model_tail(weights):
    pm = weights[0]
    z = np.random.RandomState(0).rand(1, 17, 17, 3).astype(np.float32) * 4 - 2
    feats = pq.trunk_features_fp(pm, z)
    body = pm.backbone.body
    with torch.no_grad():
        y = body.layer1.decode(torch.from_numpy(z).permute(0, 3, 1, 2)
                               .contiguous())
        ref = [y]
        for stage in (2, 3, 4):
            y = getattr(body, f"layer{stage}")(y)
            ref.append(y)
    assert len(feats) == 4
    for got, want in zip(feats, ref):
        want = want.permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got.numpy(), want, rtol=FEAT_TOL,
                                   atol=FEAT_TOL * np.abs(want).max())


def test_calibrate_tail_equals_jax(weights, wire_z, jax_scales):
    got = pq.calibrate_tail(weights[0], [wire_z])
    assert len(got) == 44 and sorted(got) == sorted(jax_scales)
    for name, s in jax_scales.items():
        assert got[name] == pytest.approx(s, rel=SCALE_TOL), name


def test_site_codes_equal_jax_eager_walk(weights, wire_z, jax_folded,
                                         jax_scales):
    jm = weights[1]

    class Recording(jq._QuantKit):
        def __init__(self, scales):
            super().__init__(scales)
            self.codes = {}

        def site(self, name, x_fp, unsigned=False):
            out = super().site(name, x_fp, unsigned)
            self.codes[name] = np.asarray(out[0])
            return out

    kit = Recording(jax_scales)
    want_feats = jq._trunk_walk(kit, jnp.asarray(wire_z), jax_folded[1],
                                jm.body.counts)
    sites = {}
    with torch.no_grad():
        feats = pq._trunk_walk(
            pq._QuantKit(pq._site_scales(jax_scales, CPU), sites),
            torch.from_numpy(wire_z), _port_from_jax(jax_folded[1]))
    assert list(sites) == list(kit.codes) and len(sites) == 44
    moved = total = 0
    for name, want in kit.codes.items():
        d = sites[name].numpy().astype(np.int32) - want.astype(np.int32)
        assert np.abs(d).max() <= 1, name
        moved += int((d != 0).sum())
        total += d.size
    assert moved / total <= CODE_SHARE_MAX, (moved, total)
    for got, want in zip(feats, want_feats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FEAT_TOL)


def test_int8_features_track_fp(weights, wire_z):
    pm = weights[0]
    scales = pq.calibrate_tail(pm, [wire_z])
    fp = pq.trunk_features_fp(pm, wire_z)
    q8 = pq.trunk_features_int8(pm, wire_z, scales)
    for a, b in zip(fp, q8):
        a = a.double().flatten()
        b = b.double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos > COS_MIN, cos


@pytest.mark.parametrize("kind", ["faster_rcnn", "mask_rcnn",
                                  "keypoint_rcnn"])
def test_int8_tail_gives_the_float_tails_outputs(weights, kind):
    if kind == "faster_rcnn":
        model = weights[0]
    else:
        cfg = {"mask_rcnn": MASK_STUDENT_MODEL,
               "keypoint_rcnn": KEYPOINT_STUDENT_MODEL}[kind]
        model = live_norms_(get_model(cfg, seed=1, device="cpu"), 1)
        model = model.eval().requires_grad_(False)
    images = _images(2)
    scales = pq.calibrate_from_images(model, [images])
    split = deploy.SplitRCNN(model, 8)
    head, fp_tail, _ = split.build()
    q, s, zp, _ = head(images)
    sizes = np.asarray([SHAPE], np.int32)
    d_fp = fp_tail(q, s, zp, sizes, SHAPE)
    d_q8 = pq.Int8SplitTail(model, scales).build()(q, s, zp, sizes, SHAPE)
    assert set(d_fp) == set(d_q8)
    for k, v in d_fp.items():
        assert d_q8[k].shape == v.shape, k
        if d_q8[k].dtype.kind == "f":
            assert np.isfinite(d_q8[k]).all(), k
    head_key = {"mask_rcnn": "mask_probs",
                "keypoint_rcnn": "keypoint_logits"}.get(kind)
    assert head_key is None or head_key in d_q8


def _torch_sequence(q, qw, stride, pad, groups, mode, scale, bias, zp=None,
                    site_scale=None, relu=False, unsigned=False,
                    identity=None, features=False):
    """The int32 sums, then the float32 epilogue as the int8 walk ran it op
    by op in torch: zero point share, scale, bias, the residual's identity,
    ReLU, divide, round, clamp, nan_to_num, cast; the features as the
    dequantized codes copied to NCHW."""
    acc = IC.int8_conv_plain(q, qw, stride, pad, groups).float()
    if zp is not None:
        acc = acc + zp
    y = acc * scale + bias
    if mode == "float":
        return y
    if mode == "residual":
        if torch.is_tensor(identity):
            id_fp = identity
        else:
            codes, s_id, zp_id = identity
            id_fp = (codes.float() + zp_id) * s_id
        y = torch.relu(y + id_fp)
        unsigned = True
    elif relu:
        y = torch.relu(y)
    if unsigned:
        c = torch.clamp(torch.round(y / site_scale), 0, 255) - 128
    else:
        c = torch.clamp(torch.round(y / site_scale), -127, 127)
    c = torch.nan_to_num(c, nan=0.0).to(torch.int8)
    if not features:
        return c
    f = (c.float() + (128 if unsigned else 0)) * site_scale
    return c, f.permute(0, 3, 1, 2).contiguous()


@pytest.mark.parametrize("epilogue", INT8_EPILOGUE_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("shape,cout,k,stride,pad,groups", [
    ((2, 7, 9, 16), 16, 1, 1, 0, 1),    # a 1x1 conv: constant zero point
    ((2, 9, 8, 16), 16, 3, 2, 1, 1),    # strided, padded: the border map
    ((1, 6, 7, 32), 16, 3, 1, 1, 2),    # grouped, padded
], ids=["k1", "k3s2p1", "k3p1g2"])
def test_int8_conv_requant_plain_equals_torch_sequence(shape, cout, k, stride,
                                                       pad, groups, epilogue):
    _, mode, relu, zp_in, identity, features = epilogue
    gen = torch.Generator().manual_seed(sum(shape) + cout)
    q = torch.randint(-128, 128, shape, generator=gen, dtype=torch.int8)
    qw = torch.randint(-127, 128, (cout, k, k, shape[3] // groups),
                       generator=gen, dtype=torch.int8)
    kw = int8_epilogue(gen, q, qw, stride, pad, groups, mode, relu, zp_in,
                       identity, features)
    if zp_in:
        assert kw["zp"].dim() == (1 if pad == 0 else 4)
    got = IC.int8_conv_requant_plain(q, qw, stride, pad, groups, **kw)
    assert int8_outputs_equal(got, _torch_sequence(q, qw, stride, pad, groups,
                                                   **kw))
    n = IC.int8_conv_requant.launches
    assert int8_outputs_equal(
        IC.int8_conv_requant(q, qw, stride, pad, groups, **kw), got)
    assert IC.int8_conv_requant.launches == n  # the CPU takes the plain one
    out = got[0] if features else got
    if mode == "float":  # biases NaN, +inf, -inf
        assert torch.isnan(out[..., 0]).all()
        assert (out[..., 1] == float("inf")).all()
        assert (out[..., 2] == -float("inf")).all()
        return
    # NaN -> code 0; +-inf -> the range's ends; half-way quotients round to
    # even (2.5 -> 2, 3.5 -> 4, 254.5 -> 254, 0.5 -> 0, -2.5 -> -2)
    if relu or mode == "residual":
        want = [0, 127, -128, 2 - 128, 4 - 128, 254 - 128, -128]
    else:
        want = [0, 127, -127, 2, 4, -2, 0]
    for c, v in enumerate(want):
        assert (out[..., c] == v).all(), (c, out[..., c].unique())


def test_int8_conv_templates_by_shape():
    """The kernel's main loop is chosen from the shape (and alignment)
    before the launch: wgmma for 45 of the trunk's 46 convolutions, mma.sync
    for dec0 (C = 3), the odd cases and codes at an odd address."""
    convs = int8_trunk_convs(BUCKETS[0], EVAL_BATCH)
    paths = {}
    for name, shape, cout, k, stride, _ in convs:
        q = torch.empty(shape, dtype=torch.int8)
        qw = torch.empty((cout, k, k, shape[3]), dtype=torch.int8)
        paths[name] = IC.template_for(q, qw, stride)
    assert len(paths) == 46 and paths.pop("dec0") == "mma_sync"
    assert set(paths.values()) == {"wgmma"}
    for _, shape, cout, k, stride, _, groups in INT8_CONV_ODD:
        q = torch.empty(shape, dtype=torch.int8)
        qw = torch.empty((cout, k, k, shape[3] // groups), dtype=torch.int8)
        assert IC.template_for(q, qw, stride, groups) == "mma_sync"
    q = torch.empty(2 * 5 * 5 * 64 + 1, dtype=torch.int8)[1:].view(2, 5, 5,
                                                                   64)
    qw = torch.empty((128, 3, 3, 64), dtype=torch.int8)
    assert IC.template_for(q, qw) == "mma_sync"
    assert IC.template_for(q.clone(), qw) == "wgmma"


def _rn32(x: Fraction) -> Fraction:
    """x rounded to the nearest float32, half to even (normal range)."""
    if x == 0:
        return Fraction(0)
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    assert -126 <= e <= 127
    unit = Fraction(2) ** (e - 23)
    m = a / unit
    q, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and q % 2):
        q += 1
    return (1 if x > 0 else -1) * q * unit


def test_branch_free_site_quotient_is_ieee_division():
    """quotient<true> of csrc/int8_conv.cu: rs = RN(1/s), q0 = RN(y rs),
    q1 = RN(q0 + RN(y - q0 s) rs), q2 = RN(q1 + RN(y - q1 s) rs), every
    step one IEEE rounding (__fmul_rn, __fmaf_rn); held to RN(y / s) for
    site scales across the kernel's range and y at and beside (n + 1/2) s,
    where rint(y / s) turns on the last bit.  q0 alone misses a quarter of
    these cases."""
    rng = np.random.RandomState(11)
    missed_by_q0 = 0
    for i in range(1500):
        s = np.float32(2.0 ** rng.uniform(-60, 60))
        if i % 3 == 0:  # an unsigned site's scale, s 127/255
            s = np.float32(s * np.float32(127.0 / 255.0))
        y = np.float32((rng.randint(-300, 301) + 0.5) * float(s))
        for _ in range(rng.randint(0, 3)):
            y = np.nextafter(y, np.float32(np.inf if rng.rand() < 0.5
                                           else -np.inf))
        Y, S = Fraction(float(y)), Fraction(float(s))
        rs = _rn32(1 / S)
        q0 = _rn32(Y * rs)
        q1 = _rn32(_rn32(Y - q0 * S) * rs + q0)
        q2 = _rn32(_rn32(Y - q1 * S) * rs + q1)
        want = _rn32(Y / S)
        assert q2 == want, (float(y), float(s))
        missed_by_q0 += q0 != want
    assert missed_by_q0 > 100  # the cases reach the quotient's last bit
