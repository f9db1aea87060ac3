"""The port's stages against the JAX package's, on the same weights.

A JAX-initialised b3ch student (full widths) with live BNs and residual
branches (``live_models``) on both sides.  At 128x192, batch 2, float32:

  * trunk and FPN, without the 8-bit bottleneck round trip and with it
    (both sides decoding the same codes);
  * the RPN head and the proposals, both fed the JAX FPN maps;
  * the box head's logits, fed the JAX maps and proposals;

each to 1e-4 of the stage's largest magnitude (float32 convolutions and
matrix products summed in another order).  A last check shows that every
residual branch of layer2-4 moves the layer4 output beyond that bound, so
the comparison sees them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnd_ghnd_tpu.codec import quantizer as jq
from hnd_ghnd_tpu.ops.roi_align import multiscale_roi_align_batch
from hnd_ghnd_tpu_torch.codec import quantizer as tq
from tests.test_torch_port_weights import live_models
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

TOL = 1e-4
SHAPE = (128, 192)
SIZES = np.array([[128, 192], [100, 150]], np.int32)


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = np.abs(want).max()
    assert err <= TOL * scale, f"{what}: max err {err} vs {TOL} x {scale}"


def _nhwc(t):
    # the student's stem and bottleneck train, so their outputs carry grad
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def setup():
    jm, params, state, pm = live_models()
    rng = np.random.RandomState(0)
    images = rng.rand(2, *SHAPE, 3).astype(np.float32)
    images[1, SIZES[1, 0]:] = 0.0  # bucket padding
    images[1, :, SIZES[1, 1]:] = 0.0
    return jm, params, state, pm, images


@pytest.fixture(scope="module")
def jax_fpn(setup):
    jm, params, state, _, images = setup
    _, fpn, _, _ = jax.jit(lambda p, s, x: jm.backbone_features(
        p, s, x, training=False))(params, state, jnp.asarray(images))
    return [np.asarray(f) for f in fpn]


@pytest.fixture(scope="module")
def jax_rpn(setup, jax_fpn):
    jm, params, _, _, _ = setup
    props, valid, (obj, deltas, _) = jax.jit(
        lambda p, f, s: jm.rpn.propose(p, f, s, SHAPE, training=False))(
        params["rpn"], [jnp.asarray(f) for f in jax_fpn], jnp.asarray(SIZES))
    return props, valid, obj, deltas


def _jax_split_trunk(jm, params, state, images):
    """JAX's trunk and FPN with the bottleneck round trip opened: the
    encoder output, and a tail that runs decoder, layer2-4 and FPN on a
    given bottleneck tensor."""
    bp, bs = params["backbone"]["body"], state["backbone"]["body"]
    body = jm.body
    bottleneck = body.injected_layer1

    @jax.jit
    def head(x):
        z, _ = bottleneck.encode(bp["layer1"], bs["layer1"],
                                 body.stem(bp, jm.normalize(x)),
                                 training=False)
        return z

    @jax.jit
    def tail(z):
        y, _ = bottleneck.decode(bp["layer1"], bs["layer1"], z,
                                 training=False)
        feats = {"layer1": y}
        for stage in (1, 2, 3):
            y = body._apply_stage(bp, y, stage)
            feats[f"layer{stage + 1}"] = y
        return feats, jm.fpn.apply(params["backbone"]["fpn"],
                                   [feats[f"layer{i}"] for i in (1, 2, 3, 4)])

    return head(jnp.asarray(images)), tail


def _check_trunk(body_p, fpn_p, body_j, fpn_j):
    for i in (1, 2, 3, 4):
        _close(_nhwc(body_p[f"layer{i}"]), body_j[f"layer{i}"], f"layer{i}")
    assert len(fpn_p) == len(fpn_j) == 5
    for i, (p, j) in enumerate(zip(fpn_p, fpn_j)):
        _close(_nhwc(p), j, f"P{i + 2}")


@pytest.mark.parametrize("transformer", [False, True])
def test_trunk_and_fpn(setup, transformer):
    jm, params, state, pm, images = setup
    if not transformer:
        body_j, fpn_j, _, _ = jax.jit(lambda p, s, x: jm.backbone_features(
            p, s, x, training=False))(params, state, jnp.asarray(images))
        _check_trunk(*pm.backbone_features(torch.from_numpy(images)),
                     body_j, fpn_j)
        return
    # Rounding to codes is a discrete step: an encoder output on a .5
    # boundary may round to neighbouring codes on the two sides.  So the
    # encoder outputs are compared, the codes are held to one level apart
    # on a few elements, and both tails decode JAX's codes.
    z_j, tail_j = _jax_split_trunk(jm, params, state, images)
    body = pm.backbone.body
    z_p = body.layer1.encoder(body.stem(pm.normalize(
        torch.from_numpy(images))))
    _close(_nhwc(z_p), z_j, "encoder output")
    codes_j = np.asarray(jq.quantize_tensor(z_j, 8).tensor, np.int32)
    codes_p = tq.quantize_tensor(z_p.permute(0, 2, 3, 1), 8).tensor
    flips = np.abs(codes_p.numpy().astype(np.int32) - codes_j)
    assert flips.max() <= 1 and (flips > 0).sum() <= flips.size // 1000
    zq_j = jq.roundtrip(z_j, 8)
    y = body.layer1.decoder(_nchw(zq_j))
    body_p = {"layer1": y}
    for i in (2, 3, 4):
        y = getattr(body, f"layer{i}")(y)
        body_p[f"layer{i}"] = y
    fpn_p = pm.backbone.fpn([body_p[f"layer{i}"] for i in (1, 2, 3, 4)])
    _check_trunk(body_p, fpn_p, *tail_j(zq_j))


def test_rpn_head_and_proposals(setup, jax_fpn, jax_rpn):
    pm = setup[3]
    props_j, valid_j, obj_j, delta_j = jax_rpn
    feats = [_nchw(f) for f in jax_fpn]
    obj_p, delta_p = pm.rpn.head(feats)
    for lv, (op, oj, dp, dj) in enumerate(zip(obj_p, obj_j, delta_p, delta_j)):
        _close(op.numpy(), np.asarray(oj).reshape(2, -1), f"objectness P{lv + 2}")
        _close(dp.numpy(), np.asarray(dj).reshape(2, -1, 4), f"deltas P{lv + 2}")
    props_p, valid_p, _ = pm.rpn.propose(feats, torch.from_numpy(SIZES), SHAPE)
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_j))
    props_p, props_j = props_p.numpy(), np.asarray(props_j)
    bound = TOL * np.abs(props_j).max()
    for i, n in enumerate(np.asarray(valid_j).sum(1)):
        # the same proposals in the same order, except that two whose
        # objectness ties to float32 noise may trade places
        same = np.abs(props_p[i, :n, None] - props_j[i, None, :n]).max(-1) \
            <= bound
        assert same.any(1).all(), f"image {i}: a proposal is not JAX's"
        perm = same.argmax(1)
        assert len(set(perm)) == n, f"image {i}: proposals not one to one"
        moved = np.flatnonzero(perm != np.arange(n))
        assert np.abs(perm - np.arange(n)).max() <= 2, f"image {i}: {moved}"
        assert len(moved) <= n // 50, f"image {i}: {len(moved)} rows moved"


def test_box_head_logits(setup, jax_fpn, jax_rpn):
    jm, params, _, pm, _ = setup
    props, valid = jax_rpn[:2]

    def head(rp, feats, boxes, ok):
        pooled = multiscale_roi_align_batch(feats, boxes, SHAPE, 7,
                                            boxes_valid=ok)
        rep = jm.roi_heads.box_head.apply(
            rp["box_head"], pooled.reshape((-1,) + pooled.shape[2:]))
        return jm.roi_heads.box_predictor.apply(rp["box_predictor"], rep)

    cls_j, deltas_j = jax.jit(head)(
        params["roi_heads"], [jnp.asarray(f) for f in jax_fpn[:4]], props,
        valid)
    cls_p, deltas_p = pm.roi_heads.box_logits(
        [_nchw(f) for f in jax_fpn], torch.from_numpy(np.array(props)),
        torch.from_numpy(np.array(valid)), SHAPE)
    _close(cls_p.reshape(-1, cls_p.shape[-1]).numpy(), cls_j, "class logits")
    _close(deltas_p.reshape(-1, deltas_p.shape[-1]).numpy(), deltas_j,
           "box deltas")


BLOCKS = [f"layer{s}.{b}" for s, n in ((2, 4), (3, 6), (4, 3)) for b in range(n)]


@pytest.mark.parametrize("block", BLOCKS)
def test_every_residual_branch_moves_layer4(setup, block):
    pm, images = setup[3], torch.from_numpy(setup[4])
    body = pm.backbone.body
    want = body(pm.normalize(images))["layer4"]
    conv2 = body.get_submodule(f"{block}.conv2")
    kept = conv2.weight.clone()
    conv2.weight.zero_()
    try:
        got = body(pm.normalize(images))["layer4"]
    finally:
        conv2.weight.copy_(kept)
    err = float((got - want).abs().max())
    assert err > TOL * float(want.abs().max()), f"{block}.conv2 is invisible"
