"""A whole bfloat16 supervised step of the port against the JAX package's,
on the CPU (ROADMAP C13).

The org Mask and Keypoint R-CNN at tests/test_torch_port_train_heads.py's
size (full width, batch 2 at 192x256, 4 GT boxes an image, the same
weights, batch, targets and JAX draws), in the configs' compute dtype:
images in bfloat16, float32 parameters cast by the layers.  Top-k, NMS and
sampling flip under bfloat16 noise, so the RoI losses of both sides take
the RoIs JAX's bfloat16 forward sampled, and the RPN losses JAX's replayed
draws.

Tolerance: JAX's own bfloat16-vs-float32 gap, measured here as
``test_bf16_trunk_and_fpn_within_jax_own_bf16_gap`` does
(tests/test_torch_port_detection.py): JAX's float32 forward on the same
sampled RoIs gives each loss term and the gradient of the heads' first
layer (``mask_fcn1``, ``keypoint_head.0``); the port's bfloat16 values
must lie within twice that gap of JAX's bfloat16 ones (two independent
bfloat16 roundings of one function, each about one gap from float32).  A
term is a scalar, and its gap can cancel to near 0 (the Keypoint R-CNN's
loss_box_reg: 2.8e-6 of the term, the Mask R-CNN's 1.4e-5), so a term's gap
is floored at one bfloat16 rounding (2^-9 of the term) averaged over the
batch's positive RoIs, the fewest elements a term averages (68 here).

The test found one real difference, repaired in models/rpn.py: the port
rounded the objectness BCE op by op in bfloat16, as eager JAX does, but
inside JAX's jitted step XLA keeps the fused BCE in float32; on this
seeded model's near-zero logits that moved loss_objectness by 9.3e-4 of
its value, 49 times JAX's own gap.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_detection import _get, _replay, _rng_draws
from tests.test_torch_port_train_heads import (B, G, H, KINDS, LEAVES, W,
                                               _inputs, _torch, _weights)

N_ANCHORS = 3 * sum((H // s) * (W // s) for s in (4, 8, 16, 32)) \
    + 3 * (H // 64) * (W // 64)
BF16_ROUNDING = 2.0 ** -9


def _jax_losses(kind, cfg, params, state, dtype, sampled=None):
    """JAX's training forward with images in ``dtype``: (terms, the first
    head layer's gradient, the sampled RoIs).  With ``sampled``, the RoI
    losses take those RoIs in place of the forward's own sampling."""
    from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
    batch, targets, key = _inputs(kind)
    jm = jax_build_model(cfg)
    path = LEAVES[kind][1]
    shape = (H, W)
    tj = {k: jnp.asarray(v) for k, v in targets.items()}

    def loss_fn(leaf, params, sampled):
        params = copy.copy(params)
        node = params
        for k in path[:-1]:
            node[k] = copy.copy(node[k])
            node = node[k]
        node[path[-1]] = leaf
        images = jnp.asarray(batch["images"]).astype(dtype)
        sizes = jnp.asarray(batch["image_sizes"])
        _, fpn, _, _ = jm.backbone_features(params, state, images,
                                            training=True)
        rpn_rng, roi_rng = jax.random.split(key)
        proposals, pvalid, raw = jm.rpn.propose(params["rpn"], fpn, sizes,
                                                shape, training=True)
        losses = dict(jm.rpn.loss(raw, tj, rpn_rng))
        if sampled is None:
            sampled = jm.roi_heads.select_training_samples(
                proposals, pvalid, tj, roi_rng)
        heads = jm.roi_heads
        losses.update(heads.loss(params["roi_heads"], fpn, shape, sampled))
        if kind == "mask_rcnn":
            losses.update(heads.mask_loss(params["roi_heads"], fpn, shape,
                                          sampled, tj["boxes"],
                                          tj["masks_crop"]))
        else:
            losses.update(heads.keypoint_loss(params["roi_heads"], fpn,
                                              shape, sampled,
                                              tj["keypoints"]))
        return sum(losses.values()), (losses, sampled)

    (_, (terms, used)), grad = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(_get(params, path), params, sampled)
    return ({k: float(v) for k, v in terms.items()},
            {k: np.asarray(v, np.float32) for k, v in grad.items()}, used)


def _port_losses(kind, pm, sampled):
    """The port's bfloat16 training forward on JAX's draws and sampled RoIs:
    (terms, the first head layer's gradient in JAX's layout)."""
    batch, targets, key = _inputs(kind)
    model = pm.train()
    t = _torch(targets)
    images = torch.from_numpy(batch["images"]).bfloat16()
    sizes = torch.from_numpy(batch["image_sizes"])
    _, feats = model.backbone_features(images)
    _, _, raw = model.rpn.propose(feats, sizes, (H, W), training=True)
    losses = dict(model.rpn.loss(
        raw, t, _replay(_rng_draws(key, B, N_ANCHORS, 2000 + G)[:2])))
    rois = []
    for a in sampled:
        a = np.asarray(a)
        rois.append(torch.from_numpy(a.astype(np.float32)).bfloat16()
                    if a.dtype == jnp.bfloat16 else torch.from_numpy(a))
    rois[1] = rois[1].long()
    losses.update(model.roi_losses(feats, (H, W), tuple(rois), t))
    leaf = dict(model.named_modules())[LEAVES[kind][0]]
    gw, gb = torch.autograd.grad(sum(losses.values()),
                                 [leaf.weight, leaf.bias])
    return ({k: float(v.detach().float()) for k, v in losses.items()},
            {"w": gw.permute(2, 3, 1, 0).float().numpy(),
             "b": gb.float().numpy()})


@pytest.fixture(scope="module", params=sorted(KINDS))
def bf16_step(request):
    """(kind, JAX bfloat16, JAX float32 and port bfloat16 (terms, first
    head layer's gradient)), all on the RoIs JAX's bfloat16 forward
    sampled."""
    kind = request.param
    cfg, params, state, pm = _weights(kind)
    jterms, jgrad, sampled = _jax_losses(kind, cfg, params, state,
                                         jnp.bfloat16)
    fterms, fgrad, _ = _jax_losses(kind, cfg, params, state, jnp.float32,
                                   sampled)
    n_pos = int(np.asarray(sampled[3]).sum())
    return (kind, (jterms, jgrad), (fterms, fgrad),
            _port_losses(kind, pm, sampled), n_pos)


def test_bf16_terms_within_jax_own_bf16_gap(bf16_step):
    kind, (jterms, _), (fterms, _), (terms, _), n_pos = bf16_step
    extra = "loss_mask" if kind == "mask_rcnn" else "loss_keypoint"
    assert set(terms) == set(jterms) == set(fterms) and extra in terms
    assert n_pos > 0
    for k, v in terms.items():
        gap = max(abs(jterms[k] - fterms[k]),
                  BF16_ROUNDING * abs(jterms[k]) / np.sqrt(n_pos))
        assert np.isfinite(v), k
        assert abs(v - jterms[k]) <= 2.0 * gap, (k, v, jterms[k], gap)


def test_bf16_head_gradient_within_jax_own_bf16_gap(bf16_step):
    _, (_, jgrad), (_, fgrad), (_, grad), _ = bf16_step
    for k in ("w", "b"):
        gap = np.abs(jgrad[k] - fgrad[k]).max()
        assert gap > 0 and np.abs(jgrad[k]).max() > 0, k
        err = np.abs(grad[k] - jgrad[k]).max()
        assert err <= 2.0 * gap, (k, err, gap)
