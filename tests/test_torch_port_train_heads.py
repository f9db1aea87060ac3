"""The port's Mask and Keypoint R-CNN training losses against the JAX
package's, on the CPU.

The org models of config/org/{mask,keypoint}_rcnn-backbone_resnet50.yaml
at full width with 5 and 2 classes, batch 2 at 192x256 with 4 GT boxes an
image (tests/test_train_losses.py's size).  Weights: the port's seeded
init with live BNs, carried to JAX by the JAX package's converter and back
by ``state_dict_from_jax``.  The samplers take JAX's own draws, replayed
from its key splits.

  * the GT mask projection (``project_boxes_on_crops``) on elliptical and
    rectangular masks, to 1e-6; the positive selection, exactly;
  * one float32 training forward of each model: the five loss terms to
    rtol 1e-5, and the gradients of ``mask_fcn1`` and ``keypoint_head.0``
    to GRAD_TOL of their largest element;
  * the bfloat16 loss arithmetic: the same bfloat16 head logits through
    both sides' mask BCE and keypoint log-softmax, to rtol 1e-5 (the
    tolerance of the bfloat16 RPN loss test,
    tests/test_torch_port_detection.py);
  * an image with no positive (its RoIs pool zeros and get no gradient;
    with no positive in the batch the loss is 0, not NaN), and a keypoint
    on its box's right edge (outside the 56x56 grid, not a target);
  * ``coco_runner``'s non-finite-loss guard naming the term, and
    chip_smoke.py's org config blocks equal to the YAMLs.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (ORG_KEYPOINT_MODEL, ORG_MASK_MODEL, ORG_TPU,
                        ORG_TRAIN, live_norms_)
from hnd_ghnd_tpu.models import roi_heads as jroi
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu_torch.core.config import load_config
from hnd_ghnd_tpu_torch.data.loader import MASK_CROP_SIZE, mask_box_crop
from hnd_ghnd_tpu_torch.models import roi_heads as troi
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import build_model, init_model
from hnd_ghnd_tpu_torch.runners import coco_runner
from tests.test_torch_port_detection import _get, _replay, _rng_draws
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

B, H, W, G = 2, 192, 256, 4
KINDS = {"mask_rcnn": (ORG_MASK_MODEL, 5), "keypoint_rcnn":
         (ORG_KEYPOINT_MODEL, 2)}
TERM_TOL = 1e-5
# the head leaf's gradient, as a fraction of its largest element: against
# the port's float64 forward, JAX's float32 gradients are 1.6e-5
# (mask_fcn1) and 1.35e-3 (keypoint_head.0, under 8 convs of 512) off, the
# port's float32 ones 1.3e-4 and 4.7e-4, so the port is held to JAX at
# about twice the larger
GRAD_TOL = 3e-3
SEED = 11
# the heads' leaf whose gradient is compared, by kind (port name, JAX path)
LEAVES = {"mask_rcnn": ("roi_heads.mask_head.mask_fcn1",
                        ("roi_heads", "mask_head", "mask_fcn1")),
          "keypoint_rcnn": ("roi_heads.keypoint_head.0",
                            ("roi_heads", "keypoint_head", "0"))}


def _boxes(rng, b=B, g=G):
    xy = rng.rand(b, g, 2) * 80
    wh = rng.rand(b, g, 2) * 60 + 20
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _mask(box, shape, ellipse):
    """A binary mask of ``box`` [4]: the box's rectangle, or the ellipse
    inscribed in it."""
    x1, y1, x2, y2 = box
    yy, xx = np.mgrid[:shape[0], :shape[1]] + 0.5
    if ellipse:
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        inside = (((xx - cx) / ((x2 - x1) / 2)) ** 2
                  + ((yy - cy) / ((y2 - y1) / 2)) ** 2) <= 1.0
    else:
        inside = (xx >= x1) & (xx < x2) & (yy >= y1) & (yy < y2)
    return inside.astype(np.uint8)


def _targets(rng, kind, num_classes):
    boxes = _boxes(rng)
    t = {"boxes": boxes,
         "labels": rng.randint(1, num_classes, (B, G)).astype(np.int32),
         "boxes_valid": np.ones((B, G), bool)}
    t["boxes_valid"][1, -1] = False  # padding, as the loader pads to MAX_GT
    if kind == "mask_rcnn":
        r = MASK_CROP_SIZE + 2
        crops = np.zeros((B, G, r, r), np.float16)
        for i in range(B):
            for j in range(G):
                crops[i, j] = mask_box_crop(
                    _mask(boxes[i, j], (H, W), ellipse=(i + j) % 2 == 0),
                    boxes[i, j])
        t["masks_crop"] = crops
    else:
        kps = np.zeros((B, G, 17, 3), np.float32)
        for i in range(B):
            for j in range(G):
                x1, y1, x2, y2 = boxes[i, j]
                # some keypoints a little outside their box
                kps[i, j, :, 0] = rng.uniform(x1 - 5, x2 + 5, 17)
                kps[i, j, :, 1] = rng.uniform(y1 - 5, y2 + 5, 17)
                kps[i, j, :, 2] = rng.choice([0, 1, 2], 17)
        t["keypoints"] = kps
    return t


def _torch(t):
    out = {k: torch.from_numpy(v) for k, v in t.items()}
    out["labels"] = out["labels"].long()
    return out


def _batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, H, W, 3).astype(np.float32)
    images[1, 160:] = 0.0  # bucket padding
    sizes = np.array([(H, W), (160, W)], np.int32)
    return {"images": images, "image_sizes": sizes, "original_sizes": sizes}


# ------------------------------------------------------------ the pieces
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_org_blocks_are_the_yaml_configs(kind):
    """chip_smoke.py spells the org configs out (yaml may be missing on the
    GPU host): its blocks are the YAMLs'."""
    config = load_config(f"config/org/{kind}-backbone_resnet50.yaml")
    assert config["model"] == KINDS[kind][0]
    assert config["train"] == ORG_TRAIN and config["tpu"] == ORG_TPU


@pytest.mark.parametrize("ellipse", [True, False],
                         ids=["elliptical", "rectangular"])
def test_project_boxes_on_crops_matches_jax(ellipse):
    rng = np.random.RandomState(3)
    n = 24
    gt = _boxes(rng, 1, n)[0]
    crops = np.stack([mask_box_crop(_mask(b, (H, W), ellipse), b)
                      for b in gt]).astype(np.float32)
    # proposals around their GT, some past the image and some degenerate
    props = gt + rng.uniform(-15, 15, gt.shape).astype(np.float32)
    props[:3, 2:] = props[:3, :2] + rng.uniform(0, 0.5, (3, 2))
    want = jroi._project_boxes_on_crops(jnp.asarray(crops), jnp.asarray(gt),
                                        jnp.asarray(props), 28)
    got = troi.project_boxes_on_crops(torch.from_numpy(crops),
                                      torch.from_numpy(gt),
                                      torch.from_numpy(props), 28)
    assert got.shape == (n, 28, 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert 0.2 < float(got.mean()) < 0.9  # the targets are not all 0 or 1


def _sampled(rng, b=B, s=512, n_pos=(40, 0)):
    """A select_training_samples output with ``n_pos`` positives an image
    at random slots."""
    boxes = _boxes(rng, b, s)
    labels = rng.randint(1, 5, (b, s)).astype(np.int32)
    pos = np.zeros((b, s), bool)
    for i, n in enumerate(n_pos):
        pos[i, rng.choice(s, n, replace=False)] = True
    labels[~pos] = 0
    gt = rng.randint(0, G, (b, s)).astype(np.int32)
    reg = np.zeros((b, s, 4), np.float32)
    return boxes, labels, reg, pos, np.ones((b, s), bool), gt


def test_select_positives_matches_jax():
    sampled = _sampled(np.random.RandomState(4), n_pos=(140, 0))
    heads = jroi.RoIHeads(jroi.RoIConfig())
    want = heads._select_positives(tuple(jnp.asarray(a) for a in sampled),
                                   troi.MAX_POSITIVES)
    got = troi.RoIHeads.select_positives(
        tuple(torch.from_numpy(a) for a in sampled))
    for name, g, w in zip(("boxes", "labels", "positive", "gt"), got, want):
        assert g.shape[1] == troi.MAX_POSITIVES
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert bool(got[2][0].all()) and not bool(got[2][1].any())


# ------------------------------------------------- one float32 forward
def _weights(kind):
    """(config, JAX params, JAX state, port model) on the same weights.
    The port model is loaded back from JAX's folded frozen BNs, so its BN
    ``weight``/``bias`` are JAX's ``scale``/``bias``."""
    cfg, ncls = KINDS[kind]
    cfg = dict(cfg, params=dict(cfg["params"], num_classes=ncls,
                                pretrained=False))
    pm = build_model(cfg)
    init_model(pm, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict(live_norms_(pm, 0).state_dict())
    state = {"backbone": {"body": {}}}
    pm.load_state_dict(state_dict_from_jax(params, state))
    return cfg, params, state, pm


def _inputs(kind):
    batch = _batch(SEED)
    targets = _targets(np.random.RandomState(SEED), kind, KINDS[kind][1])
    return batch, targets, jax.random.PRNGKey(SEED)


def _jax_forward(kind, cfg, params, state):
    """JAX's float32 training forward: (terms, the leaf's gradient)."""
    batch, targets, key = _inputs(kind)
    path = LEAVES[kind][1]
    jm = jax_build_model(cfg)

    def loss_fn(leaf, params):
        params = copy.copy(params)
        node = params
        for k in path[:-1]:
            node[k] = copy.copy(node[k])
            node = node[k]
        node[path[-1]] = leaf
        losses, _, _ = jm.forward(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()},
            training=True, targets={k: jnp.asarray(v)
                                    for k, v in targets.items()}, rng=key)
        return sum(losses.values()), losses

    (_, terms), grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _get(params, path), params)
    return ({k: float(v) for k, v in terms.items()},
            {k: np.asarray(v) for k, v in grad.items()})


def _port_forward(kind, pm, dtype=torch.float32):
    """The port's training forward in ``dtype`` on JAX's draws: (terms, the
    leaf's gradient (weight OIHW, bias))."""
    batch, targets, key = _inputs(kind)
    n_anchors = 3 * sum((H // s) * (W // s) for s in (4, 8, 16, 32)) \
        + 3 * (H // 64) * (W // 64)
    model = pm.to(dtype).train()
    t = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in _torch(targets).items()}
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    b["images"] = b["images"].to(dtype)
    losses = model(b, t,
                   _replay(_rng_draws(key, B, n_anchors, 2000 + G)))
    leaf = dict(model.named_modules())[LEAVES[kind][0]]
    grads = torch.autograd.grad(sum(losses.values()),
                                [leaf.weight, leaf.bias])
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@pytest.fixture(scope="module", params=sorted(KINDS))
def step(request):
    """JAX's and the port's float32 training forward of one kind on the
    same weights, batch and draws: (kind, JAX terms, JAX leaf gradient,
    port terms, port leaf gradient)."""
    kind = request.param
    cfg, params, state, pm = _weights(kind)
    return (kind, *_jax_forward(kind, cfg, params, state),
            *_port_forward(kind, pm))


def test_step_terms_match_jax(step):
    kind, jterms, _, terms, _ = step
    extra = "loss_mask" if kind == "mask_rcnn" else "loss_keypoint"
    assert sorted(terms) == sorted(["loss_classifier", "loss_box_reg",
                                    "loss_objectness", "loss_rpn_box_reg",
                                    extra])
    assert set(terms) == set(jterms)
    assert terms[extra] > 0
    for k, v in terms.items():
        np.testing.assert_allclose(v, jterms[k], rtol=TERM_TOL, err_msg=k)


def test_step_head_gradients_match_jax(step):
    _, _, jgrad, _, (gw, gb) = step
    # port OIHW -> JAX HWIO
    for got, ref in ((gw.permute(2, 3, 1, 0).numpy(), jgrad["w"]),
                     (gb.numpy(), jgrad["b"])):
        scale = np.abs(ref).max()
        assert scale > 0
        err = np.abs(got - ref).max()
        assert err <= GRAD_TOL * scale, (err, scale)


# --------------------------------------------------------- heads alone
C = 16


@functools.lru_cache(maxsize=None)
def _head_params(kind):
    return _jax_heads(kind).init(jax.random.PRNGKey(1))


def _jax_heads(kind):
    return jroi.RoIHeads(jroi.RoIConfig(
        num_classes=KINDS[kind][1], with_mask=kind == "mask_rcnn",
        with_keypoint=kind == "keypoint_rcnn"), out_channels=C)


def _heads(kind):
    """JAX's RoIHeads (C-channel levels) and its params, and the port's
    RoIHeads on those weights."""
    jheads = _jax_heads(kind)
    params = _head_params(kind)
    port = troi.RoIHeads(KINDS[kind][1], out_channels=C, kind=kind)
    sd = state_dict_from_jax({"roi_heads": params}, {})
    port.load_state_dict({k[len("roi_heads."):]: v for k, v in sd.items()})
    return jheads, params, port


def _levels(rng, b=B):
    return [rng.randn(b, H // s, W // s, C).astype(np.float32)
            for s in (4, 8, 16, 32)]


def _head_loss_jax(jheads, params, feats, sampled, targets, kind):
    args = (params, [jnp.asarray(f) for f in feats], (H, W),
            tuple(jnp.asarray(a) for a in sampled))
    if kind == "mask_rcnn":
        return jheads.mask_loss(*args, jnp.asarray(targets["boxes"]),
                                jnp.asarray(targets["masks_crop"]))
    return jheads.keypoint_loss(*args, jnp.asarray(targets["keypoints"]))


def _head_loss_port(port, feats, sampled, targets, kind):
    sampled = tuple(torch.from_numpy(a) for a in sampled)
    sampled = (sampled[0], sampled[1].long(), *sampled[2:])
    t = _torch(targets)
    if kind == "mask_rcnn":
        return port.mask_loss(feats, (H, W), sampled, t["boxes"],
                              t["masks_crop"])
    return port.keypoint_loss(feats, (H, W), sampled, t["keypoints"])


def test_no_positive_image_pools_zeros_and_gets_no_gradient():
    """Image 1 has no positive: its 128 slots are weighted 0 in the pooling
    and the loss, so its levels get no gradient; the loss of image 0
    matches JAX's.  With no positive in the batch the loss is 0 and the
    levels get no gradient.  (The keypoint loss pools the same way.)"""
    kind = "mask_rcnn"
    _, ncls = KINDS[kind]
    rng = np.random.RandomState(5)
    jheads, params, port = _heads(kind)
    targets = _targets(rng, kind, ncls)
    sampled = _sampled(rng, n_pos=(30, 0))
    sampled[5][...] = np.minimum(sampled[5], G - 2)
    feats = _levels(rng)
    want = jax.jit(lambda p, f: _head_loss_jax(jheads, p, f, sampled,
                                               targets, kind))(params, feats)
    fs = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True)
          for f in feats]
    got = _head_loss_port(port, fs, sampled, targets, kind)
    np.testing.assert_allclose(float(got["loss_mask"].detach()),
                               float(want["loss_mask"]), rtol=TERM_TOL)
    grads = torch.autograd.grad(got["loss_mask"], fs)
    assert sum(float(g[0].abs().sum()) for g in grads) > 0
    assert all(bool((g[1] == 0).all()) for g in grads)
    none = _no_positive(sampled)
    (value,) = _head_loss_port(port, fs, none, targets, kind).values()
    assert torch.isfinite(value) and float(value.detach()) == 0.0
    assert all(bool((g == 0).all()) for g in torch.autograd.grad(value, fs))


def _no_positive(sampled):
    out = list(sampled)
    out[3] = np.zeros_like(sampled[3])
    out[1] = np.zeros_like(sampled[1])
    return tuple(out)


class _Fixed(torch.nn.Module):
    """A head that returns given logits, whatever its input."""

    def __init__(self, logits):
        super().__init__()
        self.logits = logits

    def forward(self, x):
        return self.logits


def _fixed_logit_losses(kind, targets, sampled, logits_jax, logits_port):
    """Both sides' loss on the given head logits (JAX [B*P, h, w, K], the
    port's [B*P, K, h, w])."""
    jheads, params, port = _heads(kind)
    head = "mask_head" if kind == "mask_rcnn" else "keypoint_head"

    def jax_loss(params, feats, logits):
        getattr(jheads, head).apply = lambda p, x: logits
        return _head_loss_jax(jheads, params, feats, sampled, targets, kind)

    if kind == "mask_rcnn":
        port.mask_head = torch.nn.Identity()
        port.mask_predictor = _Fixed(logits_port)
    else:
        port.keypoint_head = torch.nn.Identity()
        port.keypoint_predictor = _Fixed(logits_port)
    feats = _levels(np.random.RandomState(0))
    want = jax.jit(jax_loss)(params, feats, logits_jax)
    fs = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats]
    return _head_loss_port(port, fs, sampled, targets, kind), want


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bf16_loss_arithmetic_matches_jax(kind):
    """The same bfloat16 logits through both sides: the BCE and the
    log-softmax run in the logits' dtype where JAX's do, and promote to
    float32 where JAX's do."""
    _, ncls = KINDS[kind]
    rng = np.random.RandomState(6)
    targets = _targets(rng, kind, ncls)
    sampled = _sampled(rng, n_pos=(50, 20))
    sampled[5][...] = np.minimum(sampled[5], G - 2)
    p = B * troi.MAX_POSITIVES
    shape = (p, 28, 28, ncls) if kind == "mask_rcnn" else (p, 56, 56, 17)
    logits = jnp.asarray(3 * rng.randn(*shape).astype(np.float32),
                         jnp.bfloat16)
    port_logits = torch.tensor(np.asarray(logits.astype(jnp.float32))) \
        .to(torch.bfloat16).permute(0, 3, 1, 2)
    got, want = _fixed_logit_losses(kind, targets, sampled, logits,
                                    port_logits)
    (name, value), = got.items()
    assert value.dtype == torch.float32 and want[name].dtype == jnp.float32
    np.testing.assert_allclose(float(value), float(want[name]),
                               rtol=TERM_TOL)


def test_keypoint_on_the_right_edge_is_not_a_target():
    """floor((x2 - x1) * 56 / w) = 56 falls outside the grid: the inside
    test comes before the boundary clip, so the keypoint drops out, as in
    JAX (and torchvision's keypoints_to_heatmap)."""
    rng = np.random.RandomState(7)
    targets = _targets(rng, "keypoint_rcnn", 2)
    sampled = _sampled(rng, n_pos=(10, 0))
    sampled[5][...] = 0
    slots = np.flatnonzero(sampled[3][0])
    # power-of-two widths and heights: (x2 - x1) * 56 / w is exactly 56
    sampled[0][0, slots] = [10.0, 20.0, 74.0, 52.0]
    kps = targets["keypoints"]
    kps[0, 0, :, 2] = 2
    kps[0, 0, :, 0] = rng.uniform(11, 73, 17)
    kps[0, 0, :, 1] = rng.uniform(21, 51, 17)
    kps[0, 0, 0, :2] = [74.0, 30.0]    # on the right edge
    kps[0, 0, 1, :2] = [10.0, 30.0]    # on the left edge: cell 0, inside
    kps[0, 0, 2, :2] = [40.0, 52.0]    # on the bottom edge
    p = B * troi.MAX_POSITIVES
    logits = rng.randn(p, 56, 56, 17).astype(np.float32)
    port_logits = torch.from_numpy(logits).permute(0, 3, 1, 2)
    got, want = _fixed_logit_losses("keypoint_rcnn", targets, sampled,
                                    jnp.asarray(logits), port_logits)
    np.testing.assert_allclose(float(got["loss_keypoint"]),
                               float(want["loss_keypoint"]), rtol=TERM_TOL)
    # the same loss with the two edge keypoints invisible
    hidden = copy.deepcopy(targets)
    hidden["keypoints"][0, 0, [0, 2], 2] = 0
    again, _ = _fixed_logit_losses("keypoint_rcnn", hidden, sampled,
                                   jnp.asarray(logits), port_logits)
    assert float(again["loss_keypoint"]) == float(got["loss_keypoint"])
    moved = copy.deepcopy(targets)
    moved["keypoints"][0, 0, 1, 2] = 0
    third, _ = _fixed_logit_losses("keypoint_rcnn", moved, sampled,
                                   jnp.asarray(logits), port_logits)
    assert float(third["loss_keypoint"]) != float(got["loss_keypoint"])


def test_no_positive_keypoint_loss_is_zero():
    """Image 1 has no positive (the loss matches JAX's); with no positive
    in the batch the keypoint loss is 0, not NaN."""
    rng = np.random.RandomState(8)
    targets = _targets(rng, "keypoint_rcnn", 2)
    sampled = _sampled(rng, n_pos=(25, 0))
    p = B * troi.MAX_POSITIVES
    logits = rng.randn(p, 56, 56, 17).astype(np.float32)
    port_logits = torch.from_numpy(logits).permute(0, 3, 1, 2)
    got, want = _fixed_logit_losses("keypoint_rcnn", targets, sampled,
                                    jnp.asarray(logits), port_logits)
    np.testing.assert_allclose(float(got["loss_keypoint"]),
                               float(want["loss_keypoint"]), rtol=TERM_TOL)
    got, want = _fixed_logit_losses("keypoint_rcnn", targets,
                                    _no_positive(sampled),
                                    jnp.asarray(logits), port_logits)
    assert torch.isfinite(got["loss_keypoint"])
    assert float(got["loss_keypoint"]) == float(want["loss_keypoint"]) == 0.0


class _NonFiniteStep:
    """A step whose mask loss is NaN, as a DetectionStep returns it."""

    def __init__(self):
        self.model = torch.nn.Linear(1, 1)
        self.step = 0

    def __call__(self, batch, targets):
        self.step += 1
        terms = {"loss_classifier": torch.tensor(0.5),
                 "loss_mask": torch.tensor(float("nan"))}
        return sum(terms.values()), terms


def test_coco_runner_names_the_non_finite_term():
    """The non-finite-loss guard stops training and names the term."""
    batch = {"images": np.zeros((1, 8, 8, 3), np.float32)}
    with pytest.raises(FloatingPointError, match="non-finite loss_mask "):
        coco_runner.train_epoch(_NonFiniteStep(), [(batch, {})])
