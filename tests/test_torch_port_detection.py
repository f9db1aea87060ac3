"""The port's supervised Faster R-CNN training against the JAX package's, on
the CPU.

The org model of config/org/faster_rcnn-backbone_resnet50.yaml at full
width, batch 2 at 96x128 (enough anchors for the 2000 training proposals).
Its weights are the port's seeded init with live BNs (``live_norms_``),
carried to JAX by the JAX package's converter.  The samplers of both sides
take the same uniform draws: JAX's, replayed from its key splits
(rcnn.py:158, rpn.py:195, rpn.py:243, roi_heads.py:367).

  * anchor matching, the balanced sampler, the RPN loss (float32 and
    bfloat16 logits), the RoI sampling, and the RoI loss with its
    gradients, each against JAX's function on the same inputs;
  * the bfloat16 trunk and FPN against JAX's bfloat16 forward, within twice
    JAX's own bfloat16-vs-float32 gap on each level;
  * one float32 detection step against JAX's ``make_detection_train_step``
    (``mesh=None``, float32): the four terms to 1e-4 relative; every
    trainable leaf's gradient held to JAX and to the port's own float64
    step (see ``GRAD_TOL``); frozen leaves (``freeze_layers``) unchanged
    in the port and moved by exactly lr * wd * p in JAX (ROADMAP C7);
  * ``coco_runner.train`` for 2 steps and 1 epoch, in the config's
    bfloat16 (``tpu.compute_dtype`` defaults to bfloat16 as in JAX), and a
    non-finite loss stopping it; distillation in bfloat16 raising.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import (ORG_MODEL, ORG_TRAIN, STUDENT_MODEL, TEACHER_MODEL,
                        TRAIN, live_norms_)
from hnd_ghnd_tpu.models import rpn as jrpn
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.roi_heads import RoIConfig
from hnd_ghnd_tpu.models.roi_heads import RoIHeads as JaxRoIHeads
from hnd_ghnd_tpu.ops.anchors import grid_anchors
from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_build_optimizer
from hnd_ghnd_tpu.parallel.mesh import make_detection_train_step as jax_step
from hnd_ghnd_tpu_torch.models import rpn as trpn
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import (build_model, frozen_modules,
                                               get_model, init_model)
from hnd_ghnd_tpu_torch.models.roi_heads import RoIHeads
from hnd_ghnd_tpu_torch.parallel.train_step import make_detection_train_step
from hnd_ghnd_tpu_torch.runners import coco_runner
from hnd_ghnd_tpu_torch.runners.common import (compute_dtype_from_config,
                                               evaluate)
from hnd_ghnd_tpu_torch.runners.mimic_runner import distill
from tests.test_torch_port_distill import _get, jax_leaf, to_jax_layout
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

SHAPE = (96, 128)
BATCH = 2
MAX_GT = 6
TERM_TOL = 1e-4
SEED = 7
# gradients of one float32 step, as a fraction of each leaf's largest
# element: against the port's float64 step, JAX's float32 gradients are up
# to 5.0e-4 off (the RoI head's fc6, a 12544-term sum over 1024 RoIs) and
# the port's up to 3.8e-5 (a layer2 BN bias), so the port is held to JAX at
# twice JAX's own error and to its float64 step at EXACT_TOL
GRAD_TOL = 1e-3
EXACT_TOL = 1e-4


def _targets(rng, b=BATCH, g=MAX_GT, size=SHAPE):
    h, w = size
    bw = rng.uniform(12, w / 2, (b, g))
    bh = rng.uniform(12, h / 2, (b, g))
    x1 = rng.uniform(0, w - bw)
    y1 = rng.uniform(0, h - bh)
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)
    valid = np.ones((b, g), bool)
    valid[0, -2:] = False  # padding, as the loader pads to MAX_GT
    labels = rng.randint(1, 91, (b, g)).astype(np.int32)
    return {"boxes": boxes, "labels": labels, "boxes_valid": valid}


def _torch_targets(t, device="cpu", dtype=torch.float32):
    return {"boxes": torch.from_numpy(t["boxes"]).to(device, dtype),
            "labels": torch.from_numpy(t["labels"]).long().to(device),
            "boxes_valid": torch.from_numpy(t["boxes_valid"]).to(device)}


def _jax_draws(key, b, n):
    """JAX's sampler draws for one split: per image key -> (kp, kn) ->
    uniform [n] each; -> (positive [b, n], negative [b, n])."""
    pos, neg = [], []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        pos.append(np.array(jax.random.uniform(kp, (n,))))
        neg.append(np.array(jax.random.uniform(kn, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


def _replay(draws):
    """A ``draw`` that hands out ``draws`` in order, checking shapes."""
    it = iter(draws)

    def draw(shape):
        r = next(it)
        assert tuple(r.shape) == tuple(shape), (r.shape, shape)
        return r
    return draw


def _rng_draws(rng, b, n_anchors, n_rois):
    """The four draws of one step from JAX key ``rng`` (rcnn.py:158)."""
    rpn_rng, roi_rng = jax.random.split(rng)
    return [*_jax_draws(rpn_rng, b, n_anchors), *_jax_draws(roi_rng, b, n_rois)]


def test_match_anchors_matches_jax():
    rng = np.random.RandomState(0)
    anchors = np.concatenate(grid_anchors([(12, 16), (6, 8)], SHAPE), 0)
    t = _targets(rng, b=3)
    t["boxes"][1, 1] = t["boxes"][1, 0]      # a tie: the first GT wins
    t["boxes"][1, 2] = anchors[40]          # an exact anchor match
    t["boxes_valid"][2] = False             # no GT: all background
    labels, matched = trpn.match_anchors(
        torch.from_numpy(anchors), torch.from_numpy(t["boxes"]),
        torch.from_numpy(t["boxes_valid"]), 0.7, 0.3, allow_low_quality=True)
    for i in range(3):
        jl, jm = jrpn._match_anchors(
            jnp.asarray(anchors), jnp.asarray(t["boxes"][i]),
            jnp.asarray(t["boxes_valid"][i]), 0.7, 0.3,
            allow_low_quality=True)
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(matched[i].numpy(), np.asarray(jm))
    assert (labels[:2] == 1).any() and (labels[:2] == -1).any()
    assert (labels[2] == 0).all()


@pytest.mark.parametrize("n_pos", [30, 400])
def test_balanced_sample_with_jax_draws(n_pos):
    rng = np.random.RandomState(n_pos)
    labels = np.full(1000, -1.0, np.float32)
    idx = rng.permutation(1000)
    labels[idx[:n_pos]] = 1.0
    labels[idx[n_pos:n_pos + 500]] = 0.0
    key = jax.random.PRNGKey(n_pos)
    jp, jn = jrpn._balanced_sample(jnp.asarray(labels), 256, 0.5, key)
    kp, kn = jax.random.split(key)
    pos, neg = trpn.balanced_sample(
        torch.from_numpy(labels)[None], 256, 0.5,
        torch.from_numpy(np.array(jax.random.uniform(kp, (1000,))))[None],
        torch.from_numpy(np.array(jax.random.uniform(kn, (1000,))))[None])
    np.testing.assert_array_equal(pos[0].numpy(), np.asarray(jp))
    np.testing.assert_array_equal(neg[0].numpy(), np.asarray(jn))
    assert pos.sum() == min(n_pos, 128) and pos.sum() + neg.sum() == 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rpn_loss_matches_jax(dtype):
    rng = np.random.RandomState(1)
    grids = [(24, 32), (12, 16), (6, 8), (3, 4), (2, 2)]
    anchors = grid_anchors(grids, SHAPE)
    obj = [rng.randn(BATCH, h, w, 3).astype(np.float32) for h, w in grids]
    deltas = [0.1 * rng.randn(BATCH, h, w, 3, 4).astype(np.float32)
              for h, w in grids]
    t = _targets(rng)
    key = jax.random.PRNGKey(3)
    jdt = getattr(jnp, dtype)
    # jitted, as JAX's step runs it: XLA keeps the fused bfloat16 BCE in
    # float32 there, where eager JAX rounds each op to bfloat16
    want = jax.jit(lambda o, d: jrpn.RPN().loss(
        (o, d, anchors), {k: jnp.asarray(v) for k, v in t.items()}, key))(
        [jnp.asarray(o, jdt) for o in obj], [jnp.asarray(d, jdt)
                                             for d in deltas])
    n = sum(a.shape[0] for a in anchors)
    tdt = getattr(torch, dtype)
    got = trpn.RPN().loss(
        ([torch.from_numpy(o).to(tdt).reshape(BATCH, -1) for o in obj],
         [torch.from_numpy(d).to(tdt).reshape(BATCH, -1, 4) for d in deltas],
         [torch.from_numpy(a) for a in anchors]),
        _torch_targets(t), _replay(_jax_draws(key, BATCH, n)))
    for k, v in got.items():
        assert v.dtype == torch.float32, k  # bf16 logits promote, as in JAX
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _proposals(rng, r=1000):
    h, w = SHAPE
    x1 = rng.uniform(-10, w, (BATCH, r))
    y1 = rng.uniform(-10, h, (BATCH, r))
    wh = rng.uniform(2, 60, (BATCH, r, 2))
    boxes = np.stack([x1, y1, x1 + wh[..., 0], y1 + wh[..., 1]], -1)
    return (np.clip(boxes, 0, [w, h, w, h]).astype(np.float32),
            rng.rand(BATCH, r) > 0.1)


def test_select_training_samples_matches_jax():
    rng = np.random.RandomState(2)
    props, pvalid = _proposals(rng)
    t = _targets(rng)
    # some proposals on the GT, so the sampler sees positives
    props[:, :MAX_GT] = t["boxes"] + rng.uniform(-2, 2, t["boxes"].shape)
    key = jax.random.PRNGKey(5)
    want = JaxRoIHeads(RoIConfig()).select_training_samples(
        jnp.asarray(props), jnp.asarray(pvalid),
        {k: jnp.asarray(v) for k, v in t.items()}, key)
    got = RoIHeads().select_training_samples(
        torch.from_numpy(props), torch.from_numpy(pvalid), _torch_targets(t),
        _replay(_jax_draws(key, BATCH, props.shape[1] + MAX_GT)))
    names = ("boxes", "labels", "regression", "positive", "sampled", "gt")
    for name, g, w in zip(names, got, want):
        if name == "regression":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert got[3].any() and (~got[4]).sum() == 0  # 512 sampled per image


def test_roi_loss_and_gradients_match_jax():
    rng = np.random.RandomState(3)
    c, k, r = 16, 5, 24
    h, w = SHAPE
    feats = [rng.randn(BATCH, h // s, w // s, c).astype(np.float32)
             for s in (4, 8, 16, 32)]
    props, _ = _proposals(rng, r)
    labels = rng.randint(0, k, (BATCH, r)).astype(np.int32)
    reg = (0.1 * rng.randn(BATCH, r, 4)).astype(np.float32)
    pos = rng.rand(BATCH, r) > 0.5
    on = rng.rand(BATCH, r) > 0.1
    sampled_np = (props, labels, reg, pos, on, np.zeros((BATCH, r), np.int32))
    heads = JaxRoIHeads(RoIConfig(num_classes=k), out_channels=c)
    params = heads.init(jax.random.PRNGKey(0))

    def total(p, fs):
        d = heads.loss(p, fs, SHAPE, tuple(jnp.asarray(a) for a in sampled_np))
        return d["loss_classifier"] + d["loss_box_reg"], d

    (_, want), (g_p, g_f) = jax.value_and_grad(total, argnums=(0, 1),
                                               has_aux=True)(
        params, [jnp.asarray(f) for f in feats])

    port = RoIHeads(num_classes=k, out_channels=c)
    with torch.no_grad():
        for name, m in port.named_modules():
            if isinstance(m, torch.nn.Linear):
                node = _get(params, tuple(name.split(".")))
                m.weight.copy_(torch.from_numpy(np.asarray(node["w"]).T))
                m.bias.copy_(torch.from_numpy(np.asarray(node["b"])))
    fs = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True)
          for f in feats]
    sampled = (torch.from_numpy(props), torch.from_numpy(labels).long(),
               torch.from_numpy(reg), torch.from_numpy(pos),
               torch.from_numpy(on), None)
    got = port.loss(fs, SHAPE, sampled)
    for name in got:
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(want[name]), rtol=1e-5, err_msg=name)
    sum(got.values()).backward()
    for name, p in port.named_parameters():
        ref = np.asarray(_get(g_p, tuple(name.split(".")[:-1]))[
            {"weight": "w", "bias": "b"}[name.split(".")[-1]]])
        ref = ref.T if ref.ndim == 2 else ref
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), name
    for f, ref in zip(fs, g_f):
        ref = np.asarray(ref)
        err = np.abs(f.grad.permute(0, 2, 3, 1).numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max()


@pytest.fixture(scope="module")
def org():
    """(JAX model, params, state, port model) on the same weights.  The
    port model is loaded back from JAX's folded frozen BNs (mean 0,
    variance 1), so its BN ``weight``/``bias`` are JAX's ``scale``/``bias``
    leaves and their gradients compare."""
    pm = build_model(ORG_MODEL)
    init_model(pm, torch.Generator().manual_seed(0))
    params, _ = convert_state_dict(live_norms_(pm, 0).state_dict())
    state = {"backbone": {"body": {}}}
    pm.load_state_dict(state_dict_from_jax(params, state))
    return jax_build_model(ORG_MODEL), params, state, pm


def _images(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(BATCH, *SHAPE, 3).astype(np.float32)
    images[1, 80:] = 0.0  # bucket padding
    sizes = np.array([SHAPE, (80, SHAPE[1])], np.int32)
    return {"images": images, "image_sizes": sizes, "original_sizes": sizes}


def test_bf16_trunk_and_fpn_within_jax_own_bf16_gap(org):
    jm, params, state, pm = org
    images = _images()["images"]
    fpn = jax.jit(lambda x: jm.backbone_features(params, state, x,
                                                 training=False)[1])
    want = fpn(jnp.asarray(images, jnp.bfloat16))
    want32 = fpn(jnp.asarray(images))
    with torch.no_grad():
        _, got = pm.backbone_features(torch.from_numpy(images).bfloat16())
    for level, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g = g.float().permute(0, 2, 3, 1).numpy()
        w = np.asarray(w.astype(jnp.float32))
        gap = np.abs(w - np.asarray(w32)).max()
        assert np.abs(g - w).max() <= 2.0 * gap, f"P{level + 2}"


@pytest.fixture(scope="module")
def steps(org):
    """JAX's step (terms, masked gradients, new params) and the port's
    float32 and float64 steps (terms, gradients, frozen parameters before
    and after), on one batch with JAX's draws."""
    jm, params, state, pm = org
    batch = _images()
    targets = _targets(np.random.RandomState(4))
    key = jax.random.PRNGKey(SEED)
    frozen = frozen_modules(ORG_MODEL)
    sgd, schedule = jax_build_optimizer(ORG_TRAIN["optimizer"],
                                        ORG_TRAIN["scheduler"], 10, 0)
    # the first transformation keeps the (masked) gradients in its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    tx = optax.chain(capture, sgd)
    step = jax_step(jm, tx, frozen, mesh=None, compute_dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    loss, terms, new_params, _, (grads, _) = step(
        jparams, state, tx.init(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()},
        {k: jnp.asarray(v) for k, v in targets.items()}, key)
    jax_out = (float(loss), {k: float(v) for k, v in terms.items()},
               jax.tree_util.tree_map(np.asarray, grads),
               jax.tree_util.tree_map(np.asarray, new_params),
               float(schedule(0)))

    n_anchors = 3 * sum((SHAPE[0] // s) * (SHAPE[1] // s)
                        for s in (4, 8, 16, 32)) + 3 * 2 * 2
    draws = _rng_draws(key, BATCH, n_anchors, 2000 + MAX_GT)
    port = {}
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(pm).to(dtype).train()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        step = make_detection_train_step(
            model, ORG_TRAIN["optimizer"], ORG_TRAIN["scheduler"], 10, 0,
            dtype, draw=_replay(draws))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.backends.mkldnn.flags(enabled=False):
            loss, terms = step(tb, _torch_targets(targets, dtype=dtype))
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.requires_grad}
        after = dict(model.named_parameters())
        port[dtype] = (float(loss), {k: float(v) for k, v in terms.items()},
                       grads, before, after)
    return jax_out, port[torch.float32], port[torch.float64]


def test_step_terms_match_jax(steps):
    (jloss, jterms, _, _, _), (loss, terms, _, _, _), _ = steps
    assert list(terms) == ["loss_classifier", "loss_box_reg",
                           "loss_objectness", "loss_rpn_box_reg"]
    assert set(terms) == set(jterms)
    np.testing.assert_allclose(loss, jloss, rtol=TERM_TOL)
    for k, v in terms.items():
        np.testing.assert_allclose(v, jterms[k], rtol=TERM_TOL, err_msg=k)


def test_step_gradients_match_jax_and_float64(steps):
    (_, _, jgrads, _, _), (_, _, grads, _, _), (_, _, exact, _, _) = steps
    assert len(grads) == 156  # freeze_layers: 33 of 189 leaves frozen
    for name, g in grads.items():
        _, path, layout = jax_leaf(name)
        ref = _get(jgrads, path)
        got = to_jax_layout(g, layout)
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got - ref).max()
        assert err <= GRAD_TOL * scale, f"{name}: {err} vs {GRAD_TOL} x {scale}"
        err = float((g.double() - exact[name]).abs().max())
        assert err <= EXACT_TOL * scale, f"{name} vs float64: {err}"


def test_frozen_leaves_port_unchanged_jax_decayed(steps, org):
    """ROADMAP C7: JAX zeroes the frozen leaves' gradients but its SGD chain
    still adds weight_decay * p, so they shrink by lr * wd * p; in the port
    (and the reference) frozen parameters have no gradient and stay."""
    _, params, _, _ = org
    (_, _, _, new_params, lr), (_, _, grads, before, after), _ = steps
    wd = np.float32(ORG_TRAIN["optimizer"]["params"]["weight_decay"])
    frozen = [n for n in before if n not in grads]
    assert frozen and all(n.startswith(("backbone.body.conv1.",
                                        "backbone.body.bn1.",
                                        "backbone.body.layer1."))
                          for n in frozen)
    for name in frozen:
        assert torch.equal(after[name].detach(), before[name]), name
        _, path, _ = jax_leaf(name)
        p = np.asarray(_get(params, path))
        moved = np.asarray(_get(new_params, path))
        want = p + (wd * p) * np.float32(-lr)
        np.testing.assert_array_equal(moved, want, err_msg=name)
        assert (moved != p).any(), name
    for name in grads:
        assert not torch.equal(after[name].detach(), before[name]), name


def _runner_batches(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = _images(seed + i)
        out.append((b, _targets(rng)))
    return out


def test_coco_runner_trains_in_the_config_dtype():
    model = live_norms_(get_model(ORG_MODEL, seed=1, device="cpu"), 1)
    seen = []
    model.rpn.head.register_forward_hook(
        lambda m, args, out: seen.append(args[0][0].dtype))
    before = model.backbone.body.layer1[0].conv1.weight.detach().clone()
    # no tpu.compute_dtype: bfloat16, the JAX package's default
    config = {"model": ORG_MODEL, "train": dict(ORG_TRAIN, num_epochs=1)}
    assert compute_dtype_from_config(config) == torch.bfloat16
    batches = _runner_batches(10, 2)
    hist = coco_runner.train(model, config, batches, [batches[0][0]], 2)
    assert [s[0] for s in hist["steps"]] == [0, 1]
    for _, loss, terms, ms in hist["steps"]:
        assert np.isfinite(loss) and len(terms) == 4 and ms is None
    assert seen[:2] == [torch.bfloat16, torch.bfloat16]
    assert seen[-1] == torch.float32  # the per-epoch eval
    (rec,) = hist["evals"][0]
    assert rec["dets"]["boxes"].shape == (BATCH, 100, 4)
    assert model.training
    assert torch.equal(model.backbone.body.layer1[0].conv1.weight, before)


def test_coco_runner_stops_on_a_non_finite_loss():
    model = get_model(ORG_MODEL, seed=2, device="cpu")
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.bias.fill_(float("nan"))
    config = {"model": ORG_MODEL, "train": dict(ORG_TRAIN, num_epochs=1),
              "tpu": {"compute_dtype": "float32"}}
    with pytest.raises(FloatingPointError, match="nan"):
        coco_runner.train(model, config, _runner_batches(20, 1), [], 1)


def test_distillation_in_bf16_raises():
    student = get_model(STUDENT_MODEL, seed=0, device="cpu")
    teacher = get_model(ORG_MODEL, seed=1, device="cpu")
    for tpu in ({"compute_dtype": "bfloat16"}, {}):
        config = {"student_model": STUDENT_MODEL, "train": TRAIN, "tpu": tpu}
        with pytest.raises(NotImplementedError, match="A4"):
            distill(teacher, student, config, [], [], 1)


def _dets_equal(a, b):
    return len(a) == len(b) and all(
        x["dets"].keys() == y["dets"].keys()
        and all(np.array_equal(x["dets"][k], y["dets"][k]) for k in x["dets"])
        for x, y in zip(a, b))


def test_distill_eval_round_trips_the_bottleneck_only_when_asked():
    """The per-epoch eval follows JAX's -transform_bottleneck (off by
    default): without the flag it serves the final student without the
    8-bit round trip, with it through the round trip."""
    from hnd_ghnd_tpu.runners.mimic_runner import get_argparser
    assert get_argparser().parse_args(["--config", "x.yaml"]) \
        .transform_bottleneck is False
    teacher = live_norms_(get_model(TEACHER_MODEL, seed=3, device="cpu"), 3)
    student = live_norms_(get_model(STUDENT_MODEL, seed=4, device="cpu"), 4)
    with torch.no_grad():  # spread the class logits past the 0.05 threshold
        student.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    start = copy.deepcopy(student.state_dict())
    config = {"student_model": STUDENT_MODEL,
              "train": dict(TRAIN, num_epochs=1),
              "tpu": {"compute_dtype": "float32"}}
    train = [{"images": _images(30)["images"]}]
    val = [_images(31)]
    evals = {}
    for flag in (None, True):
        student.load_state_dict(start)
        kwargs = {} if flag is None else {"use_bottleneck_transformer": flag}
        hist = distill(teacher, student, config, train, val, 1, **kwargs)
        final = [evaluate(student.eval(), val, use_bottleneck_transformer=t)
                 for t in (False, True)]
        student.train()
        evals[flag] = hist["evals"][0], final
    (default, (plain, round_trip)), (asked, (_, round_trip_t)) = \
        evals[None], evals[True]
    assert not _dets_equal(plain, round_trip)  # the flag is visible
    assert _dets_equal(default, plain)
    assert _dets_equal(asked, round_trip_t)
