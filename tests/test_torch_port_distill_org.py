"""The rest of the port's distillation against the JAX package's, on the
CPU (ROADMAP A4): the ``org_loss_factor`` term, the ``backbone.fpn`` term
and the bfloat16 step.

The weights of tests/test_torch_port_distill.py (the full-width ResNet-50
teacher with live BNs and the b3ch student sharing its stem and layer2-4),
batch 2 at 96x128 with a padded second image and 6 GT slots an image, the
size of tests/test_torch_port_detection.py (enough anchors for the 2000
training proposals).  JAX's steps are its jitted
``make_distill_train_step`` (``mesh=None``) with Adam behind a capture
transformation that keeps the masked gradients; the port's samplers replay
JAX's draws (``_rng_draws``).

  * (a) the criterion with ``org_loss_factor`` against JAX's
    ``GeneralizedCustomLoss``, and skipping the term at 0;
  * (b) the ``backbone.fpn`` term against JAX's ``_features`` and
    criterion, with ``reduction`` sum and none (element for element);
  * (c) one float32 step with ``org_loss_factor = 1``: the loss and each
    term (the ``org_`` keys among them), every trainable gradient held to
    JAX and to the port's own float64 step, the bottleneck's running
    statistics against JAX's new state, advanced once;
  * (d) one bfloat16 step without and with the org term against JAX's
    jitted bfloat16 step, within twice JAX's own bfloat16-vs-float32 gap
    (``test_bf16_trunk_and_fpn_within_jax_own_bf16_gap``'s scheme).
"""
import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import TRAIN
from hnd_ghnd_tpu.distill.box import DistillationBox as JaxBox
from hnd_ghnd_tpu.distill.losses import get_loss as jax_get_loss
from hnd_ghnd_tpu.models.roi_heads import RoIHeads as JaxRoIHeads
from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_build_optimizer
from hnd_ghnd_tpu.parallel.mesh import \
    make_distill_train_step as jax_make_step
from hnd_ghnd_tpu_torch.distill.box import DistillationBox, _max_stage
from hnd_ghnd_tpu_torch.distill.losses import get_loss
from hnd_ghnd_tpu_torch.models.roi_heads import RoIHeads
from hnd_ghnd_tpu_torch.parallel.train_step import make_distill_train_step
from tests.test_torch_port_detection import (_images, _replay, _rng_draws,
                                             _targets, _torch_targets)
from tests.test_torch_port_distill import (FROZEN, ZERO_GRAD, _get, _np,
                                           distill_weights, jax_leaf,
                                           port_models, to_jax_layout)
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

SHAPE = (96, 128)
BATCH = 2
MAX_GT = 6
SEED = 7
N_ANCHORS = 3 * sum((SHAPE[0] // s) * (SHAPE[1] // s)
                    for s in (4, 8, 16, 32)) + 3 * 2 * 2
# GHND's four terms with org_loss_factor 1, each term's factor 1e-5: the
# MSE sums here are ~2.5e5 and the detection losses ~6, and at factor 1 the
# feature terms would hide the detection losses' gradients (1e-4 of them)
ORG_CRITERION = copy.deepcopy(TRAIN["criterion"])
ORG_CRITERION["params"]["org_loss_factor"] = 1.0
for _term in ORG_CRITERION["terms"].values():
    _term["factor"] = 1e-5
ORG_TERMS = {"layer1", "layer2", "layer3", "layer4", "org_loss_classifier",
             "org_loss_box_reg", "org_loss_objectness", "org_loss_rpn_box_reg"}
# the loss and terms of the float32 step: against JAX's, whose XLA float32
# sum of a 393K-element MSE term is itself 7.9e-6 off float64 (layer1), as
# tests/test_torch_port_multiprocess.py holds them; against the port's own
# float64 step (on the same RoI samples, the same arithmetic in float32)
LOSS_TOL = 5e-5
EXACT_LOSS_TOL = 1e-5
# gradients, as a fraction of each leaf's largest element: against the
# port's float64 step, JAX's float32 gradients are up to 2.8e-4 off
# (encoder.5), the port's up to 3.2e-4 (encoder.7), both through the
# detection losses (1e-5 without the org term's share); the port is held
# to JAX at twice JAX's own error and to its float64 step at the
# tolerance of tests/test_torch_port_distill.py
GRAD_TOL = 6e-4
EXACT_TOL = 5e-4
ZERO_GRAD_TOL = 1e-5
STATS_TOL = 1e-5
# the backbone.fpn term: a float32 MSE of features that agree to float
# noise; each element of reduction "none" within FPN_TOL of the largest
FPN_TOL = 1e-5
# a bfloat16 term's gap floored at one bfloat16 rounding averaged over the
# batch's positive RoIs (tests/test_torch_port_bf16_step.py)
BF16_ROUNDING = 2.0 ** -9


def fpn_criterion(reduction):
    return {"type": "general", "params": {"org_loss_factor": 0.0},
            "terms": {"fpn": {"ts_modules": ["backbone.fpn"] * 2,
                              "criterion": {"type": "MSELoss", "params": {
                                  "reduction": reduction}},
                              "factor": 1.0}}}


@pytest.fixture(scope="module")
def weights():
    return distill_weights()


def inputs():
    """(batch, targets, key): numpy, and JAX's step key."""
    return (_images(), _targets(np.random.RandomState(4)),
            jax.random.PRNGKey(SEED))


@contextlib.contextmanager
def jax_samples(store=None, given=None):
    """JAX's RoI sampling inside its step: each call's output appended to
    ``store`` (numpy, through a debug callback), or replaced by ``given``
    (floats in the proposals' dtype)."""
    original = JaxRoIHeads.select_training_samples

    def sample(self, proposals, prop_valid, targets, rng):
        if given is not None:
            return tuple(jnp.asarray(a, proposals.dtype)
                         if np.issubdtype(a.dtype, np.floating)
                         or a.dtype == jnp.bfloat16 else jnp.asarray(a)
                         for a in given)
        out = original(self, proposals, prop_valid, targets, rng)
        jax.debug.callback(lambda *xs: store.append(
            tuple(np.asarray(x) for x in xs)), *out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxRoIHeads, "select_training_samples", sample)
        yield


@contextlib.contextmanager
def port_samples(given):
    """The port's RoI sampling replaced by JAX's samples ``given``: floats
    in the proposals' dtype (bfloat16 where JAX's are), labels and GT
    indices as int64.  Top-k, NMS and the sampler are discrete, and float
    noise between two implementations (or two dtypes) of the trunk moves
    near-equal proposals across them."""
    def sample(self, proposals, prop_valid, targets, draw):
        out = []
        for i, a in enumerate(given):
            if a.dtype == jnp.bfloat16:
                t = torch.from_numpy(a.astype(np.float32)).bfloat16()
            elif np.issubdtype(a.dtype, np.floating):
                t = torch.from_numpy(np.array(a)).to(
                    torch.float64 if proposals.dtype == torch.float64
                    else torch.float32)
            else:
                t = torch.from_numpy(np.array(a))
            out.append(t.long() if i in (1, 5) else t)
        return tuple(out)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RoIHeads, "select_training_samples", sample)
        yield


def jax_step(weights, criterion, dtype, given=None):
    """JAX's jitted step: (loss, {term: value}, masked gradients, new
    student state, its RoI samples), as numpy; with ``given``, the RoI
    losses take those samples."""
    jt, tp, tstate, js, sp, sstate = weights
    batch, targets, key = inputs()
    box = JaxBox(jt, js, criterion)
    adam, _ = jax_build_optimizer(TRAIN["optimizer"], None, 10, 0)
    # the first transformation keeps the (masked) gradients in its state
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))
    tx = optax.chain(capture, adam)
    step = jax_make_step(box, tx, FROZEN, mesh=None, compute_dtype=dtype,
                         donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, sp)
    args = [tp, tstate, params, sstate, tx.init(params),
            {k: jnp.asarray(v) for k, v in batch.items()}]
    if box.use_org_loss:
        args.append({k: jnp.asarray(v) for k, v in targets.items()})
    samples = []
    with jax_samples(samples, given):
        loss, terms, _, new_state, (grads, _) = step(*args, key)
        jax.effects_barrier()
    return (float(loss), {k: float(v) for k, v in terms.items()},
            _np(grads), _np(new_state), given or (samples[0] if samples
                                                   else None))


def port_step(weights, criterion, dtype, samples=None):
    """The port's step from the same weights on JAX's draws (and, with the
    org term, JAX's RoI ``samples``): (loss, {term: value}, {name:
    gradient}, the student)."""
    batch, targets, key = inputs()
    pt, ps = port_models(weights)
    if dtype == torch.float64:
        pt.double()
        ps.double()
    box = DistillationBox(pt, ps, criterion)
    draw = (_replay(_rng_draws(key, BATCH, N_ANCHORS, 2000 + MAX_GT))
            if box.use_org_loss else None)
    step = make_distill_train_step(box, TRAIN["optimizer"], None, 10, 0,
                                   compute_dtype=dtype, draw=draw)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tt = _torch_targets(targets, dtype=torch.float64 if dtype == torch.float64
                        else torch.float32)
    with torch.backends.mkldnn.flags(enabled=False), \
            (port_samples(samples) if box.use_org_loss
             else contextlib.nullcontext()):
        loss, terms = step(tb, tt)
    grads = {n: p.grad.detach().double() for n, p in ps.named_parameters()
             if p.requires_grad}
    return (float(loss), {k: float(v) for k, v in terms.items()}, grads, ps)


# ------------------------------------------------------------ (a) criterion

def test_criterion_with_org_loss_matches_jax():
    rng = np.random.RandomState(3)
    pairs = {f"layer{i}": (rng.randn(2, 4, 5, 6).astype(np.float32),
                          rng.randn(2, 4, 5, 6).astype(np.float32))
             for i in (1, 2, 3, 4)}
    org = {k: np.float32(v) for k, v in zip(
        ("loss_classifier", "loss_box_reg", "loss_objectness",
         "loss_rpn_box_reg"), rng.rand(4))}
    for factor in (0.0, 0.5, 2.0):
        crit = copy.deepcopy(TRAIN["criterion"])
        crit["params"]["org_loss_factor"] = factor
        crit["terms"]["layer2"]["factor"] = 0.25
        for given in (org, None, {}):
            ours = get_loss(crit)(
                {k: (torch.from_numpy(a), torch.from_numpy(b))
                 for k, (a, b) in pairs.items()},
                None if given is None else
                {k: torch.tensor(v) for k, v in given.items()})
            theirs = jax_get_loss(crit)(
                {k: (jnp.asarray(a), jnp.asarray(b))
                 for k, (a, b) in pairs.items()},
                None if given is None else
                {k: jnp.asarray(v) for k, v in given.items()})
            np.testing.assert_allclose(float(ours[0]), float(theirs[0]),
                                       rtol=1e-6)
            assert ours[1].keys() == theirs[1].keys() == pairs.keys()
            for k in pairs:
                np.testing.assert_allclose(float(ours[1][k]),
                                           float(theirs[1][k]), rtol=1e-6)
            features = sum(float(v) for v in ours[1].values())
            added = float(ours[0]) - features
            want = factor * sum(float(v) for v in org.values()) \
                if given else 0.0
            # float32 noise of the total aside
            assert added == pytest.approx(want,
                                          abs=1e-6 * abs(float(ours[0])))


# ------------------------------------------------------- (b) backbone.fpn

@pytest.fixture(scope="module")
def jax_fpn(weights):
    """JAX's FPN features of the teacher (eval) and the student (train) on
    the batch, and its criterion of them for each reduction."""
    jt, tp, tstate, js, sp, sstate = weights
    box = JaxBox(jt, js, fpn_criterion("sum"))
    assert box.upto == 4
    images = jnp.asarray(inputs()[0]["images"])
    # the weights are arguments: closed over, XLA would constant-fold them
    t, s = jax.jit(lambda tp, ts, sp, ss, x: (
        box._features(jt, tp, ts, x, training=False)[0],
        box._features(js, sp, ss, x, training=True)[0]))(
        tp, tstate, sp, sstate, images)
    pair = {"fpn": (t["backbone.fpn"], s["backbone.fpn"])}
    out = {r: np.asarray(jax_get_loss(fpn_criterion(r))(pair)[1]["fpn"])
           for r in ("sum", "none")}
    d = (np.asarray(t["backbone.fpn"], np.float64)
         - np.asarray(s["backbone.fpn"], np.float64))
    out["exact"] = float((d * d).sum())
    return out


@pytest.mark.parametrize("reduction", ["sum", "none"])
def test_fpn_term_matches_jax(weights, jax_fpn, reduction):
    """P2-P6 of both models, flattened per image in NHWC order and
    concatenated: the sum against the float64 sum of JAX's own features
    (XLA's float32 sum is itself off it), "none" element for element."""
    pt, ps = port_models(weights)
    box = DistillationBox(pt, ps, fpn_criterion(reduction))
    assert (box.upto, box.needs_fpn) == (4, True)
    with torch.no_grad():
        total, terms = box.loss(torch.from_numpy(inputs()[0]["images"]))
    got = terms["fpn"].numpy()
    want = jax_fpn[reduction]
    assert got.shape == want.shape
    if reduction == "sum":
        np.testing.assert_allclose(float(total), jax_fpn["exact"],
                                   rtol=EXACT_LOSS_TOL)
        return
    cells = sum((SHAPE[0] // s) * (SHAPE[1] // s) for s in (4, 8, 16, 32))
    assert got.shape == (BATCH, 256 * (cells + 2 * 2))   # P2-P5 and P6
    assert np.abs(got - want).max() <= FPN_TOL * np.abs(want).max()


def test_terms_name_trunk_stages_or_the_fpn(weights):
    assert _max_stage(["backbone.body.layer1"]) == 1
    assert _max_stage(["backbone.body.layer3", "backbone.body.layer2"]) == 3
    assert _max_stage(["backbone.body.layer1", "backbone.fpn"]) == 4
    pt, ps = port_models(weights)
    for path in ("backbone.fpn.inner_blocks", "backbone.body.layer5", "rpn"):
        crit = fpn_criterion("sum")
        crit["terms"]["fpn"]["ts_modules"] = [path] * 2
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            DistillationBox(pt, ps, crit)


def test_org_term_needs_targets_and_draw(weights):
    """As JAX asserts (box.py:102-103): the org forward takes the batch's
    targets and draws, and a step without them raises before it runs."""
    pt, ps = port_models(weights)
    box = DistillationBox(pt, ps, ORG_CRITERION)
    batch, targets, key = inputs()
    images = torch.from_numpy(batch["images"])
    sizes = torch.from_numpy(batch["image_sizes"])
    draw = _replay(_rng_draws(key, BATCH, N_ANCHORS, 2000 + MAX_GT))
    for args in ((None, draw, sizes), (_torch_targets(targets), None, sizes),
                 (_torch_targets(targets), draw, None)):
        with pytest.raises(ValueError, match="org_loss_factor"):
            box.loss(images, *args)
    step = make_distill_train_step(box, TRAIN["optimizer"],
                                   compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="org_loss_factor"):
        step({"images": images})


# ------------------------------------------------- (c) the float32 org step

@pytest.fixture(scope="module")
def org_steps(weights):
    """JAX's float32 and bfloat16 org steps and the port's float32,
    float64 and bfloat16 ones, all on the RoIs JAX's float32 step sampled
    (the RPN's draws replayed)."""
    jax32 = jax_step(weights, ORG_CRITERION, jnp.float32)
    samples = jax32[4]
    jax16 = jax_step(weights, ORG_CRITERION, jnp.bfloat16, given=samples)
    ports = {dtype: port_step(weights, ORG_CRITERION, dtype, samples)
             for dtype in (torch.float32, torch.float64, torch.bfloat16)}
    return jax32, jax16, ports, int(samples[3].sum())


def test_org_step_loss_and_terms_match_jax(org_steps):
    (jloss, jterms, *_), _, ports, _ = org_steps
    loss, terms = ports[torch.float32][:2]
    e_loss, e_terms = ports[torch.float64][:2]
    assert set(terms) == set(jterms) == ORG_TERMS
    assert loss == pytest.approx(sum(terms.values()), rel=1e-6)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL)
    np.testing.assert_allclose(loss, e_loss, rtol=EXACT_LOSS_TOL)
    for k, v in terms.items():
        np.testing.assert_allclose(v, jterms[k], rtol=LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(v, e_terms[k], rtol=EXACT_LOSS_TOL,
                                   err_msg=k)


def test_org_step_gradients_match_jax_and_float64(org_steps):
    (_, _, jgrads, *_), _, ports, _ = org_steps
    grads, exact = ports[torch.float32][2], ports[torch.float64][2]
    assert len(grads) == 27
    for name, g in grads.items():
        _, path, layout = jax_leaf(name)
        ref = _get(jgrads, path)
        got = to_jax_layout(g.float(), layout)
        if name in ZERO_GRAD:
            _, wpath, _ = jax_leaf(name[:-len("bias")] + "weight")
            bound = ZERO_GRAD_TOL * np.abs(_get(jgrads, wpath)).max()
            assert np.abs(got).max() <= bound and np.abs(ref).max() <= bound
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got - ref).max()
        assert err <= GRAD_TOL * scale, f"{name}: {err} vs {GRAD_TOL} x {scale}"
        err = float((g - exact[name]).abs().max())
        assert err <= EXACT_TOL * scale, f"{name} vs float64: {err}"


def test_org_step_advances_running_stats_once(org_steps):
    """One trunk pass feeds the feature terms and the detection losses:
    the bottleneck's BNs advance once, to JAX's new state (which keeps the
    feature pass's and drops its org forward's)."""
    (_, _, _, new_state, _), _, ports, _ = org_steps
    ps = ports[torch.float32][3]
    n = 0
    for name, buf in ps.named_buffers():
        if not name.startswith("backbone.body.layer1."):
            continue
        if name.endswith("num_batches_tracked"):
            assert int(buf) == 1, name
            continue
        _, path, _ = jax_leaf(name)
        ref = _get(new_state, path)
        err = np.abs(buf.numpy() - ref).max()
        assert err <= STATS_TOL * np.abs(ref).max(), name
        n += 1
    assert n == 2 * 8


# --------------------------------------------------- (d) the bfloat16 steps

@pytest.fixture(scope="module")
def plain_steps(weights):
    """JAX's bfloat16 and float32 steps without the org term, and the
    port's bfloat16 one."""
    crit = TRAIN["criterion"]
    return (jax_step(weights, crit, jnp.bfloat16),
            jax_step(weights, crit, jnp.float32),
            port_step(weights, crit, torch.bfloat16))


def bf16_within_gap(jax16, jax32, port, n_pos):
    """The port's bfloat16 terms, gradients and running statistics within
    twice JAX's own bfloat16-vs-float32 gap of JAX's bfloat16 ones."""
    _, jterms, jgrads, jstate, _ = jax16
    _, fterms, fgrads, fstate, _ = jax32
    _, terms, grads, ps = port
    assert set(terms) == set(jterms) == set(fterms)
    for k, v in terms.items():
        floor = BF16_ROUNDING * abs(jterms[k]) / np.sqrt(n_pos) if n_pos \
            else 0.0
        gap = max(abs(jterms[k] - fterms[k]), floor)
        assert np.isfinite(v), k
        assert abs(v - jterms[k]) <= 2.0 * gap, (k, v, jterms[k], gap)
    for name, g in grads.items():
        _, path, layout = jax_leaf(name)
        want = _get(jgrads, path)
        gap = np.abs(want - _get(fgrads, path)).max()
        err = np.abs(to_jax_layout(g.float(), layout) - want).max()
        assert gap > 0 and err <= 2.0 * gap, (name, err, gap)
    n = 0
    for name, buf in ps.named_buffers():
        if name.startswith("backbone.body.layer1.") and name.endswith(
                ("running_mean", "running_var")):
            _, path, _ = jax_leaf(name)
            want = _get(jstate, path)
            gap = np.abs(want - _get(fstate, path)).max()
            assert np.abs(buf.numpy() - want).max() <= 2.0 * gap, name
            n += 1
    assert n == 2 * 8


def test_bf16_step_within_jax_own_bf16_gap(plain_steps):
    jax16, jax32, port = plain_steps
    assert set(port[1]) == {"layer1", "layer2", "layer3", "layer4"}
    bf16_within_gap(jax16, jax32, port, 0)


def test_bf16_org_step_within_jax_own_bf16_gap(org_steps):
    jax32, jax16, ports, n_pos = org_steps
    assert set(ports[torch.bfloat16][1]) == ORG_TERMS and n_pos > 0
    bf16_within_gap(jax16, jax32, ports[torch.bfloat16], n_pos)
