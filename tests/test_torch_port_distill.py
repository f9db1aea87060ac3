"""The port's GHND distillation step against the JAX package's, on the CPU.

Full-width ResNet-50 teacher and b3ch student at 192x256, batch 2, float32
(the size of tests/test_distill.py).  The teacher is JAX-initialised and
given live BNs (``live_norms_``), folded back through the JAX converter;
the student is ``live_models(1)`` with its stem and layer2-4 copied from
the teacher, as the reference's pretrained + frozen_modules setup does.
Both sides hold the same weights; the port's frozen BNs carry mean 0 and
variance 1, so their ``weight``/``bias`` are JAX's ``scale``/``bias`` leaves.

  * the schedule equals ``build_schedule`` at the warmup's start and end
    and at each milestone;
  * the updatable names and the parameter count equal JAX's;
  * the criterion equals JAX's (the org term too; more in
    tests/test_torch_port_distill_org.py);
  * one step, with the stem switch off and on (JAX's Pallas stem in
    interpret mode, the port's fused Function on its plain versions):
    loss and terms to 1e-5 relative of the same MSE-sums of JAX's features
    (see ``jax_step``), the new running statistics to 1e-5 (float32 sums
    in another order), and each trainable leaf's gradient to 2e-3 of its
    largest element, and to 5e-4 of it from the port's own float64 step
    (see ``GRAD_TOL``);
  * Adam and SGD fed the same (JAX) gradients for 3 steps across the
    warmup's end: parameters to 1e-6 relative.  Optimizer parity is held
    apart from gradient parity because a first Adam step moves each element
    by +-lr, so a gradient near 0 may flip sign between frameworks;
  * the port's own step leaves frozen leaves bit-identical and moves every
    trainable one.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import STUDENT_MODEL, TEACHER_MODEL, TRAIN, live_norms_
from hnd_ghnd_tpu.distill.box import DistillationBox as JaxBox
from hnd_ghnd_tpu.distill.losses import get_loss as jax_get_loss
from hnd_ghnd_tpu.models.convert import convert_state_dict, torch_path_to_ours
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.factory import init_model as jax_init_model
from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_build_optimizer
from hnd_ghnd_tpu.parallel.mesh import build_schedule as jax_build_schedule
from hnd_ghnd_tpu.utils.params import count_params as jax_count_params
from hnd_ghnd_tpu.utils.params import (apply_grad_mask, trainable_mask,
                                       updatable_param_names as jax_names)
from hnd_ghnd_tpu_torch.distill.box import DistillationBox, _max_stage
from hnd_ghnd_tpu_torch.distill.losses import get_loss
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import build_model
from hnd_ghnd_tpu_torch.parallel.train_step import (build_optimizer,
                                                    build_schedule,
                                                    make_distill_train_step)
from hnd_ghnd_tpu_torch.utils.params import count_params, updatable_param_names
from tests.test_torch_port_weights import live_models
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

BUCKET = (192, 256)
BATCH = 2
FROZEN = STUDENT_MODEL["frozen_modules"]
LOSS_TOL = 1e-5
# The stem's and encoder's gradients reach them through the decoder's six
# train-mode BNs (the first on 3 channels), whose backward cancels.
# Against the same step in float64, JAX's float32 gradients are up to
# 2.9e-4 of their leaf's largest element off with the switch off and
# 1.04e-3 with it on (the interpret-mode Pallas stem); the port's are up to
# 3.6e-4 in both with PyTorch's native CPU convolutions, and up to 6.9e-3
# with oneDNN's, whose convolution backward loses precision here.  So the
# port runs these comparisons without oneDNN, is held to JAX at GRAD_TOL
# (twice JAX's own error) and to its float64 step at EXACT_TOL.
GRAD_TOL = 2e-3
EXACT_TOL = 5e-4
# BN biases followed by an unpadded conv and a train-mode BN have a zero
# gradient (the next BN subtracts the constant they add): both sides give
# float noise there, held below this fraction of the BN weight's gradient
ZERO_GRAD_TOL = 1e-5
ZERO_GRAD = ("backbone.body.layer1.decoder.3.bias",
             "backbone.body.layer1.decoder.8.bias")
STATS_TOL = 1e-5
PARAM_TOL = 1e-6
SHARED = ("conv1", "bn1", "layer2", "layer3", "layer4")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def jax_leaf(name):
    """Port parameter or buffer name -> (JAX tree, path, layout): tree is
    "params" or "state"; layout says how the port's tensor is laid out."""
    prefix, leaf = name.rsplit(".", 1)
    path, kind = torch_path_to_ours(prefix)
    if kind == "conv":
        return "params", path + ({"weight": "w", "bias": "b"}[leaf],), \
            ("oihw" if leaf == "weight" else "flat")
    if kind == "linear":
        return "params", path + ({"weight": "w", "bias": "b"}[leaf],), \
            ("t" if leaf == "weight" else "flat")
    trainable = "encoder" in path or "decoder" in path
    if leaf in ("running_mean", "running_var"):
        return "state", path + (leaf[len("running_"):],), "flat"
    names = {"weight": "gamma", "bias": "beta"} if trainable else \
        {"weight": "scale", "bias": "bias"}
    return "params", path + (names[leaf],), "flat"


def to_jax_layout(t, layout):
    a = t.detach().numpy()
    return {"oihw": lambda: a.transpose(2, 3, 1, 0), "t": lambda: a.T,
            "flat": lambda: a}[layout]()


@pytest.fixture(scope="module")
def weights():
    return distill_weights()


def distill_weights():
    """(JAX teacher, t_params, t_state, JAX student, s_params, s_state)."""
    jt = jax_build_model(TEACHER_MODEL)
    tp, tstate = _np(jax_init_model(jt, 0))
    pt = build_model(TEACHER_MODEL)
    pt.load_state_dict(state_dict_from_jax(tp, tstate))
    live_norms_(pt, 0)
    tp, _ = convert_state_dict(pt.state_dict())
    js, sp, sstate, _ = live_models(1)
    sp = copy.deepcopy(sp)
    for k in SHARED:
        sp["backbone"]["body"][k] = copy.deepcopy(tp["backbone"]["body"][k])
    return jt, tp, tstate, js, sp, _np(sstate)


def port_models(weights):
    _, tp, tstate, _, sp, sstate = weights
    pt = build_model(TEACHER_MODEL)
    pt.load_state_dict(state_dict_from_jax(tp, tstate))
    ps = build_model(STUDENT_MODEL)
    ps.load_state_dict(state_dict_from_jax(sp, sstate))
    return pt.eval(), ps.train()


def _images(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(BATCH, *BUCKET, 3).astype(np.float32)


def jax_step(weights, images):
    """JAX's terms, masked gradients and new state of one step.

    Each term is the MSE-sum of JAX's own teacher and student features,
    summed in float64: XLA's float32 reduction over the ~800K elements of a
    term is itself ~1e-5 off the exact sum (layer2 here: 162669.55 against
    162671.36), more than the port's float32 sum (162671.36)."""
    jt, tp, tstate, js, sp, sstate = weights
    box = JaxBox(jt, js, TRAIN["criterion"])

    def f(p, tp, ts, ss, x):
        return box.loss(tp, ts, p, ss, {"images": x})

    def features(p, tp, ts, ss, x):
        t, _ = box._features(jt, tp, ts, x, training=False)
        s, _ = box._features(js, p, ss, x, training=True)
        return t, s

    # the weights and images are arguments: closed over, XLA would
    # constant-fold the teacher's forward at compile time (~25 s)
    ((_, (_, new_state)), grads), (t, s) = jax.jit(
        lambda *a: (jax.value_and_grad(f, has_aux=True)(*a), features(*a)))(
        sp, tp, tstate, sstate, images)
    grads = apply_grad_mask(grads, trainable_mask(sp, FROZEN))
    terms = {}
    for name, (t_path, s_path) in box.pairs.items():
        d = np.asarray(t[t_path], np.float64) - np.asarray(s[s_path], np.float64)
        terms[name] = float((d * d).sum())
    return sum(terms.values()), terms, _np(grads), _np(new_state)


def port_step(weights, images, dtype=torch.float32):
    pt, ps = port_models(weights)
    pt.to(dtype)
    ps.to(dtype)
    box = DistillationBox(pt, ps, TRAIN["criterion"])
    with torch.backends.mkldnn.flags(enabled=False):
        loss, terms = box.loss(torch.from_numpy(images).to(dtype))
        loss.backward()
    grads = {n: p.grad for n, p in ps.named_parameters() if p.requires_grad}
    return float(loss.detach()), {k: float(v.detach()) for k, v in
                                  terms.items()}, grads, ps


@pytest.fixture(scope="module", params=["switch_off", "switch_on"])
def steps(request, weights):
    images = _images()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HND_TPU_PALLAS_STEM",
                  "1" if request.param == "switch_on" else "0")
        want = jax_step(weights, jnp.asarray(images))
        got = port_step(weights, images)
        exact = port_step(weights, images, torch.float64)[2]
    return got, want, exact


def test_schedule_matches_jax():
    spe, warmup = 100, 99
    sched = TRAIN["scheduler"]
    lr = TRAIN["optimizer"]["params"]["lr"]
    mine = build_schedule(lr, sched, spe, warmup)
    theirs = jax_build_schedule(lr, sched, spe, warmup)
    points = [0, 1, warmup // 2, warmup - 1, warmup, warmup + 1]
    for ms in sched["params"]["milestones"]:
        points += [ms * spe - 1, ms * spe, ms * spe + 1]
    for s in points:
        np.testing.assert_allclose(mine(s), float(theirs(jnp.int32(s))),
                                   rtol=1e-7, err_msg=f"step {s}")
    assert mine(0) == pytest.approx(lr / 1000.0, rel=1e-6)
    assert mine(warmup) == pytest.approx(lr, rel=1e-7)
    assert mine(15 * spe) == pytest.approx(lr * 0.01, rel=1e-6)


def test_updatable_names_and_count_match_jax(weights):
    _, _, _, _, sp, _ = weights
    _, ps = port_models(weights)
    mapped = sorted(".".join(jax_leaf(n)[1]) for n in updatable_param_names(ps))
    assert mapped == jax_names(sp, FROZEN)
    assert "backbone.body.bn1.weight" in updatable_param_names(ps)
    assert count_params(ps) == jax_count_params(sp)


def test_criterion_matches_jax():
    rng = np.random.RandomState(3)
    pairs = {f"layer{i}": (rng.randn(2, 4, 5, 6).astype(np.float32),
                          rng.randn(2, 4, 5, 6).astype(np.float32))
             for i in (1, 2, 3, 4)}
    crit = copy.deepcopy(TRAIN["criterion"])
    crit["terms"]["layer2"]["criterion"] = {"type": "L1Loss",
                                            "params": {"reduction": "mean"}}
    crit["terms"]["layer3"]["criterion"] = {"type": "SmoothL1Loss",
                                            "params": {"reduction": "sum"}}
    crit["terms"]["layer4"]["factor"] = 0.5
    total, terms = get_loss(crit)({k: (torch.from_numpy(a), torch.from_numpy(b))
                                   for k, (a, b) in pairs.items()})
    want_total, want_terms = jax_get_loss(crit)(
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in pairs.items()})
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)
    for k in terms:
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]),
                                   rtol=1e-6)
    assert _max_stage(["backbone.body.layer1"]) == 1
    assert _max_stage(["backbone.body.layer3", "backbone.body.layer2"]) == 3
    # the FPN term reads all four stages, as in JAX (box.py:33-44)
    assert _max_stage(["backbone.fpn"]) == 4
    # org_loss_factor adds factor x the detection losses to the total
    crit["params"]["org_loss_factor"] = 1.0
    org = {"loss_classifier": 0.5, "loss_objectness": 0.25}
    total, _ = get_loss(crit)({k: (torch.from_numpy(a), torch.from_numpy(b))
                               for k, (a, b) in pairs.items()},
                              {k: torch.tensor(v) for k, v in org.items()})
    want_total, _ = jax_get_loss(crit)(
        {k: (jnp.asarray(a), jnp.asarray(b)) for k, (a, b) in pairs.items()},
        {k: jnp.asarray(v) for k, v in org.items()})
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-6)


def test_step_loss_and_terms_match_jax(steps):
    (loss, terms, _, _), (want_loss, want_terms, _, _), _ = steps
    assert set(terms) == {"layer1", "layer2", "layer3", "layer4"}
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL)
    for k, v in terms.items():
        np.testing.assert_allclose(v, want_terms[k], rtol=LOSS_TOL, err_msg=k)


def test_step_gradients_match_jax(steps):
    (_, _, grads, _), (_, _, want, _), exact = steps
    assert len(grads) == 27
    for name, g in grads.items():
        _, path, layout = jax_leaf(name)
        ref = _get(want, path)
        got = to_jax_layout(g, layout)
        if name in ZERO_GRAD:
            _, wpath, _ = jax_leaf(name[:-len("bias")] + "weight")
            bound = ZERO_GRAD_TOL * np.abs(_get(want, wpath)).max()
            assert np.abs(got).max() <= bound and np.abs(ref).max() <= bound
            continue
        scale = np.abs(ref).max()
        assert scale > 0, name
        err = np.abs(got - ref).max()
        assert err <= GRAD_TOL * scale, f"{name}: {err} vs {GRAD_TOL} x {scale}"
        err = float((g - exact[name]).abs().max())
        assert err <= EXACT_TOL * scale, f"{name} vs float64: {err}"


def test_step_running_stats_match_jax(steps):
    (_, _, _, ps), (_, _, _, new_state), _ = steps
    n = 0
    for name, buf in ps.named_buffers():
        if not name.startswith("backbone.body.layer1.") \
                or not name.endswith(("running_mean", "running_var")):
            continue
        _, path, _ = jax_leaf(name)
        ref = _get(new_state, path)
        err = np.abs(buf.numpy() - ref).max()
        assert err <= STATS_TOL * np.abs(ref).max(), name
        n += 1
    assert n == 2 * 8  # the 3 BNs of the encoder and the 5 of the decoder


def _jax_updates(tx, sp, mask, grads, names):
    """JAX's (params, opt_state) after each update, one per gradient
    dict."""
    jp = jax.tree_util.tree_map(jnp.asarray, sp)
    opt_state = tx.init(jp)

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = tx.update(apply_grad_mask(g, mask), opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    out = []
    for g in grads:
        jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
        for n in names:
            _, path, layout = jax_leaf(n)
            _get(jg, path[:-1])[path[-1]] = jnp.asarray(
                to_jax_layout(torch.from_numpy(g[n]), layout))
        jp, opt_state = update(jg, opt_state, jp)
        out.append((jp, opt_state))
    return out


OPTIMIZERS = [TRAIN["optimizer"],
              {"type": "SGD", "params": {"lr": 0.01, "momentum": 0.9,
                                         "weight_decay": 1e-4}}]


@pytest.fixture(scope="module", params=OPTIMIZERS, ids=["adam", "sgd"])
def jax_updates(request, weights):
    """(optimizer, names, gradients, JAX's (params, opt_state) after each
    of three updates with warmup 2: steps 0 and 1 in the warmup, step 2
    after it)."""
    _, _, _, _, sp, _ = weights
    _, ps = port_models(weights)
    names = updatable_param_names(ps)
    params = dict(ps.named_parameters())
    rng = np.random.RandomState(5)
    grads = [{n: rng.randn(*params[n].shape).astype(np.float32) * 1e-2
              for n in names} for _ in range(3)]
    tx, _ = jax_build_optimizer(request.param, TRAIN["scheduler"], 1000, 2)
    return request.param, names, grads, _jax_updates(
        tx, sp, trainable_mask(sp, FROZEN), grads, names)


def _assert_params_match(params, names, jp):
    for n in names:
        _, path, layout = jax_leaf(n)
        ref = np.asarray(_get(jp, path))
        got = to_jax_layout(params[n], layout)
        err = np.abs(got - ref).max()
        assert err <= PARAM_TOL * np.abs(ref).max(), f"{n}: {err}"


def test_optimizer_matches_jax_across_warmup(weights, jax_updates):
    """Three updates with warmup 2, both sides fed the same gradients."""
    optimizer, names, grads, updates = jax_updates
    _, ps = port_models(weights)
    params = dict(ps.named_parameters())
    box = DistillationBox(build_model(TEACHER_MODEL), ps, TRAIN["criterion"])
    step = make_distill_train_step(box, optimizer, TRAIN["scheduler"], 1000, 2)
    for g in grads:
        for n in names:
            params[n].grad = torch.from_numpy(g[n])
        step.apply_update()
    assert step.step == 3
    _assert_params_match(params, names, updates[-1][0])


def test_resume_from_jax_optimizer_state_continues_jax(weights, jax_updates,
                                                       tmp_path):
    """JAX's checkpoint after two updates, with its optax state; the port
    resumes from the file (weights, Adam's moments or SGD's trace, the
    schedule's count) and takes the third update, as JAX takes its third:
    the parameters agree at PARAM_TOL."""
    from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
    from hnd_ghnd_tpu_torch.runners import common
    optimizer, names, grads, updates = jax_updates
    _, ps = port_models(weights)
    params = dict(ps.named_parameters())
    path = str(tmp_path / "jax.pt")
    jp, opt_state = updates[1]
    jax_ckpt.save_ckpt(path, params=jp, state=weights[5],
                       opt_state=opt_state)
    box = DistillationBox(build_model(TEACHER_MODEL), ps, TRAIN["criterion"])
    step = make_distill_train_step(box, optimizer, TRAIN["scheduler"], 1000, 2)
    common.resume(path, ps, step)
    assert step.step == 2
    for n in names:
        params[n].grad = torch.from_numpy(grads[2][n])
    step.apply_update()
    _assert_params_match(params, names, updates[2][0])


def test_jax_optimizer_state_mismatches_raise(weights):
    """Another optimizer type, or a parameter without its state, raises
    and names it; nothing falls back to a fresh state."""
    from hnd_ghnd_tpu_torch.runners import common
    from hnd_ghnd_tpu_torch.utils.ckpt import _Unpickler
    import io
    import pickle
    _, _, _, _, sp, sstate = weights
    _, ps = port_models(weights)
    adam, _ = jax_build_optimizer({"type": "Adam", "params": {"lr": 1e-3}})
    state = _np(adam.init(jax.tree_util.tree_map(jnp.asarray, sp)))

    def stubbed(tree):
        return _Unpickler(io.BytesIO(pickle.dumps(tree))).load()

    trainable = [p for p in ps.parameters() if p.requires_grad]
    sgd = torch.optim.SGD(trainable, lr=0.1, momentum=0.9)
    with pytest.raises(ValueError, match="SGD.*ScaleByAdamState"):
        common.opt_state_from_jax(stubbed(state), sstate, ps, sgd)
    adam_t = torch.optim.Adam(trainable, lr=1e-3)
    del state[0].mu["backbone"]["body"]["layer1"]["encoder"]
    with pytest.raises(ValueError, match="backbone.body.layer1.encoder"):
        common.opt_state_from_jax(stubbed(state), sstate, ps, adam_t)


def test_port_step_freezes_and_moves(weights):
    pt, ps = port_models(weights)
    before = {n: t.clone() for n, t in ps.state_dict().items()}
    box = DistillationBox(pt, ps, TRAIN["criterion"])
    step = make_distill_train_step(box, TRAIN["optimizer"], TRAIN["scheduler"],
                                   10, 9, compute_dtype=torch.float32)
    loss, terms = step({"images": torch.from_numpy(_images())})
    assert torch.isfinite(loss) and set(terms) == set(TRAIN["criterion"]["terms"])
    trainable = set(updatable_param_names(ps))
    for n, p in ps.named_parameters():
        if n in trainable:
            assert not torch.equal(p.detach(), before[n]), n
        else:
            assert torch.equal(p.detach(), before[n]), n
    moved = [n for n in before if n.endswith("running_mean")
             and not torch.equal(ps.state_dict()[n], before[n])]
    assert moved and all(n.startswith("backbone.body.layer1.") for n in moved)


def test_optimizer_config_errors():
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError):
        build_optimizer(p, {"type": "RMSprop", "params": {"lr": 0.1}})
    with pytest.raises(ValueError):
        build_schedule(0.1, {"type": "CosineAnnealingLR", "params": {}}, 1)
