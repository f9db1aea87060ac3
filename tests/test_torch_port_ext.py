"""The port's ext neural filter against the JAX package's, on the CPU.

The model is config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml's
(chip_smoke.EXT_MODEL): the b3ch Keypoint R-CNN student with the filter in
its bottleneck.  JAX draws the weights (its init, with seeded BN statistics
and affines in the filter) and ``state_dict_from_jax`` carries them to the
port, so nothing is re-drawn.  Inputs are numpy-seeded.

  * ``adaptive_avg_pool`` (two products) on overlapping bins, the stem
    output's 208x336 -> 64x64 among them, to rtol 1e-6;
  * the filter through the whole model (after the stem, before the
    encoder): eval probabilities, train logits and the running statistics
    after one train forward, to rtol 1e-5;
  * one ext SGD step against JAX's ``make_ext_train_step``: loss and the
    filter's leaves and statistics to rtol 1e-5; every other leaf
    bit-identical in the port and decayed by lr * wd * p in JAX (ROADMAP
    C7);
  * the gate of tests/test_ext_gating.py: threshold 1.1 masks every image,
    0.0 equals the ungated forward bit for bit, the config's 0.01 and a
    threshold between two images' probabilities mask as JAX's
    probabilities decide;
  * the ext leaves through both maps of models/convert.py, and a
    JAX-written ext checkpoint giving JAX's ``collect_probs``;
  * evals/roc.py against ``sklearn.metrics`` (ties, one class), and the
    threshold table's rows against JAX's ``print_threshold_table``;
  * ``ext_runner.main``: -train for one epoch on a two-class fixture,
    -test_only from the best checkpoint, and a resumed -train.
"""
import contextlib
import copy
import io
import json
import os
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import EXT_MODEL, EXT_TRAIN, ORG_TPU, live_norms_
from hnd_ghnd_tpu.data import native_prep
from hnd_ghnd_tpu.models import layers as JL
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_build_optimizer
from hnd_ghnd_tpu.parallel.mesh import make_mesh
from hnd_ghnd_tpu.runners import ext_runner as jax_ext
from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
from hnd_ghnd_tpu_torch.core.config import load_config
from hnd_ghnd_tpu_torch.evals import roc
from hnd_ghnd_tpu_torch.models import layers as TL
from hnd_ghnd_tpu_torch.models.convert import (jax_params_from_state_dict,
                                               state_dict_from_jax)
from hnd_ghnd_tpu_torch.models.factory import (build_model, get_model,
                                               init_model, load_weights)
from hnd_ghnd_tpu_torch.runners import common, ext_runner
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_runner import port_main, split
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

CONFIG = "config/ext/keypoint_rcnn-backbone_ext_resnet50-b3ch.yaml"
EXT = ("backbone", "body", "layer1", "ext_classifier")
SHAPE = (96, 128)
TOL = 1e-5
TINY_TPU = {"buckets": [[96, 96]], "min_sizes": [64], "max_size": 96,
            "compute_dtype": "bfloat16", "eval_batch_size": 4}


@pytest.fixture(scope="module", autouse=True)
def pure_host_prep():
    """Both packages on their pure host path (PIL decode, cv2 resize),
    the port by the switch they share: the native one is held in
    tests/test_torch_port_native.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HND_TPU_NATIVE_PREP", "0")
        yield


def _model_config(**params):
    """EXT_MODEL without zoo weights or checkpoints."""
    cfg = copy.deepcopy(EXT_MODEL)
    cfg.pop("ckpt")
    cfg["backbone"]["ext_config"].pop("ckpt")
    cfg["params"] = dict(cfg["params"], pretrained=False, **params)
    return cfg


def _close(got, want, tol=TOL, err_msg=""):
    """Within ``tol`` of ``want``, relative to each element or, where an
    element is near 0 (a sum of mixed signs), to the largest."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def weights():
    """(JAX model, params, state) of EXT_MODEL as numpy trees: the filter
    as JAX's init draws it, with seeded BN statistics and affines, the
    rest the port's seeded init with live BNs, carried to JAX by the JAX
    package's converter (JAX's init of the whole model takes ~20 s here)."""
    jm = jax_build_model(_model_config())
    pm = build_model(_model_config())
    init_model(pm, torch.Generator().manual_seed(0))
    params, state = convert_state_dict(live_norms_(pm, 0).state_dict())
    ext_p, ext_s = jm.bottleneck.ext.init(jax.random.PRNGKey(0))
    _get(params, EXT[:-1])[EXT[-1]] = jax.tree_util.tree_map(np.array, ext_p)
    _get(state, EXT[:-1])[EXT[-1]] = jax.tree_util.tree_map(np.array, ext_s)
    rng = np.random.RandomState(1)
    for i in range(3):
        p, s = _get(params, EXT + (f"bn{i}",)), _get(state, EXT + (f"bn{i}",))
        n = p["gamma"].shape[0]
        p["gamma"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        p["beta"] = rng.normal(0, 0.1, n).astype(np.float32)
        s["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        s["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return jm, params, state


def _port(cfg, params, state):
    model = build_model(cfg)
    load_weights(model, params, state)
    return model


def _images(b=2, seed=0):
    return np.random.RandomState(seed).rand(b, *SHAPE, 3).astype(np.float32)


def _jax_batch(images):
    b = images.shape[0]
    return {"images": jnp.asarray(images),
            "image_sizes": jnp.zeros((b, 2), jnp.int32),
            "original_sizes": jnp.zeros((b, 2), jnp.int32)}


def test_ext_model_is_the_yaml_block():
    """chip_smoke.py spells the ext config out (yaml may be missing on the
    GPU host)."""
    config = load_config(CONFIG)
    assert config["model"] == EXT_MODEL
    assert config["train"] == EXT_TRAIN and config["tpu"] == ORG_TPU


@pytest.mark.parametrize("hw,out,dtype", [
    ((208, 336), (64, 64), np.float32),   # the stem output at 832x1344
    ((30, 21), (8, 8), np.float32),
    ((13, 84), (64, 64), np.float32),     # upsampling bins
    ((52, 84), (8, 8), jnp.bfloat16),
], ids=["stem_832x1344", "small", "up", "bf16"])
def test_adaptive_avg_pool_matches_jax(hw, out, dtype):
    x = np.random.RandomState(2).randn(2, *hw, 3).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax.jit(JL.adaptive_avg_pool, static_argnums=1)(
        xj, out).astype(jnp.float32))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).permute(0, 3, 1, 2)
    if dtype != np.float32:
        xt = xt.bfloat16()
    got = TL.adaptive_avg_pool(xt, out).float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    # a bin's mean of mixed signs can cancel to near 0: the error is held
    # against the output's scale there
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_filter_matches_jax_through_the_model(weights):
    """The filter sees the stem's output (not the encoder's): eval
    probabilities, train logits and the running statistics after one train
    forward."""
    jm, params, state = weights
    pm = _port(_model_config(), params, state)
    images = _images()
    probs, _, _ = jm.forward(params, state, _jax_batch(images),
                             training=False, ext_training=True)
    logits, new_state, _ = jm.forward(params, state, _jax_batch(images),
                                      training=True, ext_training=True)
    x = {"images": torch.from_numpy(images)}
    got = pm.eval()(x, ext_training=True)
    _close(got.numpy(), probs)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)
    got = pm.train()(x, ext_training=True).detach()
    _close(got.numpy(), logits)
    ext = pm.backbone.body.layer1.encoder.ext_classifier
    for i, idx in enumerate((2, 5, 8)):
        bn, want = ext.extractor[idx], _get(new_state, EXT + (f"bn{i}",))
        _close(bn.running_mean.numpy(), want["mean"])
        _close(bn.running_var.numpy(), want["var"])


@pytest.fixture(scope="module")
def ext_step(weights):
    """JAX's and the port's ext SGD step on one batch: (JAX loss, params,
    state; port loss, model before and after)."""
    jm, params, state = weights
    images = _images(seed=3)
    labels = np.array([1, 0])
    sgd, _ = jax_build_optimizer(EXT_TRAIN["optimizer"],
                                 EXT_TRAIN["scheduler"], 10)
    step = jax_ext.make_ext_train_step(jm, sgd, make_mesh(jax.devices()[:1]))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    loss, new_params, new_state, _ = step(jp, state, sgd.init(jp),
                                          jnp.asarray(images),
                                          jnp.asarray(labels, jnp.int32))
    jax_out = (float(loss), jax.tree_util.tree_map(np.asarray, new_params),
               jax.tree_util.tree_map(np.asarray, new_state))
    pm = _port(_model_config(), params, state)
    before = copy.deepcopy(pm.state_dict())
    port_step = ext_runner.make_ext_train_step(
        pm.train(), EXT_TRAIN["optimizer"], EXT_TRAIN["scheduler"], 10)
    port_loss = port_step(torch.from_numpy(images), torch.from_numpy(labels))
    return jax_out, (float(port_loss), before, pm.state_dict())


# each filter leaf's SGD update against JAX's, as a fraction of JAX's
# largest: 4.9e-5 at most measured here (float32 gradients through the
# stem); the conv biases are left out, their gradient is 0 before a
# train-mode BN and their update is weight decay at the leaf's rounding
UPDATE_TOL = 1e-4


def test_ext_step_matches_jax(ext_step, weights):
    _, params0, _ = weights
    (jloss, jparams, jstate), (loss, before, after) = ext_step
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    params, state = jax_params_from_state_dict(after)
    moved = 0
    for tree, want_tree in ((params, jparams), (state, jstate)):
        for name, leaf in _get(tree, EXT).items():
            for k, got in leaf.items():
                want = _get(want_tree, EXT + (name, k))
                _close(got, want, err_msg=f"{name}.{k}")
                if tree is params and not (name.startswith("conv")
                                           and k == "b"):
                    old = _get(params0, EXT + (name, k))
                    _close(got - old, want - old, UPDATE_TOL,
                           err_msg=f"update of {name}.{k}")
    for key, value in after.items():
        if key.startswith(ext_runner.EXT_PREFIX) and value.is_floating_point():
            moved += not torch.equal(value, before[key])
    assert moved == 23 - 3  # every filter tensor but num_batches_tracked


def test_frozen_leaves_port_unchanged_jax_decayed(ext_step, weights):
    """ROADMAP C7 in the ext step: JAX's chain decays the masked leaves by
    lr * wd * p; the port's frozen parameters stay bit-identical."""
    _, params, _ = weights
    (_, jparams, _), (_, before, after) = ext_step
    lr = np.float32(EXT_TRAIN["optimizer"]["params"]["lr"])
    wd = np.float32(EXT_TRAIN["optimizer"]["params"]["weight_decay"])
    frozen = [k for k in after if not k.startswith(ext_runner.EXT_PREFIX)]
    assert len(frozen) > 300
    for key in frozen:
        assert torch.equal(after[key], before[key]), key
    checked = 0
    for path in (("backbone", "body", "conv1"), ("backbone", "fpn",
                                                  "layer_blocks", "0"),
                 ("roi_heads", "keypoint_head", "0")):
        for k, p in _get(params, path).items():
            moved = _get(jparams, path + (k,))
            np.testing.assert_array_equal(moved, p + (wd * p) * -lr)
            checked += 1
    assert checked == 5


@pytest.fixture(scope="module")
def gated(weights):
    """The gate on a Faster R-CNN variant of the ext model (the JAX tests'
    model kind; the gate does not depend on the head) at 96x128: the
    ungated detections, JAX's probabilities and a forward per threshold."""
    jm, params, state = weights
    # every head but the keypoint one: load_weights skips its keys
    model = _port(dict(_model_config(), name="faster_rcnn"), params, state)
    images = _images(seed=4)
    probs, _, _ = jm.forward(params, state, _jax_batch(images),
                             training=False, ext_training=True)
    probs = np.asarray(probs)
    sizes = torch.tensor([SHAPE] * 2, dtype=torch.int32)
    batch = {"images": torch.from_numpy(images), "image_sizes": sizes,
             "original_sizes": sizes}
    model.eval()
    model.ext_threshold = None
    ungated = model(batch)
    mid = float(probs[:, 1].mean())
    runs = {}
    for thr in (1.1, 0.0, 0.01, mid):
        model.ext_threshold = thr
        runs[thr] = model(batch)
    return ungated, probs, runs, mid


def test_gate_masks_everything_at_1_1(gated):
    _, _, runs, _ = gated
    dets = runs[1.1]
    assert not dets["valid"].any() and float(dets["scores"].max()) == 0.0
    assert dets["ext_logits"].shape == (2, 2)


def test_gate_at_zero_is_the_ungated_forward(gated):
    ungated, _, runs, _ = gated
    dets = runs[0.0]
    assert "ext_logits" not in ungated and ungated["valid"].any()
    for k, v in ungated.items():
        assert torch.equal(dets[k], v), k


@pytest.mark.parametrize("which", ["config", "between"])
def test_gate_follows_jax_probabilities(gated, which):
    ungated, probs, runs, mid = gated
    thr = 0.01 if which == "config" else mid
    dets = runs[thr]
    _close(dets["ext_logits"].numpy(), probs)
    passed = torch.from_numpy(probs[:, 1] >= thr)
    if which == "between":
        assert passed.tolist() in ([True, False], [False, True])
    assert torch.equal(dets["valid"], ungated["valid"] & passed[:, None])
    assert torch.equal(dets["scores"],
                       ungated["scores"] * passed[:, None].float())
    for k in ("boxes", "labels", "boxes_model"):
        assert torch.equal(dets[k], ungated[k]), k


def test_ext_leaves_round_trip_both_maps(weights):
    _, params, state = weights
    sd = state_dict_from_jax(params, state)
    keys = [k for k in sd if ".ext_classifier." in k]
    assert len(keys) == 23
    assert set(keys) == {k for k in build_model(_model_config()).state_dict()
                         if ".ext_classifier." in k}
    back_p, back_s = jax_params_from_state_dict(sd)
    jp, js = convert_state_dict(sd)   # the JAX package's own map
    for tree, want in ((back_p, params), (back_s, state), (jp, params),
                       (js, state)):
        got = _get(tree, EXT)
        assert set(got) == set(_get(want, EXT))
        for name, leaf in got.items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(
                    v, _get(want, EXT + (name, k)), err_msg=f"{name}.{k}")


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """A two-class keypoint fixture: 16 images, 9 of them annotated."""
    root = tmp_path_factory.mktemp("ext_fx")
    img_dir, ann = make_coco_fixture(str(root / "fx"), num_images=16, seed=3,
                                     num_classes=1, keypoints=True,
                                     empty_prob=0.5)
    with open(ann) as f:
        assert len({a["image_id"] for a in json.load(f)["annotations"]}) == 9
    return root, img_dir, ann


def _config(img_dir, ann, model_cfg):
    return {"dataset": {"name": "fixture", "num_workers": 2, "splits": {
                name: split(img_dir, ann) for name in ("train", "val",
                                                       "test")}},
            "model": model_cfg, "train": dict(EXT_TRAIN, num_epochs=1),
            "test": {"batch_size": 4}, "tpu": TINY_TPU}


def test_jax_written_ckpt_gives_jax_collect_probs(weights, fixture,
                                                   monkeypatch):
    from hnd_ghnd_tpu.runners import common as jax_common
    jm, params, state = weights
    root, img_dir, ann = fixture
    path = str(root / "jax_ext.pt")
    jax_ckpt.save_ckpt(path, params=params, state=state, best_value=0.5)
    cfg = _model_config()
    cfg["backbone"]["ext_config"]["ckpt"] = path
    config = _config(img_dir, ann, cfg)
    monkeypatch.setattr(native_prep, "available", lambda: False)
    monkeypatch.setattr(native_prep, "decode_jpeg", lambda data: None)
    _, _, jax_test = jax_common.loaders_from_config(config, "keypoint_rcnn", 2)
    want, want_labels = jax_ext.collect_probs(jm, params, state, jax_test,
                                              True)
    model = get_model(cfg, seed=5, device="cpu")   # another init: loaded
    _, _, test = common.loaders_from_config(config, "keypoint_rcnn", 2)
    got, labels = ext_runner.collect_probs(model, test, True)
    np.testing.assert_array_equal(labels, want_labels)
    assert labels.sum() == 9 and len(labels) == 16
    _close(got, want)


_ROC_CASES = {
    "ties": (np.random.RandomState(0).randint(0, 2, 200),
             np.round(np.random.RandomState(1).rand(200) * 8) / 8),
    "distinct": (np.random.RandomState(2).randint(0, 2, 50),
                 np.random.RandomState(3).rand(50).astype(np.float32)),
    "separable": (np.array([0, 0, 1, 1, 1]),
                  np.array([0.1, 0.2, 0.7, 0.8, 0.8])),
    "one_class": (np.ones(6, int), np.linspace(0, 1, 6)),
}


@pytest.mark.parametrize("case", sorted(_ROC_CASES))
def test_roc_matches_sklearn(case):
    from sklearn import metrics
    y, s = _ROC_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = metrics.roc_curve(y, s)
        got = roc.roc_curve(y, s)
        want_auc = metrics.roc_auc_score(y, s)
        got_auc = roc.roc_auc_score(y, s)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "one_class":
        assert np.isnan(got_auc) and np.isnan(want_auc)
        with pytest.warns(roc.UndefinedMetricWarning):
            roc.roc_auc_score(y, s)
    else:
        assert got_auc == want_auc


def _table_rows(text):
    return [tuple(float(v) for v in line.split())
            for line in text.splitlines()
            if re.match(r"^\s*(-?[\d.]+|inf|NaN)\s", line)]


@pytest.mark.parametrize("case,min_recall", [("ties", 0.98),
                                             ("distinct", 0.5),
                                             ("separable", 0.98),
                                             ("one_class", 0.98)])
def test_threshold_table_rows_match_jax(case, min_recall):
    y, s = _ROC_CASES[case]
    outs = []
    for fn in (jax_ext.print_threshold_table,
               ext_runner.print_threshold_table):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rows = fn(s, y, min_recall)
        outs.append(buf.getvalue())
    want, printed = _table_rows(outs[0]), _table_rows(outs[1])
    assert want and len(rows) == len(want) == len(printed)
    np.testing.assert_allclose(np.asarray(printed), np.asarray(rows),
                               rtol=0, atol=5e-7)
    np.testing.assert_allclose(np.asarray(rows), np.asarray(want),
                               rtol=1e-5, atol=5e-7)


def _check_logs(root, steps, val, text):
    """``--tb_dir``: train/loss every log_freq steps (step 0 at the
    config's 10000), then val/accuracy, val/recall and val/roc_auc of the
    epoch (JAX's ext_runner.py:217-270); the MetricLogger lines of
    ``log_every``; ``--profile_dir``: a trace of steps 3-6."""
    from hnd_ghnd_tpu_torch.utils.profiling import trace_files
    from hnd_ghnd_tpu_torch.utils.tensorboard import read_scalars
    (events,) = os.listdir(root / "tb")
    log_freq = EXT_TRAIN["log_freq"]
    want = [("train/loss", np.float32(s[1]), s[0]) for s in steps
            if s[0] % log_freq == 0]
    acc, recall, _, auc = val
    want += [("val/accuracy", np.float32(acc), 0),
             ("val/recall", np.float32(recall), 0),
             ("val/roc_auc", np.float32(auc), 0)]
    assert read_scalars(str(root / "tb" / events)) == want
    assert "Epoch: [0] [0/8]" in text and "Epoch: [0] Total time" in text
    (trace,) = trace_files(str(root / "prof"))
    assert os.path.getsize(trace) > 0
    assert "profiler trace of iterations 3-6 written to" in text


def test_ext_runner_trains_resumes_and_tests(fixture):
    root, img_dir, ann = fixture
    cfg = _model_config()
    cfg["backbone"]["ext_config"]["ckpt"] = str(root / "ext.pt")
    path = str(root / "ext.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_config(img_dir, ann, cfg), f)
    argv = ["--config", path, "--device", "cpu"]
    first, text = port_main(ext_runner, argv + [
        "-train", "--tb_dir", str(root / "tb"),
        "--profile_dir", str(root / "prof")])
    steps = first["train"]["steps"]
    assert [s[0] for s in steps] == list(range(8))
    assert all(np.isfinite(s[1]) for s in steps)
    (epoch,) = first["train"]["epochs"]
    auc = epoch["val"][3]
    assert 0 < auc <= 1 and epoch["saved"]
    _check_logs(root, steps, epoch["val"], text)
    payload = jax_ckpt.load_ckpt(str(root / "ext.pt"))
    assert payload["best_value"] == auc and payload["lr_step"] == 8
    assert payload["torch_opt_state"]["state"]
    assert "operating points with recall >= 0.98:" in text
    assert first["test"]["n"] == 16 and first["test"]["table"]
    again, _ = port_main(ext_runner, argv + ["-test_only"])
    assert "train" not in again and again["test"] == first["test"]
    resumed, text = port_main(ext_runner, argv + ["-train"])
    assert f"resumed from {root / 'ext.pt'} (best ROC-AUC {auc:.4f}, " \
           "step 8)" in text
    assert [s[0] for s in resumed["train"]["steps"]] == list(range(8, 16))
