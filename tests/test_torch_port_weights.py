"""Weights and configuration of the port against the JAX package.

``state_dict_from_jax`` is the inverse of the JAX package's
``convert_state_dict``: a JAX-initialised b3ch student, ResNet-50 teacher
and org Faster R-CNN cross to the port and back bit for bit, with their
init's identity BNs and with the live BNs of ``live_models``.  The config
literals of chip_smoke.py are the parsed YAML, every schema feature the
port does not run raises (and those it ports build, the ext filter and a
JPEG bottleneck chain among them), ``freeze_layers`` freezes the trunk's
conv1, bn1 and layer1, and ``get_model`` builds on the CPU only when
asked.

``live_models`` is the pair of models the other port tests compare."""
import copy

import jax
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import (KEYPOINT_STUDENT_MODEL, MASK_STUDENT_MODEL,
                        ORG_MODEL, ORG_TPU, ORG_TRAIN, STUDENT_MODEL,
                        TEACHER_MODEL, TRAIN, live_norms_)
from hnd_ghnd_tpu.models.convert import convert_state_dict, torch_path_to_ours
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.factory import init_model as jax_init_model
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import (FREEZE_LAYERS, build_model,
                                               get_model)

CONFIG = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"
ORG_CONFIG = "config/org/faster_rcnn-backbone_resnet50.yaml"


def live_models(seed: int = 0):
    """The b3ch student on both sides, with every residual branch live.

    JAX init -> port -> ``live_norms_`` (seeded BN statistics and affines,
    nonzero ``bn3``) -> back to JAX through the JAX package's converter,
    which folds each frozen BN's mean and variance into its scale and bias.
    Returns (JAX model, params, state, port model) holding the same
    weights."""
    jm = jax_build_model(STUDENT_MODEL)
    params, state = jax_init_model(jm, seed)
    pm = build_model(STUDENT_MODEL)
    pm.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params),
        jax.tree_util.tree_map(np.asarray, state)))
    live_norms_(pm, seed)
    params, state = convert_state_dict(pm.state_dict())
    return jm, params, state, pm


@pytest.fixture(scope="module", params=["init", "live"])
def jax_weights(request):
    if request.param == "live":
        return live_models()[1:3]
    params, state = jax_init_model(jax_build_model(STUDENT_MODEL), 0)
    return (jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, state))


@pytest.fixture(scope="module", params=["init", "live"])
def teacher_weights(request):
    params, state = jax_init_model(jax_build_model(TEACHER_MODEL), 0)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    if request.param == "live":
        pm = build_model(TEACHER_MODEL)
        pm.load_state_dict(state_dict_from_jax(params, state))
        params, _ = convert_state_dict(live_norms_(pm, 0).state_dict())
    return params, state


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_config_literal_is_the_yaml():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert cfg["student_model"] == STUDENT_MODEL
    assert cfg["teacher_model"] == TEACHER_MODEL
    assert cfg["train"] == TRAIN
    assert cfg["tpu"]["compute_dtype"] == "float32"


def test_org_config_literal_is_the_yaml():
    with open(ORG_CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert cfg["model"] == ORG_MODEL
    assert cfg["train"] == ORG_TRAIN
    assert cfg["tpu"] == ORG_TPU
    assert cfg["tpu"]["compute_dtype"] == "bfloat16"


def test_org_weights_round_trip_both_ways():
    """JAX -> port -> JAX, and the port's live BNs -> JAX -> port, for the
    whole org model, RPN and RoI heads included."""
    params, state = jax_init_model(jax_build_model(ORG_MODEL), 0)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    model = build_model(ORG_MODEL)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    back_params, _ = convert_state_dict(model.state_dict())
    _assert_trees_equal(params, back_params)
    assert "roi_heads" in back_params and "rpn" in back_params
    sd = live_norms_(model, 0).state_dict()
    again = build_model(ORG_MODEL)
    again.load_state_dict(state_dict_from_jax(*convert_state_dict(sd)),
                          strict=True)
    for k, v in again.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            continue  # folded into weight and bias by the JAX converter
        want = sd[k]
        if k.endswith(".weight") and k[:-len("weight")] + "running_var" in sd:
            prefix = k[:-len("weight")]
            want = (sd[k] * torch.rsqrt(sd[prefix + "running_var"]))
        elif k.endswith(".bias") and k[:-len("bias")] + "running_var" in sd:
            prefix = k[:-len("bias")]
            scale = sd[prefix + "weight"] * torch.rsqrt(sd[prefix + "running_var"])
            want = sd[k] - sd[prefix + "running_mean"] * scale
        torch.testing.assert_close(v, want, rtol=0, atol=1e-6, msg=k)


def test_freeze_layers_freezes_conv1_bn1_layer1():
    model = build_model(ORG_MODEL)
    assert ORG_MODEL["backbone"]["params"]["freeze_layers"]
    for name, p in model.named_parameters():
        frozen = any(name.startswith(f + ".") for f in FREEZE_LAYERS)
        assert p.requires_grad != frozen, name


def test_jax_weights_round_trip_exactly(jax_weights):
    params, state = jax_weights
    model = build_model(STUDENT_MODEL)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    back_params, back_state = convert_state_dict(model.state_dict())
    _assert_trees_equal(params, back_params)
    _assert_trees_equal(state, back_state)


def test_teacher_weights_round_trip_exactly(teacher_weights):
    params, state = teacher_weights
    model = build_model(TEACHER_MODEL)
    assert not model.backbone.body.injected
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    assert "backbone.body.layer1.0.downsample.0.weight" in model.state_dict()
    back_params, _ = convert_state_dict(model.state_dict())
    _assert_trees_equal(params, back_params)


@pytest.mark.parametrize("cfg", [STUDENT_MODEL, TEACHER_MODEL,
                                 MASK_STUDENT_MODEL, KEYPOINT_STUDENT_MODEL],
                         ids=["student", "teacher", "mask", "keypoint"])
def test_every_port_key_is_a_reference_path(cfg):
    sd = get_model(cfg, seed=0, device="cpu").state_dict()
    for key in sd:
        prefix = key.rsplit(".", 1)[0]
        assert torch_path_to_ours(prefix) is not None, key


def test_get_model_runs_on_the_card_unless_asked():
    model = get_model(TEACHER_MODEL, seed=0, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(TEACHER_MODEL, seed=0)


def test_frozen_modules_do_not_train():
    model = build_model(STUDENT_MODEL)
    for name, p in model.named_parameters():
        frozen = any(name.startswith(f + ".")
                     for f in STUDENT_MODEL["frozen_modules"])
        assert p.requires_grad != frozen, name


def test_seeded_init_is_deterministic():
    a = get_model(STUDENT_MODEL, seed=3, device="cpu").state_dict()
    b = get_model(STUDENT_MODEL, seed=3, device="cpu").state_dict()
    c = get_model(STUDENT_MODEL, seed=4, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.body.conv1.weight"],
                           c["backbone.body.conv1.weight"])


def _with(path, value):
    cfg = copy.deepcopy(STUDENT_MODEL)
    node = cfg
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return cfg


@pytest.mark.parametrize("cfg", [
    _with(("params", "roi_pool_impl"), "xla"),
    _with(("backbone", "name"), "resnet101"),
], ids=["xla_pool", "resnet101"])
def test_unported_features_raise(cfg):
    with pytest.raises(NotImplementedError):
        build_model(cfg)


@pytest.mark.parametrize("cfg,kind,head,int8", [
    (_with(("name",), "mask_rcnn"), "mask_rcnn", "mask_predictor", False),
    (_with(("name",), "keypoint_rcnn"), "keypoint_rcnn",
     "keypoint_predictor", False),
    (_with(("params", "int8_roi_pool"), True), "faster_rcnn", None, True),
    (dict(KEYPOINT_STUDENT_MODEL, params=dict(KEYPOINT_STUDENT_MODEL["params"],
                                              kp_decode="device")),
     "keypoint_rcnn", "keypoint_predictor", False),
    (_with(("backbone", "ext_config"), {"threshold": 0.5}), "faster_rcnn",
     None, False),
    (_with(("bottleneck_transformer", "order"),
           ["quantizer", "jpeg_compressor", "jpeg_decompressor",
            "dequantizer"]), "faster_rcnn", None, False),
], ids=["mask", "keypoint", "int8_pool", "kp_decode_device", "ext", "jpeg"])
def test_ported_features_build(cfg, kind, head, int8):
    model = build_model(cfg)
    assert model.kind == kind and model.roi_heads.int8_pool == int8
    chain = model.backbone.body.layer1.host_transformer
    order = cfg["bottleneck_transformer"]["order"]
    assert (chain is not None) == ("jpeg_compressor" in order)
    assert head is None or hasattr(model.roi_heads, head)
    assert model.roi_heads.kp_decode == cfg["params"].get("kp_decode", "host")
    ext = cfg["backbone"].get("ext_config") or {}
    assert model.ext_threshold == ext.get("threshold")
    assert (model.backbone.body.layer1.encoder.ext_classifier is not None) \
        == bool(ext)

