"""Weights and configuration of the port against the JAX package.

``state_dict_from_jax`` is the inverse of the JAX package's
``convert_state_dict``: a JAX-initialised b3ch student crosses to the port
and back bit for bit, with its init's identity BNs and with the live BNs
of ``live_models``.  The config literal of chip_smoke.py is the parsed
YAML, and every schema feature the port does not run raises.

``live_models`` is the pair of models the other port tests compare."""
import copy

import jax
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import STUDENT_MODEL, live_norms_
from hnd_ghnd_tpu.models.convert import convert_state_dict, torch_path_to_ours
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.factory import init_model as jax_init_model
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import build_model, get_model

CONFIG = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"


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
    assert cfg["tpu"]["compute_dtype"] == "float32"


def test_jax_weights_round_trip_exactly(jax_weights):
    params, state = jax_weights
    model = build_model(STUDENT_MODEL)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    back_params, back_state = convert_state_dict(model.state_dict())
    _assert_trees_equal(params, back_params)
    _assert_trees_equal(state, back_state)


def test_every_port_key_is_a_reference_path():
    sd = get_model(STUDENT_MODEL, seed=0).state_dict()
    for key in sd:
        prefix = key.rsplit(".", 1)[0]
        assert torch_path_to_ours(prefix) is not None, key


def test_seeded_init_is_deterministic():
    a = get_model(STUDENT_MODEL, seed=3).state_dict()
    b = get_model(STUDENT_MODEL, seed=3).state_dict()
    c = get_model(STUDENT_MODEL, seed=4).state_dict()
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
    _with(("name",), "mask_rcnn"),
    _with(("name",), "keypoint_rcnn"),
    _with(("backbone", "ext_config"), {"threshold": 0.5}),
    _with(("bottleneck_transformer", "order"),
          ["quantizer", "jpeg_compressor", "jpeg_decompressor", "dequantizer"]),
    _with(("params", "int8_roi_pool"), True),
    _with(("params", "roi_pool_impl"), "xla"),
    _with(("backbone", "params", "layer1"), None),
    _with(("backbone", "name"), "resnet101"),
], ids=["mask", "keypoint", "ext", "jpeg", "int8_pool", "xla_pool",
        "stock_layer1", "resnet101"])
def test_unported_features_raise(cfg):
    with pytest.raises(NotImplementedError):
        build_model(cfg)


def test_training_raises():
    model = build_model(STUDENT_MODEL).train()
    batch = {"images": torch.zeros(1, 64, 64, 3),
             "image_sizes": torch.tensor([[64, 64]]),
             "original_sizes": torch.tensor([[64, 64]])}
    with pytest.raises(NotImplementedError):
        model(batch)
