"""The port's Mask and Keypoint R-CNN eval heads against the JAX package's.

The GHND b3ch Mask and Keypoint R-CNN students of chip_smoke.py (the
``student_model`` blocks of config/ghnd/{mask,keypoint}_rcnn-backbone_
resnet50-b3ch.yaml), JAX-initialised and carried across by
``state_dict_from_jax``: the two heads alone (their transposed convs and
the keypoint head's 2x bilinear resize included), the weights' round trip
back through the JAX package's converter, and the eval forward with the
8-bit bottleneck round trip at a 128x192 bucket, int8 pooling tables off
and on, with live BNs (``live_norms_``).

The forward's detections are matched as in tests/test_torch_port_slice.py:
each JAX detection must be in the port's set of the same image, same label,
box within 1e-4 of the bucket's size, score within 1e-5.  Its mask
probabilities and keypoint logits are then held to the JAX detection's:
both sides run the same float32 operations, cuDNN/oneDNN against XLA's
convolutions, which sum the 2304- and 4608-term products of the heads in
another order (HEAD_TOL, of the largest magnitude).  With the int8 tables
on, both quantize their own FPN maps, which agree to float32 noise: a value
within that noise of a rounding boundary could take the next code on one
side.  The test counts such codes (each one step, at most 1e-4 of them),
then hands the port JAX's tables, as a flipped code moves the x300-spread
class scores past the matching bounds: the port's forward pools them through
its int8 path, quantizing once for all its pooling calls."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml

from chip_smoke import KEYPOINT_STUDENT_MODEL, MASK_STUDENT_MODEL, live_norms_
from hnd_ghnd_tpu.models import roi_heads as jrh
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.factory import init_model as jax_init_model
from hnd_ghnd_tpu.ops.roi_align import quantize_fpn_levels as jax_quantize
from hnd_ghnd_tpu.runners.common import JitCache
from hnd_ghnd_tpu_torch.models import roi_heads as trh
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.factory import build_model
from hnd_ghnd_tpu_torch.ops.roi_align import quantize_fpn_levels
from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
from hnd_ghnd_tpu_torch.runners.common import evaluate
from tests.test_torch_port_slice import _batch
from tests.test_torch_port_weights import _assert_trees_equal

CONFIGS = {"mask": ("config/ghnd/mask_rcnn-backbone_resnet50-b3ch.yaml",
                    MASK_STUDENT_MODEL),
           "keypoint": ("config/ghnd/keypoint_rcnn-backbone_resnet50-b3ch.yaml",
                        KEYPOINT_STUDENT_MODEL)}
SHAPE = (128, 192)
LOGIT_SPREAD = 300.0
SCORE_TOL = 1e-5
BOX_TOL = 1e-4 * max(SHAPE)
HEAD_TOL = 1e-4     # x max |JAX|: summation order of the head convs
# int8 codes of the two sides' FPN maps that differ, of all the codes
MAX_CODE_FLIPS = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_config_literal_is_the_yaml(kind):
    path, literal = CONFIGS[kind]
    with open(path) as f:
        assert yaml.safe_load(f)["student_model"] == literal


def _heads_pair(kind: str, seed: int):
    """JAX RoIHeads params of ``kind`` and the port's RoIHeads on them."""
    cfg = jrh.RoIConfig(num_classes=91 if kind == "mask" else 2,
                        with_mask=kind == "mask",
                        with_keypoint=kind == "keypoint")
    jh = jrh.RoIHeads(cfg)
    params = _np_tree(jh.init(jax.random.PRNGKey(seed)))
    th = trh.RoIHeads(cfg.num_classes, kind=f"{kind}_rcnn")
    sd = state_dict_from_jax({"roi_heads": params}, {})
    th.load_state_dict({k[len("roi_heads."):]: v for k, v in sd.items()},
                       strict=True)
    return jh, params, th.eval()


def _assert_close(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} vs {tol} x {scale}"


@pytest.mark.parametrize("kind", ["mask", "keypoint"])
def test_head_matches_jax(kind):
    jh, params, th = _heads_pair(kind, 3)
    x = np.random.RandomState(4).randn(3, 14, 14, 256).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        if kind == "mask":
            want = jh.mask_head.apply(params["mask_head"], jnp.asarray(x))
            got = th.mask_predictor(th.mask_head(xt))
            assert tuple(got.shape) == (3, 91, 28, 28)
        else:
            want = jh.keypoint_head.apply(params["keypoint_head"],
                                          jnp.asarray(x))
            got = th.keypoint_predictor(th.keypoint_head(xt))
            assert tuple(got.shape) == (3, 17, 56, 56)
    _assert_close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), HEAD_TOL)


def test_transposed_conv_matches_jax():
    """conv5_mask's and kps_score_lowres' geometry and kernel layout."""
    from hnd_ghnd_tpu.models import layers as JL
    from hnd_ghnd_tpu_torch.models.layers import ConvTranspose2d
    rng = np.random.RandomState(5)
    for k, stride, pad in ((2, 2, 0), (4, 2, 1)):
        w = rng.randn(k, k, 6, 5).astype(np.float32)
        b = rng.randn(5).astype(np.float32)
        x = rng.randn(2, 7, 7, 6).astype(np.float32)
        want = np.asarray(JL.conv_transpose2d(
            {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
            stride=stride, padding=pad))
        conv = ConvTranspose2d(6, 5, k, stride=stride, padding=pad)
        sd = state_dict_from_jax({"conv5_mask": {"w": w, "b": b}}, {})
        conv.load_state_dict({"weight": sd["conv5_mask.weight"],
                              "bias": sd["conv5_mask.bias"]})
        with torch.no_grad():
            got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert tuple(got.shape) == (2, 5) + want.shape[1:3]
        _assert_close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)


def test_bilinear_2x_is_jax_image_resize_linear():
    x = np.random.RandomState(6).randn(3, 28, 28, 17).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (3, 56, 56, 17),
                                       method="linear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                        scale_factor=2, mode="bilinear", align_corners=False)
    _assert_close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)


@pytest.fixture(scope="module", params=["mask", "keypoint"])
def family(request):
    """(config, JAX params and state at init, the same with live BNs, the
    port model with live BNs)."""
    cfg = CONFIGS[request.param][1]
    params, state = jax_init_model(jax_build_model(cfg), 0)
    params, state = _np_tree(params), _np_tree(state)
    pm = build_model(cfg)
    pm.load_state_dict(state_dict_from_jax(params, state), strict=True)
    live_norms_(pm, 0)
    if request.param == "mask":
        pm.roi_heads.box_predictor.cls_score.weight.data.mul_(LOGIT_SPREAD)
    live = convert_state_dict(pm.state_dict())
    return cfg, (params, state), live, pm


def test_weights_round_trip_exactly(family):
    cfg, (params, state), _, _ = family
    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    back_params, back_state = convert_state_dict(model.state_dict())
    _assert_trees_equal(params, back_params)
    _assert_trees_equal(state, back_state)
    heads = back_params["roi_heads"]
    assert ("mask_head" in heads) != ("keypoint_head" in heads)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_tables", "int8_tables"])
def test_eval_forward_matches_jax(family, int8, monkeypatch):
    cfg, _, (params, state), pm = family
    cfg = copy.deepcopy(cfg)
    cfg["params"]["int8_roi_pool"] = int8
    jm = jax_build_model(cfg)
    port = build_model(cfg)
    port.load_state_dict(pm.state_dict())
    batch = _batch(0, SHAPE, [SHAPE, (100, 150)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = {k: np.asarray(v) for k, v in JitCache(jm).eval_forward(
        SHAPE, True)(params, state, jb).items()}
    calls = []
    if int8:
        tables = _jax_tables_few_flips(jm, params, state, jb, port, batch)
        monkeypatch.setattr(trh, "quantize_levels",
                            lambda levels: calls.append(1) or tables)
    (rec,) = evaluate(port, [batch], use_bottleneck_transformer=True)
    assert len(calls) == int8  # once per forward, shared by every pooling
    got = rec["dets"]
    head = "mask_probs" if "mask" in cfg["name"] else "keypoint_logits"
    assert set(got) == set(want) and head in got
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 20, "the fixture must select detections"
    scale = float(np.abs(want[head]).max())
    worst = 0.0
    for i in range(2):
        for j in np.flatnonzero(want["valid"][i]):
            same = (got["valid"][i]
                    & (got["labels"][i] == want["labels"][i, j])
                    & (np.abs(got["scores"][i] - want["scores"][i, j])
                       <= SCORE_TOL)
                    & (np.abs(got["boxes_model"][i]
                              - want["boxes_model"][i, j]).max(1) <= BOX_TOL)
                    & (np.abs(got["boxes"][i] - want["boxes"][i, j]).max(1)
                       <= 1.5 * BOX_TOL))
            assert same.any(), f"image {i}: JAX detection {j} not in the port's"
            k = int(np.flatnonzero(same)[0])
            worst = max(worst, float(np.abs(got[head][i, k]
                                            - want[head][i, j]).max()))
    assert worst <= HEAD_TOL * scale, f"{head}: {worst} vs {HEAD_TOL} x {scale}"


def _jax_tables_few_flips(jm, params, state, jb, port, batch):
    """JAX's int8 tables of the batch, as the port's (codes, scales), after
    checking that the port's own, each side from its own FPN maps, differ
    in at most MAX_CODE_FLIPS of the codes, by one step."""
    from hnd_ghnd_tpu.parallel import mesh

    @jax.jit
    def tables_of(params, state, images):
        # jitted, as in the forward: eager FPN maps differ by float noise
        _, jf, _, _ = jm.backbone_features(
            params, state, mesh.images_to_compute(images, jnp.float32),
            training=False, use_bottleneck_transformer=True)
        return jax_quantize(jf[:4])

    jq, js = tables_of(params, state, jb["images"])
    images = images_to_compute(torch.from_numpy(batch["images"]),
                               torch.float32)
    with torch.no_grad():
        _, tf = port.backbone_features(images, True)
    tq, ts = quantize_fpn_levels([f.permute(0, 2, 3, 1) for f in tf[:4]])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    diff = [np.abs(q.numpy().astype(np.int32) - np.asarray(w, np.int32))
            for q, w in zip(tq, jq)]
    flips = sum(int((d > 0).sum()) for d in diff)
    n = sum(d.size for d in diff)
    assert max(int(d.max()) for d in diff) <= 1
    assert flips <= MAX_CODE_FLIPS * n, f"{flips} of {n} codes differ"
    return [torch.from_numpy(np.array(q)) for q in jq], torch.from_numpy(
        np.array(js))
