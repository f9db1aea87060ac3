"""The port's serving slice end to end against the JAX package's.

The b3ch student's eval forward with the 8-bit bottleneck round trip, at
full widths, batch 2 at 128x192 (one image padded inside the bucket), uint8
pixels: the JAX ``JitCache.eval_forward`` program against the port's
``runners.common.evaluate``, on the same JAX-initialised weights with live
BNs and residual branches (``live_models``).

Random weights give near-uniform class scores under the 0.05 threshold, so
the class logits are spread (x300, the same on both sides) to make the
thresholds and the per-class NMS select real detections.  Detections whose
scores differ by less than float32 noise may trade places in the output
order, so each JAX detection is matched in the port's set of the same
image: same label, box within 1e-4 of the bucket's size, score within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnd_ghnd_tpu.runners.common import JitCache
from hnd_ghnd_tpu_torch.ops import nms as nms_ops
from hnd_ghnd_tpu_torch.runners.common import eval_forward, evaluate
from tests.test_torch_port_weights import live_models
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

SHAPE = (128, 192)
LOGIT_SPREAD = 300.0
SCORE_TOL = 1e-5
BOX_TOL = 1e-4 * max(SHAPE)


def _batch(seed, shape, sizes):
    rng = np.random.RandomState(seed)
    images = np.zeros((len(sizes),) + shape + (3,), np.uint8)
    for i, (h, w) in enumerate(sizes):
        images[i, :h, :w] = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    sizes = np.asarray(sizes, np.int32)
    return {"images": images, "image_sizes": sizes,
            "original_sizes": np.round(sizes * 1.5).astype(np.int32)}


@pytest.fixture(scope="module")
def models():
    jm, params, state, pm = live_models()
    cls = params["roi_heads"]["box_predictor"]["cls_score"]
    cls["w"] = cls["w"] * np.float32(LOGIT_SPREAD)
    pm.roi_heads.box_predictor.cls_score.weight.mul_(LOGIT_SPREAD)
    return jm, params, state, pm


def test_eval_forward_matches_jax(models):
    jm, params, state, pm = models
    batch = _batch(0, SHAPE, [SHAPE, (100, 150)])
    fwd = JitCache(jm).eval_forward(SHAPE, True)
    want = {k: np.asarray(v) for k, v in fwd(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    (rec,) = evaluate(pm, [batch], use_bottleneck_transformer=True)
    got = rec["dets"]
    assert rec["ms"] > 0
    for k in ("boxes", "boxes_model", "scores", "labels", "valid"):
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 50, "the fixture must select detections"
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


def test_lag1_loop_returns_each_batch_in_order(models):
    pm = models[3]
    batches = [_batch(1, SHAPE, [SHAPE]), _batch(2, SHAPE[::-1], [(150, 100)]),
               _batch(3, SHAPE, [SHAPE, SHAPE])]
    before = nms_ops.fixpoint.iterations
    records = evaluate(pm, batches, use_bottleneck_transformer=True)
    assert nms_ops.fixpoint.iterations > before
    assert len(records) == 3
    for batch, rec in zip(batches, records):
        direct = eval_forward(pm, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, True)
        for k, v in direct.items():
            np.testing.assert_array_equal(rec["dets"][k], v.numpy(), err_msg=k)
