"""The port's COCO evaluation against the JAX package's, on the CPU.

  * ``mask_rle`` (numpy only) equals the JAX package's (its native
    cocomask library on this host) on random masks and polygons;
  * ``finalize_predictions`` output is equal, with masks pasted and
    keypoints decoded (on the host, or after the device decode, whose
    ``cubic_resize_matrix`` and ``device_keypoint_argmax`` equal JAX's);
  * ``CocoEvaluator``'s stats for bbox, segm and keypoints are exactly
    JAX's on the same predictions, made by jittering the fixture's ground
    truth (and adding false positives) so that each mAP lies strictly
    between 0 and 1.

tests/test_torch_port_runner.py holds ``mimic_runner.main`` (``-distill``
and ``-test_only``) to the JAX package's.
"""
import numpy as np
import pytest

from hnd_ghnd_tpu.data.coco import CocoDataset as JaxDataset
from hnd_ghnd_tpu.evals import coco_eval as jax_eval
from hnd_ghnd_tpu.evals import mask_rle as jax_rle
from hnd_ghnd_tpu.evals import postprocess as jax_post
from hnd_ghnd_tpu.ops import kp_decode as jax_kp
from hnd_ghnd_tpu_torch.data.coco import CocoDataset
from hnd_ghnd_tpu_torch.evals import coco_eval, mask_rle
from hnd_ghnd_tpu_torch.evals import postprocess
from hnd_ghnd_tpu_torch.ops import kp_decode
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401


@pytest.mark.parametrize("seed", range(4))
def test_mask_rle_equals_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(5, 70, 2)
    masks = [(rng.rand(h, w) < rng.rand()).astype(np.uint8) for _ in range(6)]
    masks[0][:] = 1  # a mask that starts with a one-run
    for m in masks:
        counts = mask_rle.encode(m)
        np.testing.assert_array_equal(counts, jax_rle.encode(m))
        np.testing.assert_array_equal(mask_rle.decode(counts, h, w), m)
        assert mask_rle.area(counts) == jax_rle.area(counts) == m.sum()
    rles = [mask_rle.encode(m) for m in masks]
    crowd = np.array([0, 1, 0])
    np.testing.assert_array_equal(mask_rle.iou_matrix(rles[:3], rles[3:], crowd),
                                  jax_rle.iou_matrix(rles[:3], rles[3:], crowd))
    for _ in range(5):
        poly = list(rng.uniform(-4, max(h, w) + 4, 2 * rng.randint(3, 10)))
        np.testing.assert_array_equal(mask_rle.poly_to_rle(poly, h, w),
                                      jax_rle.poly_to_rle(poly, h, w))


def fake_dets(rng, b=3, d=6, k=17, m=28, s=56):
    """Device-shaped detections with masks and keypoint heatmaps."""
    boxes = np.sort(rng.uniform(0, 90, (b, d, 4)).reshape(b, d, 2, 2),
                    axis=2).transpose(0, 1, 3, 2).reshape(b, d, 4)
    boxes = boxes[..., [0, 2, 1, 3]].astype(np.float32)
    return {"boxes": boxes * 1.3, "boxes_model": boxes,
            "scores": rng.rand(b, d).astype(np.float32),
            "labels": rng.randint(1, 5, (b, d)).astype(np.int64),
            "valid": rng.rand(b, d) > 0.3,
            "mask_probs": rng.rand(b, d, m, m).astype(np.float32),
            "keypoint_logits": rng.randn(b, d, s, s, k).astype(np.float32)}


def test_finalize_predictions_equals_jax():
    rng = np.random.RandomState(0)
    dets = fake_dets(rng)
    for i in range(3):
        got = postprocess.finalize_predictions(dets, i, (117, 130), (90, 100))
        want = jax_post.finalize_predictions(dets, i, (117, 130), (90, 100))
        assert set(got) == set(want) == {"boxes", "scores", "labels", "masks",
                                         "keypoints", "keypoints_scores"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["masks"].shape[1:] == (117, 130)


@pytest.mark.parametrize("src,dst", [(56, 112), (56, 224), (7, 3)])
def test_cubic_resize_matrix_equals_jax(src, dst):
    got = kp_decode.cubic_resize_matrix(src, dst)
    assert got.dtype == np.float32 and got.shape == (dst, src)
    np.testing.assert_array_equal(got, jax_kp.cubic_resize_matrix(src, dst))


def test_device_keypoint_decode_equals_jax():
    """``device_keypoint_argmax`` at grid 112 and the host's
    ``keypoints_from_device_argmax`` on its output: the argmax positions
    equal JAX's, the scores within float32 rounding, the keypoints equal;
    ``finalize_predictions`` of the device outputs equals JAX's."""
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(1)
    b, d, s, k = 2, 5, 56, 17
    logits = rng.randn(b, d, s, s, k).astype(np.float32)
    # one clear peak per heatmap, as a trained head gives
    for i, j, kk in np.ndindex(b, d, k):
        y, x = rng.randint(0, s, 2)
        logits[i, j, y, x, kk] += 8.0
    want = jax_kp.device_keypoint_argmax(jnp.asarray(logits), grid=112)
    got = kp_decode.device_keypoint_argmax(torch.from_numpy(logits), 112)
    for name, g, w in zip(("u", "v"), got[:2], want[:2]):
        assert g.shape == (b, d, k) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    dets = fake_dets(rng, b=b, d=d)
    del dets["keypoint_logits"]
    dets.update(kp_u=got[0].numpy(), kp_v=got[1].numpy(),
                kp_score=np.asarray(want[2]))
    for i in range(b):
        args = (dets["kp_u"][i], dets["kp_v"][i], dets["kp_score"][i],
                dets["boxes_model"][i], (1.3, 1.2))
        for g, w in zip(kp_decode.keypoints_from_device_argmax(*args),
                        jax_kp.keypoints_from_device_argmax(*args)):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        got_p = postprocess.finalize_predictions(dets, i, (117, 130),
                                                 (90, 100))
        want_p = jax_post.finalize_predictions(dets, i, (117, 130), (90, 100))
        assert set(got_p) == set(want_p) and "keypoints" in got_p
        for key in want_p:
            np.testing.assert_array_equal(got_p[key], want_p[key],
                                          err_msg=key)


def jittered_predictions(dataset, rng, with_masks, with_keypoints):
    """Per image: each ground-truth box moved by up to 15% of its size, its
    label kept 80% of the time, a random score, and two false positives;
    masks are the boxes' rectangles, keypoints the truth plus noise."""
    preds = {}
    for image_id in dataset.ids:
        info = dataset.images[image_id]
        h, w = info["height"], info["width"]
        boxes, labels = [], []
        for ann in dataset.anns_by_img[image_id]:
            x, y, bw, bh = ann["bbox"]
            j = rng.uniform(-0.15, 0.15, 4) * [bw, bh, bw, bh]
            boxes.append([x + j[0], y + j[1], x + bw + j[2], y + bh + j[3]])
            labels.append(ann["category_id"] if rng.rand() < 0.8
                          else rng.randint(1, 4))
        for _ in range(2):
            x, y = rng.uniform(0, w - 10), rng.uniform(0, h - 10)
            boxes.append([x, y, x + rng.uniform(5, 30), y + rng.uniform(5, 30)])
            labels.append(rng.randint(1, 4))
        boxes = np.clip(np.asarray(boxes, np.float32), 0, [w, h, w, h])
        pred = {"boxes": boxes, "scores": rng.rand(len(boxes)).astype(np.float32),
                "labels": np.asarray(labels, np.int64)}
        if with_masks:
            masks = np.zeros((len(boxes), h, w), np.uint8)
            for n, (x1, y1, x2, y2) in enumerate(boxes.astype(int)):
                masks[n, y1:y2, x1:x2] = 1
            pred["masks"] = masks
        if with_keypoints:
            kps = []
            for ann in dataset.anns_by_img[image_id]:
                kp = np.asarray(ann["keypoints"], np.float32).reshape(17, 3)
                kp[:, :2] += rng.normal(0, 2.0, (17, 2))
                kps.append(kp)
            while len(kps) < len(boxes):
                kps.append(np.concatenate([rng.uniform(0, min(h, w), (17, 2)),
                                           np.ones((17, 1))], 1))
            pred["keypoints"] = np.asarray(kps, np.float32)
        preds[image_id] = pred
    return preds


@pytest.mark.parametrize("iou_types,keypoints", [
    (("bbox", "segm"), False), (("bbox", "keypoints"), True)],
    ids=["bbox_segm", "keypoints"])
def test_coco_evaluator_stats_equal_jax(tmp_path, iou_types, keypoints):
    img_dir, ann = make_coco_fixture(
        str(tmp_path), num_images=10, seed=11, keypoints=keypoints,
        num_classes=1 if keypoints else 3)
    port = coco_eval.CocoEvaluator(CocoDataset(img_dir, ann), iou_types)
    ref = jax_eval.CocoEvaluator(JaxDataset(img_dir, ann), iou_types)
    preds = jittered_predictions(port.dataset, np.random.RandomState(2),
                                 "segm" in iou_types, keypoints)
    ids = sorted(preds)
    for ev in (port, ref):
        # two updates, as the eval loop feeds one batch at a time
        ev.update({i: preds[i] for i in ids[:4]})
        ev.update({i: preds[i] for i in ids[4:]})
        ev.synchronize_between_processes()
        ev.accumulate()
        ev.summarize()
    for t in iou_types:
        np.testing.assert_array_equal(port.stats[t], ref.stats[t], err_msg=t)
        assert len(port.stats[t]) == (10 if t == "keypoints" else 12)
        assert 0.0 < port.stats[t][0] < 1.0, (t, port.stats[t][0])
