"""The threaded host postprocess of the port's ``evaluate`` (JAX's
hnd_ghnd_tpu/runners/common.py:258-287), on the CPU.

A seeded org Keypoint R-CNN (class logits x300, so that its detections pass
the score threshold) serves a keypoint fixture at the tiny buckets of
tests/test_torch_port_runner.py; its forwards are made once and replayed
to every ``evaluate`` (what is tested is the host's work).  With
``HND_TPU_POSTPROC_THREADS=4`` an evaluator with ``keypoints`` receives the
same predictions, bit for bit, as with 1, and the images were finalized on
the pool's threads; an evaluator of ``bbox`` alone finalizes on the
calling thread whatever the variable says."""
import threading

import numpy as np
import pytest
import torch

from chip_smoke import ORG_KEYPOINT_MODEL, live_norms_
from hnd_ghnd_tpu_torch.evals.coco_eval import CocoEvaluator
from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.runners import common
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_runner import split
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

TINY_TPU = {"buckets": [[96, 96]], "min_sizes": [64], "max_size": 96,
            "eval_batch_size": 2}


class Recording(CocoEvaluator):
    """Keeps every prediction ``update`` receives."""

    def __init__(self, *args):
        super().__init__(*args)
        self.seen = {}

    def update(self, predictions):
        self.seen.update(predictions)
        super().update(predictions)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("postproc")
    img_dir, ann = make_coco_fixture(str(root / "fx"), num_images=2, seed=2,
                                     num_classes=1, keypoints=True)
    config = {"dataset": {"name": "fixture", "num_workers": 2, "splits": {
                  name: split(img_dir, ann) for name in ("train", "val",
                                                         "test")}},
              "test": {"batch_size": 2}, "tpu": TINY_TPU}
    cfg = dict(ORG_KEYPOINT_MODEL, ckpt=None,
               params=dict(ORG_KEYPOINT_MODEL["params"], pretrained=False))
    model = live_norms_(get_model(cfg, seed=0, device="cpu"), 0).eval()
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    _, _, test = common.loaders_from_config(config, model.kind, 2)
    records = common.evaluate(model, [b for b, _, _ in test])
    return model, test, [r["dets"] for r in records]


def _run(served, iou_types, threads, monkeypatch):
    model, loader, dets = served
    monkeypatch.setenv("HND_TPU_POSTPROC_THREADS", str(threads))
    forwards = iter(dets)
    monkeypatch.setattr(common, "eval_forward", lambda *args: {
        k: torch.from_numpy(v) for k, v in next(forwards).items()})
    names = set()

    def recorded(*args, **kwargs):
        names.add(threading.current_thread().name)
        return finalize_predictions(*args, **kwargs)

    monkeypatch.setattr(common, "finalize_predictions", recorded)
    evaluator = Recording(loader.dataset, iou_types)
    common.evaluate(model, loader, evaluator=evaluator)
    return evaluator.seen, names


@pytest.mark.parametrize("iou_types", [["bbox", "keypoints"], ["bbox"]],
                         ids=["keypoints", "bbox"])
def test_threads_give_identical_predictions(served, iou_types, monkeypatch):
    one, one_names = _run(served, iou_types, 1, monkeypatch)
    many, many_names = _run(served, iou_types, 4, monkeypatch)
    main = threading.current_thread().name
    assert one_names == {main}
    if "keypoints" in iou_types:
        assert main not in many_names and len(many_names) >= 1
    else:
        assert many_names == {main}
    assert sorted(one) == sorted(many) == [1, 2]
    n_dets = 0
    for image_id, pred in one.items():
        assert set(pred) == set(many[image_id])
        for k, v in pred.items():
            np.testing.assert_array_equal(many[image_id][k], v,
                                          err_msg=f"{image_id} {k}")
        n_dets += len(pred["scores"])
        if "keypoints" in iou_types:
            assert pred["keypoints"].shape == (len(pred["scores"]), 17, 3)
    assert n_dets > 0
