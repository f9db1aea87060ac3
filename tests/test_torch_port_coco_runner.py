"""``coco_runner.main -train`` of the port end to end on the CPU: the org
Faster R-CNN (bfloat16, the config's compute dtype) for one epoch of two
batch-2 steps on tests/fixtures.py::make_coco_fixture's own boxes, from a
YAML on disk with ``--device cpu``, its per-epoch val eval and best
checkpoint, then the test eval of the last model (the reference's), and
without ``-train`` the eval of the model's checkpoint.  The org Mask and
Keypoint R-CNN the same way, on the fixture's polygons and keypoints: five
finite loss terms a step, and COCOeval's segm or keypoints stats."""
import numpy as np
import pytest
import yaml

from chip_smoke import ORG_KEYPOINT_MODEL, ORG_MASK_MODEL, ORG_MODEL, ORG_TRAIN
from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
from hnd_ghnd_tpu_torch.runners import coco_runner
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_runner import (EVAL_BATCH, TINY_TPU, port_main,
                                          split)


def test_coco_runner_main_trains_one_epoch(tmp_path):
    img_dir, ann = make_coco_fixture(str(tmp_path / "fx"), num_images=4,
                                     seed=7, num_classes=4)
    ckpt = str(tmp_path / "org.pt")
    model = dict(ORG_MODEL, params={"num_classes": 5, "pretrained": False},
                 ckpt=ckpt)
    config = {"dataset": {"name": "fixture", "num_workers": 2, "splits": {
                  name: split(img_dir, ann) for name in ("train", "val",
                                                         "test")}},
              "model": model,
              "train": dict(ORG_TRAIN, num_epochs=1, log_freq=1),
              "test": {"batch_size": EVAL_BATCH},
              "tpu": dict(TINY_TPU, compute_dtype="bfloat16")}
    path = str(tmp_path / "org.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    result, _ = port_main(coco_runner, ["--config", path, "--device", "cpu",
                                        "-train"])
    steps = result["train"]["steps"]
    assert [s[0] for s in steps] == [0, 1]
    for _, loss, terms, _ in steps:
        assert np.isfinite(loss) and len(terms) == 4
    (epoch,) = result["train"]["epochs"]
    assert len(epoch["stats"]["bbox"]) == 12
    assert epoch["val_map"] == epoch["stats"]["bbox"][0]
    assert len(result["test"]["stats"]["bbox"]) == 12
    assert result["test"]["eval"]["batches"] == 1
    # a checkpoint only when the val mAP rose above 0 (coco_runner.py:152)
    if epoch["saved"]:
        payload = jax_ckpt.load_ckpt(ckpt)
        assert payload["best_value"] == epoch["val_map"] > 0
        again, _ = port_main(coco_runner, ["--config", path, "--device",
                                           "cpu"])
        assert "train" not in again
        assert again["test"]["stats"] == result["test"]["stats"]
    else:
        assert epoch["val_map"] == 0.0


@pytest.mark.parametrize("kind", ["mask_rcnn", "keypoint_rcnn"])
def test_coco_runner_main_trains_mask_and_keypoint(tmp_path, kind):
    keypoints = kind == "keypoint_rcnn"
    img_dir, ann = make_coco_fixture(str(tmp_path / "fx"), num_images=4,
                                     seed=8, num_classes=1 if keypoints else 4,
                                     keypoints=keypoints)
    base, ncls = ((ORG_KEYPOINT_MODEL, 2) if keypoints
                  else (ORG_MASK_MODEL, 5))
    model = dict(base, params=dict(base["params"], num_classes=ncls,
                                   pretrained=False),
                 ckpt=str(tmp_path / "org.pt"))
    config = {"dataset": {"name": "fixture", "num_workers": 2, "splits": {
                  name: split(img_dir, ann) for name in ("train", "val",
                                                         "test")}},
              "model": model,
              "train": dict(ORG_TRAIN, num_epochs=1, log_freq=1),
              "test": {"batch_size": EVAL_BATCH},
              "tpu": dict(TINY_TPU, compute_dtype="bfloat16")}
    path = str(tmp_path / "org.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    result, _ = port_main(coco_runner, ["--config", path, "--device", "cpu",
                                        "-train"])
    steps = result["train"]["steps"]
    extra = "loss_keypoint" if keypoints else "loss_mask"
    assert [s[0] for s in steps] == [0, 1]
    for _, loss, terms, _ in steps:
        assert np.isfinite(loss) and len(terms) == 5 and extra in terms
        assert all(np.isfinite(v) for v in terms.values())
    (epoch,) = result["train"]["epochs"]
    iou = "keypoints" if keypoints else "segm"
    assert set(epoch["stats"]) == set(result["test"]["stats"]) == {"bbox", iou}
    assert len(result["test"]["stats"][iou]) == (10 if keypoints else 12)
    assert all(np.isfinite(v) for v in result["test"]["stats"][iou])
