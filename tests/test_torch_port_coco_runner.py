"""``coco_runner.main -train`` of the port end to end on the CPU: the org
Faster R-CNN (bfloat16, the config's compute dtype) for one epoch of two
batch-2 steps on tests/fixtures.py::make_coco_fixture's own boxes, from a
YAML on disk with ``--device cpu``, its per-epoch val eval and best
checkpoint, then the test eval of the last model (the reference's), and
without ``-train`` the eval of the model's checkpoint."""
import numpy as np
import yaml

from chip_smoke import ORG_MODEL, ORG_TRAIN
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
