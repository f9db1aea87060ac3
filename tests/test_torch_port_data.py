"""The port's config loader, COCO dataset and detection loader against the
JAX package's, on the CPU.

  * ``load_config`` equals JAX's on every YAML under config/, and a
    ``--json`` override merges as in JAX;
  * ``CocoDataset`` items are equal (images, boxes, labels, masks,
    keypoints), with and without ``jpeg_quality``;
  * loader batches (images, image_sizes, original_sizes, padded targets
    with masks_crop and keypoints, and the host targets) are bit-identical
    over two epochs, in train and val, at the keypoint min sizes, in both
    pixel dtypes.

Exact equality everywhere: the port's host modules are copies of the JAX
package's pure-Python path.  This host builds the JAX package's native
prep library, whose libjpeg decode and fused resize give other pixels;
the JAX side is held to its PIL/cv2 path by patching
``native_prep.available`` and ``decode_jpeg`` here (the JAX package is
unchanged)."""
import copy
import glob
import json

import numpy as np
import pytest

from hnd_ghnd_tpu.core import config as jax_config
from hnd_ghnd_tpu.data import coco as jax_coco
from hnd_ghnd_tpu.data import loader as jax_loader
from hnd_ghnd_tpu.data import native_prep
from hnd_ghnd_tpu_torch.core import config as port_config
from hnd_ghnd_tpu_torch.data import coco as port_coco
from hnd_ghnd_tpu_torch.data import loader as port_loader
from hnd_ghnd_tpu_torch.runners.common import keypoint_min_sizes
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

CONFIGS = sorted(glob.glob("config/**/*.yaml", recursive=True))
BUCKETS = ((96, 128), (128, 96))


@pytest.fixture(autouse=True)
def jax_pure_path(monkeypatch):
    """The JAX package's PIL decode and cv2 resize (its pure path)."""
    monkeypatch.setattr(native_prep, "available", lambda: False)
    monkeypatch.setattr(native_prep, "decode_jpeg", lambda data: None)


@pytest.fixture(scope="module")
def kp_fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    return make_coco_fixture(str(root), num_images=7, seed=3, num_classes=1,
                             keypoints=True, size_range=((50, 90), (50, 90)))


def assert_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


def test_all_configs_are_found():
    assert len(CONFIGS) == 31


@pytest.mark.parametrize("path", CONFIGS)
def test_load_config_equals_jax(path):
    assert port_config.load_config(path) == jax_config.load_config(path)


def test_json_override_merges_as_jax():
    path = "config/ghnd/faster_rcnn-backbone_resnet50-b3ch.yaml"
    override = json.dumps({"train": {"num_epochs": 2, "optimizer": {
        "params": {"lr": 0.5}}}, "tpu": {"buckets": [[64, 64]]},
        "new_key": {"a": [1, 2]}})
    a = port_config.overwrite_config(port_config.load_config(path), override)
    b = jax_config.overwrite_config(jax_config.load_config(path), override)
    assert a == b
    assert a["train"]["optimizer"] == {"type": "Adam", "params": {"lr": 0.5}}
    assert a["tpu"]["buckets"] == [[64, 64]]
    assert port_config.overwrite_config(copy.deepcopy(a), None) == a


@pytest.mark.parametrize("jpeg_quality", [None, 40])
def test_coco_dataset_items_equal_jax(kp_fixture, jpeg_quality):
    img_dir, ann = kp_fixture
    kw = dict(remove_non_annotated=True, jpeg_quality=jpeg_quality,
              with_masks=True, with_keypoints=True)
    port = port_coco.CocoDataset(img_dir, ann, **kw)
    ref = jax_coco.CocoDataset(img_dir, ann, **kw)
    assert port.ids == ref.ids and len(port) > 0
    for i in range(len(ref)):
        assert_equal(port[i], ref[i], f"item {i}")


def _loaders(img_dir, ann, training, pixel_dtype, min_sizes):
    out = []
    for coco, loader in ((port_coco, port_loader), (jax_coco, jax_loader)):
        ds = coco.CocoDataset(img_dir, ann, with_masks=True,
                              with_keypoints=True)
        out.append(loader.DetectionLoader(
            ds, 3, training=training, min_sizes=min_sizes, max_size=128,
            buckets=BUCKETS, seed=5, num_workers=2, pixel_dtype=pixel_dtype))
    return out


@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("pixel_dtype", ["float32", "uint8"])
def test_loader_batches_bit_identical_to_jax(kp_fixture, training,
                                             pixel_dtype):
    """Two epochs of (batch, padded targets, host targets), with the
    keypoint task's random min sides in training."""
    img_dir, ann = kp_fixture
    min_sizes = tuple(s // 10 for s in keypoint_min_sizes("keypoint_rcnn",
                                                           training))
    port, ref = _loaders(img_dir, ann, training, pixel_dtype, min_sizes)
    assert len(port) == len(ref)
    seen_sizes = set()
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for (b, t, h), (rb, rt, rh) in zip(got, want):
            assert_equal(b, rb, f"epoch {epoch} batch")
            assert_equal(t, rt, f"epoch {epoch} targets")
            assert_equal(h, rh, f"epoch {epoch} host targets")
            seen_sizes |= {int(min(s)) for s in b["image_sizes"]}
    assert {"masks_crop", "keypoints"} <= set(got[0][1])
    if training:
        assert len(seen_sizes) > 1  # several random min sides were drawn
