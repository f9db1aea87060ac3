"""The port's native host libraries against the JAX package's, on the CPU.

The port builds native/cocomask/cocomask.cpp and its copy of
native/pipeline/prep.cpp (csrc/prep.cpp) with g++ (``_build.load_host``);
the JAX package loads its tracked build/libcocomask.so and build/libprep.so.
On the same inputs:

  * the fused prep, float32 and uint8 slots, with and without the flip,
    gives the same bytes as JAX's ``native_prep.prep_into``, and its libjpeg
    decode the same pixels as JAX's ``decode_jpeg``;
  * the prep stays within tests/test_native_prep.py's 1.5/255 of the pure
    path (cv2's fixed-point resize), with its padding exactly zero;
  * the loader's native batches equal the JAX loader's native batches,
    bit for bit, and stay within 1.5/255 of the port's pure ones, with the
    same sizes and targets; the loader prints the path it took and why;
  * ``encode``, ``decode``, ``area``, ``iou_matrix`` and ``poly_to_rle``
    give JAX's native results and the port's numpy ones;
  * the native ``coco_match`` gives the numpy matching's result, IoU ties
    and ignored GTs included, and a segm COCOeval the same stats both ways.
"""
import io

import numpy as np
import pytest

from hnd_ghnd_tpu.data import native_prep as jax_prep
from hnd_ghnd_tpu.evals import mask_rle as jax_rle
from hnd_ghnd_tpu_torch import _build
from hnd_ghnd_tpu_torch.data import loader as port_loader
from hnd_ghnd_tpu_torch.data import native_prep
from hnd_ghnd_tpu_torch.data import transforms as T
from hnd_ghnd_tpu_torch.evals import coco_eval, mask_rle
from tests.fixtures import make_coco_fixture

PURE_TOL = 1.5 / 255.0  # tests/test_native_prep.py: float vs cv2's 11 bits


@pytest.fixture(scope="module", autouse=True)
def both_native():
    """Both packages' native paths (the prep switch they share on) and the
    JAX package's libraries present, as they are in this repository."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HND_TPU_NATIVE_PREP", "1")
        assert jax_prep.available() and jax_rle.get_lib() is not None
        assert native_prep.available() and mask_rle.get_lib() is not None
        yield


def _src(h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3),
                                               dtype=np.uint8)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["f32", "u8"])
@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
@pytest.mark.parametrize("shape", [(37, 53, 32, 64), (480, 640, 800, 1333),
                                   (61, 17, 64, 96)],
                         ids=["down", "up", "tall"])
def test_prep_bytes_equal_jax_and_within_pure(shape, flip, dtype):
    h, w, min_size, max_size = shape
    src = _src(h, w, sum(shape))
    nh, nw, _ = T.resize_geometry(h, w, min_size, max_size)
    bucket = (nh + 5, nw + 3)
    got = np.empty(bucket + (3,), dtype)
    want = np.empty(bucket + (3,), dtype)
    native_prep.prep_into(src, nh, nw, flip, got)
    jax_prep.prep_into(src, nh, nw, flip, want)
    assert got.tobytes() == want.tobytes()
    import cv2
    img = src[:, ::-1] if flip else src
    ref = T.pad_to(cv2.resize(np.ascontiguousarray(img), (nw, nh),
                              interpolation=cv2.INTER_LINEAR), bucket)
    ref = ref.astype(np.float32) / (255.0 if dtype == np.float32 else 1.0)
    scale = 1.0 if dtype == np.float32 else 255.0
    np.testing.assert_allclose(got.astype(np.float32), ref,
                               atol=PURE_TOL * scale)
    assert not got[nh:].any() and not got[:, nw:].any()


def test_prep_checks_bounds_before_c():
    src = _src(20, 30, 0)
    with pytest.raises(ValueError):
        native_prep.prep_into(src, 21, 30, False,
                              np.empty((20, 40, 3), np.float32))
    with pytest.raises(ValueError):
        native_prep.prep_into(src, 20, 30, False,
                              np.empty((20, 40, 3), np.float64))


def test_jpeg_decode_equals_jax():
    from PIL import Image
    for seed, quality in ((0, 95), (1, 75)):
        buf = io.BytesIO()
        Image.fromarray(_src(45, 67, seed)).save(buf, format="jpeg",
                                                 quality=quality)
        data = buf.getvalue()
        got = native_prep.decode_jpeg(data)
        assert native_prep.has_jpeg() and got is not None
        np.testing.assert_array_equal(got, jax_prep.decode_jpeg(data))
        pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert got.shape == pil.shape
    assert native_prep.decode_jpeg(b"not a jpeg") is None


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("native")
    return make_coco_fixture(str(root), num_images=6,
                             size_range=((60, 100), (60, 100)))


def _batches(loader):
    out = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        out += [(b, t) for b, t, _ in loader]
    return out


@pytest.mark.parametrize("pixel_dtype", ["float32", "uint8"])
def test_loader_native_batches_equal_jax_and_near_pure(fixture, pixel_dtype,
                                                       capsys, monkeypatch):
    from hnd_ghnd_tpu.data.coco import CocoDataset as JaxDataset
    from hnd_ghnd_tpu.data.loader import DetectionLoader as JaxLoader
    img_dir, ann = fixture
    kw = dict(training=True, min_sizes=(64, 72), max_size=128,
              buckets=((96, 128), (128, 96)), seed=3, num_workers=2,
              pixel_dtype=pixel_dtype)
    monkeypatch.setattr(port_loader, "_logged_path", None)
    port = port_loader.DetectionLoader(
        port_loader.CocoDataset(img_dir, ann), 2, **kw)
    assert port.native
    line = capsys.readouterr().out
    assert "host prep path: native" in line and "libjpeg" in line
    jax = JaxLoader(JaxDataset(img_dir, ann), 2, **kw)
    assert jax._use_native_prep
    got, want = _batches(port), _batches(jax)
    assert len(got) == len(want) > 0
    for (gb, gt), (wb, wt) in zip(got, want):
        for k in wb:
            assert gb[k].tobytes() == wb[k].tobytes(), k
        for k in wt:
            np.testing.assert_array_equal(gt[k], wt[k], err_msg=k)
    monkeypatch.setenv("HND_TPU_NATIVE_PREP", "0")
    pure = port_loader.DetectionLoader(
        port_loader.CocoDataset(img_dir, ann), 2, **kw)
    assert not pure.native
    assert "host prep path: pure (HND_TPU_NATIVE_PREP=0)" in \
        capsys.readouterr().out
    scale = 1.0 if pixel_dtype == "float32" else 255.0
    for (gb, gt), (pb, pt) in zip(got, _batches(pure)):
        np.testing.assert_allclose(gb["images"].astype(np.float32),
                                   pb["images"].astype(np.float32),
                                   atol=PURE_TOL * scale)
        np.testing.assert_array_equal(gb["image_sizes"], pb["image_sizes"])
        np.testing.assert_array_equal(gt["boxes"], pt["boxes"])


def test_loader_logs_the_pure_path_when_the_library_does_not_build(
        monkeypatch, capsys, fixture):
    monkeypatch.setitem(_build._host, "prep", None)
    monkeypatch.setitem(_build.host_info, "prep",
                        {"error": "g++ not found on PATH"})
    monkeypatch.setattr(port_loader, "_logged_path", None)
    loader = port_loader.DetectionLoader(
        port_loader.CocoDataset(*fixture), 2, training=False,
        buckets=((96, 128), (128, 96)), max_size=128, min_sizes=(64,))
    assert not loader.native
    assert "pure (libprep did not build: g++ not found on PATH)" in \
        capsys.readouterr().out
    assert len(list(loader)) > 0


def _masks(rng, n, h, w):
    masks = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.randint(0, h - 2), rng.randint(0, w - 2)
        m[y0:rng.randint(y0 + 1, h + 1), x0:rng.randint(x0 + 1, w + 1)] = 1
        m ^= (rng.rand(h, w) < 0.05).astype(np.uint8)
        masks.append(m)
    return masks


def test_rle_functions_equal_jax_native_and_numpy():
    rng = np.random.RandomState(0)
    h, w = 37, 41
    dets, gts = _masks(rng, 5, h, w), _masks(rng, 4, h, w)
    dets.append(np.ones((h, w), np.uint8))
    dets.append(np.zeros((h, w), np.uint8))
    for m in dets + gts:
        rle = mask_rle.encode(m)
        np.testing.assert_array_equal(rle, jax_rle.encode(m))
        np.testing.assert_array_equal(rle, mask_rle.encode_np(m))
        np.testing.assert_array_equal(mask_rle.decode(rle, h, w), m)
        np.testing.assert_array_equal(mask_rle.decode_np(rle, h, w), m)
        assert mask_rle.area(rle) == mask_rle.area_np(rle) == \
            jax_rle.area(rle) == int(m.sum())
    d_rles = [mask_rle.encode(m) for m in dets]
    g_rles = [mask_rle.encode(m) for m in gts]
    crowd = np.array([0, 1, 0, 1], np.int32)
    got = mask_rle.iou_matrix(d_rles, g_rles, crowd)
    np.testing.assert_array_equal(got, jax_rle.iou_matrix(d_rles, g_rles,
                                                          crowd))
    np.testing.assert_array_equal(got, mask_rle.iou_matrix_np(d_rles, g_rles,
                                                              crowd))
    for poly in ([10.2, 3.7, 30.9, 5.1, 25.4, 33.3, 4.4, 20.0],
                 [0.0, 0.0, 40.9, 0.0, 40.9, 36.9, 0.0, 36.9],
                 [5.0, 5.0, 6.0, 6.0]):
        got = mask_rle.poly_to_rle(poly, h, w)
        np.testing.assert_array_equal(got, jax_rle.poly_to_rle(poly, h, w))
        np.testing.assert_array_equal(got, mask_rle.poly_to_rle_np(poly, h,
                                                                   w))


@pytest.mark.parametrize("seed", range(4))
def test_coco_match_is_the_numpy_matching(seed):
    rng = np.random.RandomState(seed)
    n_d, n_g = rng.randint(1, 12), rng.randint(1, 9)
    # IoUs on a coarse grid: ties between GTs and at the thresholds
    ious = rng.randint(0, 21, (n_d, n_g)) / 20.0
    g_ignore = np.sort(rng.rand(n_g) < 0.3)  # non-ignored first
    thrs = np.linspace(0.5, 0.95, 10)
    got = coco_eval.match_greedy(ious, g_ignore, thrs)
    np.testing.assert_array_equal(
        got, coco_eval.match_greedy_np(ious, g_ignore, thrs))


def test_segm_eval_stats_equal_native_and_numpy(fixture, monkeypatch):
    """A segm COCOeval of perturbed ground truth: the native path's stats
    are the numpy path's."""
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset, ann_to_mask
    img_dir, ann = make_coco_fixture(str(fixture[0]) + "_segm", 4,
                                     seed=5)
    ds = CocoDataset(img_dir, ann, with_masks=True)
    rng = np.random.RandomState(0)
    preds = {}
    for image_id in ds.ids:
        info = ds.images[image_id]
        h, w = info["height"], info["width"]
        masks, boxes, scores, labels = [], [], [], []
        for a in ds.anns_by_img[image_id]:
            m = ann_to_mask(a, h, w)
            m ^= (rng.rand(h, w) < 0.02).astype(np.uint8)
            masks.append(m)
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw, y + bh])
            scores.append(rng.rand())
            labels.append(a["category_id"])
        preds[image_id] = {"masks": np.asarray(masks),
                           "boxes": np.asarray(boxes, np.float32),
                           "scores": np.asarray(scores, np.float32),
                           "labels": np.asarray(labels)}

    def stats():
        ev = coco_eval.CocoEvaluator(ds, ["segm"])
        ev.update(preds)
        ev.accumulate()
        return ev.summarize()["segm"]

    native = stats()
    monkeypatch.setattr(mask_rle, "get_lib", lambda: None)
    np.testing.assert_array_equal(native, stats())
    assert native[0] > 0.3
