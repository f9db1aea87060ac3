"""The port runs on torch and numpy alone, and chip_smoke.py refuses to run
without a GPU or without the package beside it.

Each check runs in a fresh interpreter: the serving, distill,
supervised-training, heads, ext and split slices are imported, built and
run once on a tiny input (one distill epoch of one step, one coco_runner
epoch of one bfloat16 step, each with its eval, the eval of the Mask and
Keypoint R-CNN students with int8 pooling tables, the gated ext model's
eval and one ext step, a split head -> bytes -> tail with the DataLogger,
and the int8 server tail on the same wire; the kernels' custom ops and the
export module imported), then jax, the JAX package, PIL, cv2, yaml, sklearn and pandas
must be absent from ``sys.modules`` (they are not promised on the GPU
host).  The host modules of the runners (config, data, evals with the ROC
metrics, checkpoints, logging, the cost analyzer and the visualizer with
its drawing and the JPEG codec) import none of them either: PIL, cv2 and
yaml are imported by the functions that decode, resize, draw and load a
config."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SLICE = r"""
import sys
import numpy as np
import torch
import hnd_ghnd_tpu_torch
import hnd_ghnd_tpu_torch._build
from hnd_ghnd_tpu_torch.codec import datalogger, jpeg, quantizer
from hnd_ghnd_tpu_torch.models import (bottleneck, convert, ext, factory,
    fpn, layers, rcnn, resnet, roi_heads, rpn)
from hnd_ghnd_tpu_torch.ops import (anchors, boxes, int8_conv, library, nms,
    quant_kernels, roi_align, roi_align_kernels, stem, stem_kernels)
from hnd_ghnd_tpu_torch.distill import box, losses
from hnd_ghnd_tpu_torch.parallel import train_step
from hnd_ghnd_tpu_torch.runners import (coco_runner, common, cost_analyzer,
    ext_runner, mimic_runner, visualizer)
from hnd_ghnd_tpu_torch.split import deploy, export, int8
from hnd_ghnd_tpu_torch.utils import ckpt, logging, params, visual_util
from hnd_ghnd_tpu_torch.core import config
from hnd_ghnd_tpu_torch.data import coco, loader, transforms
from hnd_ghnd_tpu_torch.evals import coco_eval, mask_rle, postprocess, roc
from chip_smoke import (EXT_MODEL, KEYPOINT_STUDENT_MODEL, MASK_STUDENT_MODEL,
    ORG_MODEL, ORG_TRAIN, STUDENT_MODEL, TEACHER_MODEL, TRAIN)
model = factory.get_model(STUDENT_MODEL, seed=0, device="cpu")
batch = {"images": np.zeros((1, 64, 64, 3), np.uint8),
         "image_sizes": np.array([[64, 64]], np.int32),
         "original_sizes": np.array([[64, 64]], np.int32)}
(rec,) = common.evaluate(model, [batch], use_bottleneck_transformer=True)
assert rec["dets"]["boxes"].shape == (1, 100, 4)
split = deploy.SplitRCNN(model, 8)
head, tail, _ = split.build()
wire = split.run_edge(head, batch["images"], batch["image_sizes"],
                      batch["original_sizes"])
dets = split.run_server(tail, wire, (64, 64))
assert np.array_equal(dets["boxes"], rec["dets"]["boxes"])
int8_tail = int8.Int8SplitTail(model, int8.calibrate_from_images(
    model, [batch["images"]])).build()
assert split.run_server(int8_tail, wire, (64, 64))["boxes"].shape == (1, 100, 4)
z, _, _, _ = deploy.SplitRCNN(model, None).build()[0](batch["images"])
assert datalogger.DataLogger(8)(z)[0].shape == (1, 20, 20, 3)
teacher = factory.get_model(TEACHER_MODEL, seed=1, device="cpu")
config = {"student_model": STUDENT_MODEL, "train": dict(TRAIN, num_epochs=1),
          "tpu": {"compute_dtype": "float32"}}
hist = mimic_runner.distill(teacher, model, config, [batch], [batch], 1)
assert len(hist["steps"]) == 1 and len(hist["evals"]) == 1
org = factory.get_model(ORG_MODEL, seed=2, device="cpu")
targets = {"boxes": np.array([[[4, 4, 40, 40]]], np.float32),
           "labels": np.array([[3]], np.int64),
           "boxes_valid": np.array([[True]])}
hist = coco_runner.train(org, {"model": ORG_MODEL,
                               "train": dict(ORG_TRAIN, num_epochs=1)},
                         [(batch, targets)], [batch], 1)
assert len(hist["steps"]) == 1 and len(hist["evals"]) == 1
for cfg, head in ((MASK_STUDENT_MODEL, "mask_probs"),
                  (KEYPOINT_STUDENT_MODEL, "keypoint_logits")):
    cfg = dict(cfg, params=dict(cfg["params"], int8_roi_pool=True))
    m = factory.get_model(cfg, seed=3, device="cpu")
    (rec,) = common.evaluate(m, [batch], use_bottleneck_transformer=True)
    assert rec["dets"][head].shape[:2] == (1, 100)
gated = factory.get_model(dict(EXT_MODEL, ckpt=None, backbone=dict(
    EXT_MODEL["backbone"], ext_config={"threshold": 0.01})), seed=4,
    device="cpu")
(rec,) = common.evaluate(gated, [batch], use_bottleneck_transformer=True)
assert rec["dets"]["ext_logits"].shape == (1, 2)
step = ext_runner.make_ext_train_step(gated.train(), {"type": "SGD",
    "params": {"lr": 0.001, "momentum": 0.9, "weight_decay": 1e-4}})
step(torch.zeros(2, 64, 64, 3), torch.tensor([0, 1]))
assert roc.roc_auc_score([0, 1, 1], [0.2, 0.4, 0.9]) == 1.0
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "hnd_ghnd_tpu", "PIL",
                                 "cv2", "yaml", "sklearn", "pandas")]
assert not banned, banned
print("clean")
"""


HOST = r"""
import sys
from hnd_ghnd_tpu_torch.core import config
from hnd_ghnd_tpu_torch.data import coco, loader, transforms
from hnd_ghnd_tpu_torch.evals import coco_eval, mask_rle, postprocess, roc
from hnd_ghnd_tpu_torch.utils import ckpt, logging
from hnd_ghnd_tpu_torch.runners import (coco_runner, common, cost_analyzer,
    ext_runner, mimic_runner, visualizer)
from hnd_ghnd_tpu_torch.codec import datalogger, jpeg
from hnd_ghnd_tpu_torch.split import deploy, int8
from hnd_ghnd_tpu_torch.utils import visual_util
for name in ("load_config", "overwrite_config"):
    assert callable(getattr(config, name))
ev = coco_eval.CocoEvaluator(None, ["bbox", "segm", "keypoints"])
assert set(ev.evals) == {"bbox", "segm", "keypoints"}
mimic_runner.get_argparser().parse_args(["--config", "x.yaml", "-distill"])
ext_runner.get_argparser().parse_args(["--config", "x.yaml", "-train"])
cost_analyzer.get_argparser().parse_args(["--config", "x.yaml",
                                          "--split_model"])
visualizer.get_argparser().parse_args(["--config", "x.yaml", "--image",
                                       "a.jpg"])
banned = sorted({m.split(".")[0] for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "hnd_ghnd_tpu",
                                        "PIL", "cv2", "yaml", "optax",
                                        "sklearn", "pandas")})
assert not banned, banned
print("clean")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    # two torch threads: the tier-1 run shares the cores among its workers
    env["OMP_NUM_THREADS"] = "2"
    return env


def test_slice_imports_no_jax_pil_cv2_yaml():
    out = subprocess.run([sys.executable, "-c", SLICE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_host_modules_import_no_jax_pil_cv2_yaml():
    out = subprocess.run([sys.executable, "-c", HOST], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    # this host has no CUDA device: the script must fail and print no result,
    # in the repo and in a directory that holds nothing else of the repo
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd, env in ((REPO, _env()), (tmp_path, {k: v for k, v in
                                                 os.environ.items()
                                                 if k != "PYTHONPATH"})):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
