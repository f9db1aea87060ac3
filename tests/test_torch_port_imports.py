"""The port runs on torch and numpy alone, and chip_smoke.py refuses to run
without a GPU or without the package beside it.

Each check runs in a fresh interpreter: the serving, distill and
supervised-training slices are imported, built and run once on a tiny input
(one distill epoch of one step, one coco_runner epoch of one bfloat16 step,
each with its eval), then jax, the JAX package, PIL, cv2 and yaml must be
absent from ``sys.modules`` (the GPU host has none of them)."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SLICE = r"""
import sys
import numpy as np
import hnd_ghnd_tpu_torch
import hnd_ghnd_tpu_torch._build
from hnd_ghnd_tpu_torch.codec import quantizer
from hnd_ghnd_tpu_torch.models import (bottleneck, convert, factory, fpn,
    layers, rcnn, resnet, roi_heads, rpn)
from hnd_ghnd_tpu_torch.ops import (anchors, boxes, nms, quant_kernels,
    roi_align, roi_align_kernels, stem, stem_kernels)
from hnd_ghnd_tpu_torch.distill import box, losses
from hnd_ghnd_tpu_torch.parallel import train_step
from hnd_ghnd_tpu_torch.runners import coco_runner, common, mimic_runner
from hnd_ghnd_tpu_torch.utils import params
from chip_smoke import ORG_MODEL, ORG_TRAIN, STUDENT_MODEL, TEACHER_MODEL, TRAIN
model = factory.get_model(STUDENT_MODEL, seed=0, device="cpu")
batch = {"images": np.zeros((1, 64, 64, 3), np.uint8),
         "image_sizes": np.array([[64, 64]], np.int32),
         "original_sizes": np.array([[64, 64]], np.int32)}
(rec,) = common.evaluate(model, [batch], use_bottleneck_transformer=True)
assert rec["dets"]["boxes"].shape == (1, 100, 4)
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
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "hnd_ghnd_tpu", "PIL",
                                 "cv2", "yaml")]
assert not banned, banned
print("clean")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    return env


def test_slice_imports_no_jax_pil_cv2_yaml():
    out = subprocess.run([sys.executable, "-c", SLICE], cwd=REPO, env=_env(),
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
