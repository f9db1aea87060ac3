"""The port runs on torch and numpy alone, and chip_smoke.py refuses to run
without a GPU or without the package beside it.

Each check runs in a fresh interpreter: the serving slice is imported, built
and run once on a tiny input, then jax, the JAX package, PIL, cv2 and yaml
must be absent from ``sys.modules`` (the GPU host has none of them)."""
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
    roi_align, roi_align_kernels)
from hnd_ghnd_tpu_torch.runners import common
from chip_smoke import STUDENT_MODEL
model = factory.get_model(STUDENT_MODEL, seed=0)
batch = {"images": np.zeros((1, 64, 64, 3), np.uint8),
         "image_sizes": np.array([[64, 64]], np.int32),
         "original_sizes": np.array([[64, 64]], np.int32)}
(rec,) = common.evaluate(model, [batch], use_bottleneck_transformer=True)
assert rec["dets"]["boxes"].shape == (1, 100, 4)
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
