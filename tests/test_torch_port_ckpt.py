"""Checkpoints of the port against the JAX package's.

  * ``jax_params_from_state_dict`` and ``state_dict_from_jax`` are exact
    inverses both ways, for the teacher (= the org Faster R-CNN), the b3ch
    student and the b3ch Mask and Keypoint R-CNN students (the org Mask and
    Keypoint R-CNN are the teacher's trunk with these heads): a
    JAX-initialised (params, state) crosses to the port
    and back bit for bit, and a port ``state_dict`` with live BNs, once
    folded, too; the folded model's forward is bit-identical;
  * a port checkpoint (``runners.common.save_checkpoint``) loaded by the
    JAX package's ``get_model`` gives the port's detections within the
    tolerance of tests/test_torch_port_slice.py;
  * a JAX pickle checkpoint with an optax Adam state loads into the port
    (``get_model``, ``common.resume``: a fresh optimizer state) in a fresh
    interpreter in which jax and optax never enter ``sys.modules``.
"""
import argparse
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (KEYPOINT_STUDENT_MODEL, MASK_STUDENT_MODEL, ORG_MODEL,
                        STUDENT_MODEL, TRAIN, live_norms_)
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.models.factory import get_model as jax_get_model
from hnd_ghnd_tpu.models.factory import init_model as jax_init_model
from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_build_optimizer
from hnd_ghnd_tpu.runners.common import JitCache
from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
from hnd_ghnd_tpu_torch.models.convert import (jax_params_from_state_dict,
                                               state_dict_from_jax)
from hnd_ghnd_tpu_torch.models.factory import build_model, get_model
from hnd_ghnd_tpu_torch.runners import common
from tests.test_torch_port_slice import BOX_TOL, SCORE_TOL, _batch
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
KINDS = {
    "teacher_org": ORG_MODEL,
    "student": STUDENT_MODEL,
    "mask_student": MASK_STUDENT_MODEL,
    "keypoint_student": KEYPOINT_STUDENT_MODEL,
}
SHAPE = (128, 192)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("kind", list(KINDS))
def test_round_trip_is_exact_both_ways(kind):
    cfg = KINDS[kind]
    params, state = _np(jax_init_model(jax_build_model(cfg), 0))
    sd = state_dict_from_jax(params, state)
    assert_trees_equal(jax_params_from_state_dict(sd), (params, state))
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    live = live_norms_(model, 1).state_dict()
    folded = state_dict_from_jax(*jax_params_from_state_dict(live))
    again = state_dict_from_jax(*jax_params_from_state_dict(folded))
    assert set(folded) == set(again) == set(sd)
    for k, v in folded.items():
        assert torch.equal(v, again[k]), k
    if kind == "student":
        # the fold keeps the forward: FrozenBatchNorm2d.folded's arithmetic
        other = build_model(cfg)
        other.load_state_dict(folded)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(0, (64, 96), [(64, 96)]).items()}
        with torch.no_grad():
            a, b = (common.eval_forward(m, batch, True) for m in (model, other))
        for k in a:
            assert torch.equal(a[k], b[k]), k


def _save_port_ckpt(path, model):
    """A checkpoint as the runners write it (an Adam state beside)."""
    params = [p for p in model.parameters() if p.requires_grad]
    step = types.SimpleNamespace(optimizer=torch.optim.Adam(params), step=3)
    common.save_checkpoint(path, model, step, 0.5, {"note": "test"},
                           argparse.Namespace(seed=0))


def test_port_checkpoint_serves_in_jax(tmp_path):
    """The port's b3ch student (live BNs, class logits x300) written by the
    runner's writer, read by JAX's get_model: JAX's eval forward gives the
    port's detections."""
    model = live_norms_(get_model(STUDENT_MODEL, seed=2, device="cpu"), 2)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    path = str(tmp_path / "student.pt")
    _save_port_ckpt(path, model)
    payload = jax_ckpt.load_ckpt(path)
    assert payload["format_version"] == 1 and payload["opt_state"] is None
    assert payload["lr_step"] == 3 and payload["best_value"] == 0.5
    jm, params, state = jax_get_model(dict(STUDENT_MODEL, ckpt=path), seed=9)
    batch = _batch(0, SHAPE, [SHAPE, (100, 150)])
    want = {k: np.asarray(v) for k, v in JitCache(jm).eval_forward(
        SHAPE, True)(params, state,
                     {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    (rec,) = common.evaluate(model, [batch], use_bottleneck_transformer=True)
    got = rec["dets"]
    np.testing.assert_array_equal(got["valid"].sum(1), want["valid"].sum(1))
    assert want["valid"].sum() > 50
    for i in range(2):
        for j in np.flatnonzero(want["valid"][i]):
            same = (got["valid"][i]
                    & (got["labels"][i] == want["labels"][i, j])
                    & (np.abs(got["scores"][i] - want["scores"][i, j])
                       <= SCORE_TOL)
                    & (np.abs(got["boxes"][i] - want["boxes"][i, j]).max(1)
                       <= 1.5 * BOX_TOL))
            assert same.any(), f"image {i}: JAX detection {j} not in the port's"


LOAD_JAX_CKPT = r"""
import sys
import torch
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.utils import ckpt
from chip_smoke import STUDENT_MODEL
path, out = sys.argv[1], sys.argv[2]
payload = ckpt.load_ckpt(path)
stubs, todo = [], [payload["opt_state"]]
while todo:  # optax's chain state: tuples of optax NamedTuples
    node = todo.pop()
    if type(node) is tuple:
        todo += list(node)
    elif type(node).__module__.startswith("optax"):
        stubs.append(type(node).__name__)
        todo += list(node.args)
assert "ScaleByAdamState" in stubs, stubs
model = get_model(dict(STUDENT_MODEL, ckpt=path), seed=4, device="cpu")
params = [p for p in model.parameters() if p.requires_grad]
step = type("Step", (), {})()
step.optimizer, step.step = torch.optim.Adam(params), 7
assert common.resume(path, model, step) == 0.25 and step.step == 0
assert not step.optimizer.state_dict()["state"]
banned = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                        "optax")]
assert not banned, banned
torch.save(model.state_dict(), out)
print("clean")
"""


def test_jax_checkpoint_with_optax_state_loads_without_jax(tmp_path):
    params, state = _np(jax_init_model(jax_build_model(STUDENT_MODEL), 3))
    optimizer, _ = jax_build_optimizer(TRAIN["optimizer"], TRAIN["scheduler"],
                                       10, 9)
    opt_state = optimizer.init(params)
    path = str(tmp_path / "jax.pt")
    jax_ckpt.save_ckpt(path, params=params, state=state, opt_state=opt_state,
                       best_value=0.25)
    out = str(tmp_path / "port_sd.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run([sys.executable, "-c", LOAD_JAX_CKPT, path, out],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    assert "fresh optimizer state" in run.stdout
    assert run.stdout.strip().endswith("clean")
    got = torch.load(out)
    want = state_dict_from_jax(params, state)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
