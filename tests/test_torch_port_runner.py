"""The port's runners end to end against the JAX package's, on the CPU.

At the tiny buckets of tests/test_runners.py (ResNet-50, 96x96, min side
64) on tests/fixtures.py::make_coco_fixture, both packages start from the
same JAX-written checkpoints (``runner_case``): a teacher with live BNs
and class logits x300, and a b3ch student that shares all but its
``layer1`` with it, as zoo weights would give both.  The val and test
annotations are the teacher's own detections, so that COCOeval has
something to score (random weights find nothing of the fixture's own
boxes), as in chip_smoke.py's runner phase.  JAX's ``mimic_runner.main``
runs once per module (``-distill -transform_bottleneck``, one epoch of
two steps, then its test evals), the port's from a YAML on disk with
``--device cpu``:

  * ``-distill -transform_bottleneck``: the port's per-step loss and terms
    agree to LOSS_TOL with the MSE-sums of JAX's own features at each of
    its steps, summed in float64, as in tests/test_torch_port_distill.py
    (XLA's float32 sums in JAX's runner are themselves ~2e-5 off them
    here); the val and test bbox stats agree to STATS_TOL; the port's best
    checkpoint is read by JAX's ``load_ckpt`` and ``get_model``, and the
    port resumes from it with its optimizer state;
  * ``-test_only -transform_bottleneck`` on the checkpoints JAX's run
    ended with (its teacher's, and the student's best): the teacher's and
    the student's test stats agree with JAX's to STATS_TOL.

tests/test_torch_port_coco_runner.py runs ``coco_runner.main``.
"""
import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from chip_smoke import (STUDENT_MODEL, TEACHER_MODEL, TRAIN, live_norms_,
                        teacher_annotations)
from hnd_ghnd_tpu.data import native_prep
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.runners import coco_runner, common, mimic_runner
from hnd_ghnd_tpu_torch.utils import ckpt as port_ckpt
from tests.fixtures import make_coco_fixture
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

NUM_CLASSES = 5
# loss and terms of a step: the tolerance of tests/test_torch_port_distill.py
LOSS_TOL = 1e-5
# JAX's logged loss and terms are its float32 sums, ~2e-5 of a term off the
# float64 sums the port is held to at LOSS_TOL (see jax_exact_terms)
TB_TOL = 1e-4
# COCOeval stats of the same weights on the same batches: the detections
# agree to float noise, which moves a stat only where a box crosses an IoU
# threshold or two scores swap
STATS_TOL = 0.02
TINY_TPU = {"buckets": [[96, 96]], "min_sizes": [64], "max_size": 96,
            "compute_dtype": "float32", "eval_batch_size": 4}
EVAL_BATCH = 4                 # test.batch_size: one eval program in JAX
# val and test hold the fixture's first EVAL_BATCH images: one batch each
# (a CPU eval forward of this model takes ~1 s an image)


@pytest.fixture(scope="module", autouse=True)
def pure_host_prep():
    """Both packages on their pure host path (PIL decode, cv2 resize),
    the port by the switch they share: the native one is held in
    tests/test_torch_port_native.py."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HND_TPU_NATIVE_PREP", "0")
        yield


def model_configs():
    """The GHND b3ch teacher and student blocks with NUM_CLASSES classes
    and no checkpoint yet."""
    params = {"num_classes": NUM_CLASSES, "pretrained": False}
    teacher = dict(TEACHER_MODEL, params=params)
    student = dict(STUDENT_MODEL, params=params)
    return teacher, student


def split(img_dir, ann):
    return {"images": img_dir, "annotations": ann,
            "remove_non_annotated_imgs": False, "jpeg_quality": None}


def write_jax_ckpt(path, model):
    params, state = convert_state_dict(model.state_dict())
    jax_ckpt.save_ckpt(path, params=params, state=state, best_value=0.0)


def runner_case(root):
    """The fixture, the two JAX-written checkpoints and the config (a dict;
    ``write_config`` puts it on disk with a student checkpoint of its
    own)."""
    img_dir, ann = make_coco_fixture(str(root / "fx"), num_images=8, seed=7,
                                     num_classes=NUM_CLASSES - 1)
    teacher_cfg, student_cfg = model_configs()
    teacher = live_norms_(get_model(teacher_cfg, seed=0, device="cpu"), 0)
    with torch.no_grad():
        teacher.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    student = live_norms_(get_model(student_cfg, seed=1, device="cpu"), 1)
    student.load_state_dict({k: v for k, v in teacher.state_dict().items()
                             if not k.startswith("backbone.body.layer1.")},
                            strict=False)
    teacher_ckpt = str(root / "teacher.pt")
    student_ckpt = str(root / "student_start.pt")
    write_jax_ckpt(teacher_ckpt, teacher)
    write_jax_ckpt(student_ckpt, student)
    config = {
        "dataset": {"name": "fixture", "num_workers": 2,
                    "splits": {"train": split(img_dir, ann),
                               "val": split(img_dir, ann),
                               "test": split(img_dir, ann)}},
        "teacher_model": dict(teacher_cfg, ckpt=teacher_ckpt),
        "student_model": dict(student_cfg, ckpt=student_ckpt),
        "train": dict(TRAIN, num_epochs=1, log_freq=1),
        "test": {"batch_size": EVAL_BATCH},
        "tpu": TINY_TPU,
    }
    with open(ann) as f:
        coco = json.load(f)
    coco["images"] = coco["images"][:EVAL_BATCH]
    first = str(root / "first_images.json")
    with open(first, "w") as f:
        json.dump(coco, f)
    config["dataset"]["splits"]["val"] = split(img_dir, first)
    # the teacher as JAX's get_model loads it: from its checkpoint
    loaded = get_model(config["teacher_model"], device="cpu")
    gt = str(root / "teacher_gt.json")
    n, _, _ = teacher_annotations(loaded, config, gt)
    assert n >= 8, n
    for name in ("val", "test"):
        config["dataset"]["splits"][name] = split(img_dir, gt)
    return config


def write_config(root, config, name, student_ckpt=None):
    """``config`` as a YAML under ``root``; with ``student_ckpt``, the
    student starts from a copy of the starting checkpoint there."""
    config = json.loads(json.dumps(config))
    if student_ckpt is not None:
        shutil.copy(config["student_model"]["ckpt"], student_ckpt)
        config["student_model"]["ckpt"] = student_ckpt
    path = str(root / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return path


@contextlib.contextmanager
def jax_runner(root):
    """JAX's runners on their pure data path (see
    tests/test_torch_port_data.py), with their compilation cache under
    ``root``.  Yields {"losses": the StepMetrics entries, "stats": the
    stats of each evaluate call, in order, "box": the DistillationBox,
    "calls": the (teacher params, teacher state, student params, student
    state, images) of each distill step, as numpy}."""
    from hnd_ghnd_tpu.runners import common as jax_common
    from hnd_ghnd_tpu.runners import mimic_runner as jax_mimic
    seen = {"losses": [], "stats": [], "calls": []}
    evaluate = jax_common.evaluate
    make_step = jax_mimic.make_distill_train_step

    class Box(jax_mimic.DistillationBox):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen["box"] = self

    def recorded_make_step(*args, **kwargs):
        fn = make_step(*args, **kwargs)

        def step(t_params, t_state, s_params, s_state, opt_state, batch,
                 *rest):
            seen["calls"].append(jax.device_get(
                (t_params, t_state, s_params, s_state, batch["images"])))
            return fn(t_params, t_state, s_params, s_state, opt_state, batch,
                      *rest)
        return step

    class Recorded(jax_common.StepMetrics):
        def push(self, *args, **kwargs):
            out = super().push(*args, **kwargs)
            seen["losses"] += out
            return out

        def drain(self):
            out = super().drain()
            seen["losses"] += out
            return out

    def recorded_evaluate(*args, **kwargs):
        ev = evaluate(*args, **kwargs)
        seen["stats"].append({k: np.asarray(v) for k, v in ev.stats.items()})
        return ev

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_prep, "available", lambda: False)
        mp.setattr(native_prep, "decode_jpeg", lambda data: None)
        mp.setattr(jax_common, "StepMetrics", Recorded)
        mp.setattr(jax_common, "evaluate", recorded_evaluate)
        mp.setattr(jax_mimic, "DistillationBox", Box)
        mp.setattr(jax_mimic, "make_distill_train_step", recorded_make_step)
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(root / "jax_cache"))
        yield seen


def jax_exact_terms(box, calls):
    """(loss, terms) of each captured JAX step: the MSE-sums of JAX's own
    teacher and student features, summed in float64."""
    features = jax.jit(lambda tp, ts, sp, ss, x: (
        box._features(box.teacher, tp, ts, x, training=False)[0],
        box._features(box.student, sp, ss, x, training=True)[0]))
    out = []
    for args in calls:
        t, s = features(*args)
        terms = {}
        for name, (t_path, s_path) in box.pairs.items():
            d = (np.asarray(t[t_path], np.float64)
                 - np.asarray(s[s_path], np.float64))
            terms[name] = float((d * d).sum())
        out.append((sum(terms.values()), terms))
    return out


def port_main(runner, argv):
    """``runner.main`` from the CLI arguments, with its stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = runner.main(runner.get_argparser().parse_args(argv))
    return result, out.getvalue()


def assert_stats_close(got, want, tol=STATS_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_runner")
    return root, runner_case(root)


DISTILL_FLAGS = ["-distill", "-transform_bottleneck", "-skip_teacher_eval"]


@pytest.fixture(scope="module")
def jax_distill(case):
    """JAX's run, with its teacher's test eval: the stats are [val, teacher
    test, student test]."""
    from hnd_ghnd_tpu.runners import mimic_runner as jax_mimic
    root, config = case
    path = write_config(root, config, "jax_distill",
                        str(root / "jax_student.pt"))
    with jax_runner(root) as seen:
        jax_mimic.main(jax_mimic.get_argparser().parse_args(
            ["--config", path, "--tb_dir", str(root / "jax_tb")]
            + DISTILL_FLAGS[:2]))
    seen["exact"] = jax_exact_terms(seen["box"], seen["calls"])
    seen["config"] = path
    return seen


@pytest.fixture(scope="module")
def port_distill(case):
    root, config = case
    ckpt = str(root / "port_student.pt")
    path = write_config(root, config, "port_distill", ckpt)
    result, stdout = port_main(mimic_runner,
                               ["--config", path, "--device", "cpu",
                                "--tb_dir", str(root / "port_tb")]
                               + DISTILL_FLAGS)
    return result, stdout, path, ckpt


def test_distill_tensorboard_scalars_match_jax(case, jax_distill,
                                               port_distill):
    """``--tb_dir``: the same tags in the same order as JAX's run (train/loss
    and the four terms each step at log_freq 1, then val/map), the losses
    within TB_TOL of JAX's (each package's first step is its own 0 or 1)
    and val/map the epoch's."""
    from hnd_ghnd_tpu.utils.tensorboard import read_scalars as jax_read
    from hnd_ghnd_tpu_torch.utils.tensorboard import read_scalars
    root = case[0]

    def scalars(name, read):
        (path,) = [os.path.join(root, name, f)
                   for f in os.listdir(root / name)]
        return read(path)

    got = scalars("port_tb", read_scalars)
    want = scalars("jax_tb", jax_read)
    assert [t for t, _, _ in got] == [t for t, _, _ in want]
    assert [t for t, _, _ in got][-1] == "val/map"
    for (tag, v, step), (_, w, _) in zip(got[:-1], want[:-1]):
        assert abs(v - w) <= TB_TOL * abs(w), (tag, step, v, w)
    (epoch,) = port_distill[0]["distill"]["epochs"]
    assert got[-1][1:] == (np.float32(epoch["val_map"]), 0)


def test_distill_losses_match_jax(jax_distill, port_distill):
    result = port_distill[0]
    got = result["distill"]["steps"]
    assert [s[0] for s in got] == [0, 1]
    assert [s[0] for s in jax_distill["losses"]] == [1, 2]  # JAX counts from 1
    assert len(jax_distill["exact"]) == 2
    for (_, loss, terms, ms), (j_loss, j_terms), (_, j32, _) in zip(
            got, jax_distill["exact"], jax_distill["losses"]):
        assert ms is None
        assert abs(loss - j_loss) <= LOSS_TOL * j_loss, (loss, j_loss, j32)
        assert set(terms) == set(j_terms) == {f"layer{i}" for i in (1, 2, 3, 4)}
        for k, v in terms.items():
            assert abs(v - j_terms[k]) <= LOSS_TOL * j_terms[k], k


def test_distill_eval_stats_match_jax(jax_distill, port_distill):
    """The val stats of the epoch and the student's test stats (from the
    best checkpoint); the val mAP is the evaluator's stats["bbox"][0]."""
    result, stdout = port_distill[:2]
    val, _, test = jax_distill["stats"]
    (epoch,) = result["distill"]["epochs"]
    assert_stats_close(epoch["stats"], val)
    assert epoch["val_map"] == epoch["stats"]["bbox"][0]
    assert 0.0 < epoch["val_map"] < 1.0
    assert "teacher" not in result  # -skip_teacher_eval
    assert_stats_close(result["student"]["stats"], test)
    assert "evaluating student" in stdout


def test_test_only_stats_match_jax(jax_distill):
    """``-test_only`` on the checkpoints JAX's run ended with: teacher
    first, then the student through the bottleneck round trip, each within
    STATS_TOL of JAX's test evals; on its own detections the teacher scores
    close to 1, the student (a random bottleneck) far below."""
    _, teacher, student = jax_distill["stats"]
    result, stdout = port_main(
        mimic_runner, ["--config", jax_distill["config"], "--device", "cpu",
                       "-test_only", "-transform_bottleneck"])
    assert "distill" not in result
    assert stdout.index("evaluating teacher") < stdout.index(
        "evaluating student")
    assert_stats_close(result["teacher"]["stats"], teacher)
    assert_stats_close(result["student"]["stats"], student)
    t_map = result["teacher"]["stats"]["bbox"][0]
    s_map = result["student"]["stats"]["bbox"][0]
    assert t_map >= 0.9 and 0.0 < s_map < t_map, (t_map, s_map)
    assert STATS_TOL < t_map - s_map


def test_best_checkpoint_is_read_by_jax(port_distill):
    """The port's best checkpoint: the JAX payload with the port's
    optimizer state; JAX's load_ckpt and get_model read it, and its params
    are the student's."""
    from hnd_ghnd_tpu.models.factory import get_model as jax_get_model
    result, stdout, path, ckpt = port_distill
    (epoch,) = result["distill"]["epochs"]
    assert epoch["saved"] and "saved best ckpt" in stdout
    payload = jax_ckpt.load_ckpt(ckpt)
    assert payload["format_version"] == 1 and payload["opt_state"] is None
    assert payload["best_value"] == epoch["val_map"]
    assert payload["lr_step"] == 2
    assert payload["torch_opt_state"]["state"]
    config = yaml.safe_load(open(path))
    _, params, state = jax_get_model(config["student_model"], seed=5)
    port = get_model(config["student_model"], seed=6, device="cpu")
    want_p, want_s = jax_params_from_state_dict(port.state_dict())
    for tree, want in ((params, want_p), (state, want_s)):
        got = jax.tree_util.tree_map(np.asarray, tree)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want)
        for k, v in flat_got:
            np.testing.assert_array_equal(v, flat_want[k], err_msg=str(k))


def test_distill_resumes_from_the_best_checkpoint(case, port_distill):
    """``common.resume`` restores the student, its Adam state, schedule
    step and best value bit for bit; a second run resumes from the
    checkpoint and counts on from step 2."""
    result, _, path, ckpt = port_distill
    before = port_ckpt.load_ckpt(ckpt)
    config = yaml.safe_load(open(path))
    teacher = get_model(config["teacher_model"], seed=0, device="cpu")
    student = get_model(config["student_model"], seed=1, device="cpu")
    step = mimic_runner.make_step(teacher, student, config, 2)
    assert common.resume(ckpt, student, step) == before["best_value"]
    assert step.step == 2
    saved = before["torch_opt_state"]["state"]
    state = step.optimizer.state_dict()["state"]
    assert set(state) == set(saved) and len(state) > 0
    for i, s in state.items():
        for k, v in s.items():
            np.testing.assert_array_equal(v.numpy(), saved[i][k])
    again, stdout = port_main(mimic_runner, ["--config", path, "--device",
                                             "cpu", "-student_only"]
                              + DISTILL_FLAGS)
    assert f"resumed from {ckpt}" in stdout and "fresh optimizer" not in stdout
    assert [s[0] for s in again["distill"]["steps"]] == [2, 3]
    (epoch,) = again["distill"]["epochs"]
    after = port_ckpt.load_ckpt(ckpt)
    assert epoch["saved"] == (epoch["val_map"] > before["best_value"])
    assert after["lr_step"] == (4 if epoch["saved"] else 2)


def test_distill_with_the_org_term_in_bf16_from_the_yaml(case):
    """``-distill`` with ``--json`` turning on ``org_loss_factor`` and the
    JAX package's default bfloat16: one epoch of two steps on the loader's
    targets, each logging the four feature terms and the four org_ terms,
    finite, the student's trunk in bfloat16, then its float32 evals (on
    the first EVAL_BATCH images: one eval batch each)."""
    root, config = case
    first = str(root / "first_images.json")
    path = write_config(root, config, "org_bf16",
                        str(root / "org_bf16_student.pt"))
    seen = []
    forward = mimic_runner.DistillationBox._features

    def features(box, model, images, full=False):
        seen.append(images.dtype)
        return forward(box, model, images, full)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mimic_runner.DistillationBox, "_features", features)
        result, _ = port_main(mimic_runner, [
            "--config", path, "--device", "cpu", "-distill",
            "-skip_teacher_eval", "--json", json.dumps(
                {"train": {"criterion": {"params": {"org_loss_factor": 1.0}}},
                 "tpu": {"compute_dtype": "bfloat16"},
                 "dataset": {"splits": {"val": {"annotations": first},
                                        "test": {"annotations": first}}}})])
    steps = result["distill"]["steps"]
    assert [s[0] for s in steps] == [0, 1]
    org = {"org_loss_classifier", "org_loss_box_reg", "org_loss_objectness",
           "org_loss_rpn_box_reg"}
    for _, loss, terms, _ in steps:
        assert set(terms) == {f"layer{i}" for i in (1, 2, 3, 4)} | org
        assert np.isfinite(loss) and all(np.isfinite(v)
                                         for v in terms.values())
        assert loss == pytest.approx(sum(terms.values()), rel=1e-5)
    assert seen == [torch.bfloat16] * 4  # teacher and student, two steps
    assert result["student"]["eval"]["batches"] == 1
    assert np.isfinite(result["student"]["stats"]["bbox"]).all()


def test_runners_default_to_the_card():
    for runner in (mimic_runner, coco_runner):
        args = runner.get_argparser().parse_args(["--config", "x.yaml"])
        assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mimic_runner.run({"teacher_model": TEACHER_MODEL,
                              "student_model": STUDENT_MODEL},
                             argparse.Namespace(world_size=None, seed=0,
                                                device="cuda"))


@pytest.mark.parametrize("runner", ["mimic_runner", "coco_runner"])
def test_cli_parses_the_reference_flags(runner):
    """``python -m hnd_ghnd_tpu_torch.runners.<runner> --help`` in a fresh
    interpreter: the reference's flags and --device."""
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", f"hnd_ghnd_tpu_torch.runners.{runner}",
         "--help"], cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    flags = (["-distill", "-test_only", "-student_only",
              "-transform_bottleneck", "-skip_teacher_eval"]
             if runner == "mimic_runner" else ["-train", "-test_only"])
    for flag in flags + ["--config", "--json", "--device", "--seed"]:
        assert flag in out.stdout, flag
