"""The port's entry scripts (hnd_ghnd_tpu_torch/bench.py and tools/)
against the JAX package's bench.py and tools/ on the CPU, at small sizes.

  * data/fixtures.make_coco_fixture writes the same files as
    tests/fixtures.make_coco_fixture;
  * every flag of JAX's scripts is a flag of the port's;
  * design_helper's capture-point shapes are JAX's (from jax.eval_shape)
    in NCHW, and its exit code is 1 on a mismatch; complexity_analyzer's
    depth-2 parameter counts are JAX's param_table's;
  * the headline bench's step is bench.build_distill_bench's (criterion,
    frozen modules, optimizer, dtype, image sizes), captured from JAX's
    function with its models and step stubbed;
  * the runner loops, the e2e demo, the ext demo and the pipeline bench
    run on the CPU at a few steps; the loops' JSON has JAX's keys.
"""
import ast
import filecmp
import json
import os
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"


def _jax_tool(name):
    """A module of the repo's tools/ (they import their siblings by name)."""
    sys.path.insert(0, str(TOOLS))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(TOOLS))


def _source_flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in a script."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "add_argument":
            flags.update(a.value for a in node.args
                         if isinstance(a, ast.Constant))
    return flags


def _returned_keys(path: Path, function: str) -> set:
    """The keys of the dict literal that ``function`` returns."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
           and isinstance(n.value, ast.Dict)][-1]
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("seed,keypoints,empty_prob,classes",
                         [(5, True, 0.4, 1), (21, True, 0.45, 2)])
def test_fixture_writes_jax_files(tmp_path, seed, keypoints, empty_prob,
                                  classes):
    from hnd_ghnd_tpu_torch.data.fixtures import make_coco_fixture
    from tests.fixtures import make_coco_fixture as jax_fixture
    kw = dict(num_images=6, seed=seed, num_classes=classes,
              keypoints=keypoints, empty_prob=empty_prob)
    port = make_coco_fixture(str(tmp_path / "port"), **kw)
    ref = jax_fixture(str(tmp_path / "jax"), **kw)
    names = sorted(os.listdir(ref[0]))
    assert names == sorted(os.listdir(port[0])) and len(names) == 6
    match, mismatch, errors = filecmp.cmpfiles(ref[0], port[0], names,
                                               shallow=False)
    assert match == names and not mismatch and not errors
    with open(port[1]) as a, open(ref[1]) as b:
        got, want = json.load(a), json.load(b)
    assert got == want
    empty = {im["id"] for im in want["images"]} - {
        a["image_id"] for a in want["annotations"]}
    assert empty and all("keypoints" in a for a in want["annotations"])


@pytest.mark.parametrize("tool", ["runner_bench", "e2e_demo", "ext_demo",
                                  "pipeline_bench", "complexity_analyzer",
                                  "design_helper"])
def test_port_tools_take_every_jax_flag(tool):
    import importlib
    mod = importlib.import_module(f"hnd_ghnd_tpu_torch.tools.{tool}")
    port = {s for a in mod.get_argparser()._actions for s in a.option_strings}
    jax_flags = _source_flags(TOOLS / f"{tool}.py")
    assert jax_flags and jax_flags <= port, jax_flags - port
    assert "--device" in port or tool == "pipeline_bench"


def _jax_capture_shapes(h, w):
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.models.factory import build_model
    helper = _jax_tool("design_helper")
    shapes = {}
    for role, bb in (("teacher", {"name": "resnet50", "params": {
            "pretrained": False, "freeze_layers": True}}),
                     ("student", {"name": "custom_resnet50", "params": {
                         "pretrained": False, "freeze_layers": False,
                         "layer1": {"name": "Bottleneck4LargeResNet",
                                    "bottleneck_channel": 3}}})):
        model = build_model({"name": "faster_rcnn", "backbone": bb,
                             "params": {"num_classes": 91}})
        params, state = jax.eval_shape(model.init, jax.random.PRNGKey(0))
        out = {}

        def capture(p, s, x):
            out.update(helper.shapes_at_capture_points(model, p, s, x))
            return jnp.zeros(())
        jax.eval_shape(capture, params, state,
                       jax.ShapeDtypeStruct((1, h, w, 3), jnp.float32))
        shapes[role] = out
    return shapes


def _nchw(shape):
    b, h, w, c = shape
    return (b, c, h, w)


def test_design_helper_shapes_equal_jax_in_nchw():
    from hnd_ghnd_tpu_torch.tools import design_helper
    h, w = 72, 104
    out = design_helper.main(["--device", "cpu", "--height", str(h),
                              "--width", str(w)])
    want = _jax_capture_shapes(h, w)
    for role in ("teacher", "student"):
        ref = want[role]
        got = out[role]
        assert set(got) == set(design_helper.CAPTURE_POINTS) == set(ref)
        for i in (1, 2, 3, 4):
            key = f"backbone.body.layer{i}"
            assert got[key] == _nchw(ref[key]), key
        assert got["backbone.fpn"] == [_nchw(s) for s in ref["backbone.fpn"]]
    assert out["ok"]


def test_design_helper_exits_1_on_a_mismatching_student(monkeypatch):
    from hnd_ghnd_tpu_torch.tools import design_helper
    real = design_helper.shapes_at_capture_points
    calls = []

    def student_off(model, images):
        shapes = real(model, images)
        calls.append(shapes)
        if len(calls) == 2:        # the student: one channel short
            b, c, h, w = shapes["backbone.body.layer1"]
            shapes["backbone.body.layer1"] = (b, c - 1, h, w)
        return shapes
    monkeypatch.setattr(design_helper, "shapes_at_capture_points",
                        student_off)
    monkeypatch.setattr(sys, "argv", ["design_helper", "--device", "cpu",
                                      "--height", "64", "--width", "64"])
    with pytest.raises(SystemExit) as exc:
        design_helper.cli()
    assert exc.value.code == 1
    monkeypatch.setattr(design_helper, "shapes_at_capture_points", real)
    with pytest.raises(SystemExit) as exc:
        design_helper.cli()
    assert exc.value.code == 0


@pytest.mark.parametrize("kind,bottleneck", [("faster_rcnn", None),
                                             ("faster_rcnn", 3),
                                             ("mask_rcnn", 3),
                                             ("keypoint_rcnn", None)])
def test_complexity_param_table_equals_jax(kind, bottleneck):
    import jax
    from hnd_ghnd_tpu.models.factory import build_model
    from hnd_ghnd_tpu_torch.models.factory import build_model as port_model
    from hnd_ghnd_tpu_torch.tools import complexity_analyzer as CA
    cfg = CA.model_config(kind, "resnet50", bottleneck)
    params, _ = jax.eval_shape(build_model(cfg).init, jax.random.PRNGKey(0))
    want = dict(_jax_tool("complexity_analyzer").param_table(params, depth=2))
    got = dict(CA.param_table(port_model(cfg), depth=2))
    # JAX nests each head's predictor under the head (roi_heads.mask_head
    # holds mask_predictor); the port's names are the reference's modules
    for head in ("mask", "keypoint"):
        if f"roi_heads.{head}_predictor" in got:
            got[f"roi_heads.{head}_head"] += got.pop(
                f"roi_heads.{head}_predictor")
    assert got == want


def test_complexity_analyzer_reports_stage_shapes():
    from hnd_ghnd_tpu_torch.tools import complexity_analyzer as CA
    out = CA.main(["--device", "cpu", "--bottleneck", "3", "--height", "64",
                   "--width", "96"])
    assert out["shapes"]["layer1"] == (1, 256, 16, 24)
    assert out["shapes"]["layer4"] == (1, 2048, 2, 3)
    assert out["shapes"]["bottleneck"][:2] == (1, 3)
    assert out["total"] == sum(n for _, n in out["params"])


def _jax_bench_arguments(monkeypatch):
    """bench.build_distill_bench's criterion, frozen list, optimizer config,
    compute dtype and batch, with its models, box and step stubbed."""
    import jax.numpy as jnp
    import bench
    from hnd_ghnd_tpu.distill import box
    from hnd_ghnd_tpu.models import factory
    from hnd_ghnd_tpu.parallel import mesh
    seen = {}

    class Model:
        def init(self, key):
            return {}, {}

    class Optimizer:
        def init(self, params):
            return None

    def fake_box(teacher, student, criterion):
        seen["criterion"] = criterion

    def fake_optimizer(cfg, *a, **k):
        seen["optimizer"] = cfg
        return Optimizer(), None

    def fake_step(b, optimizer, frozen, compute_dtype, donate):
        seen["frozen"] = frozen
        seen["compute_dtype"] = compute_dtype
        return "step"
    monkeypatch.setattr(factory, "build_model", lambda cfg: Model())
    monkeypatch.setattr(box, "DistillationBox", fake_box)
    monkeypatch.setattr(mesh, "build_optimizer", fake_optimizer)
    monkeypatch.setattr(mesh, "make_distill_train_step", fake_step)
    _, _, _, batch, _ = bench.build_distill_bench(batch_size=1,
                                                  bucket=(64, 64))
    seen["compute_dtype"] = {jnp.bfloat16: "bfloat16"}[seen["compute_dtype"]]
    seen["batch"] = {k: np.asarray(v) for k, v in batch.items()}
    return seen


def test_bench_step_configuration_equals_jax(monkeypatch):
    from hnd_ghnd_tpu_torch import bench
    from hnd_ghnd_tpu_torch.tools import runner_bench
    want = _jax_bench_arguments(monkeypatch)
    config = runner_bench.distill_config(bench.BATCH)
    assert config["train"]["criterion"] == want["criterion"]
    assert config["train"]["optimizer"] == want["optimizer"]
    assert config["student_model"]["frozen_modules"] == want["frozen"]
    assert config["tpu"]["compute_dtype"] == want["compute_dtype"]
    assert (bench.BATCH, bench.BUCKET, bench.WARMUP, bench.ITERS) == \
        (24, (832, 1344), 3, 10)
    step, batch = bench.build_distill_bench(1, (64, 64), device="cpu")
    assert step.compute_dtype == torch.bfloat16
    assert isinstance(step.optimizer, torch.optim.Adam)
    assert step.optimizer.param_groups[0]["lr"] == 1e-3
    assert step.schedule(0) == step.schedule(1000) == pytest.approx(1e-3)
    assert sorted(step.box.pairs) == ["layer1", "layer2", "layer3", "layer4"]
    trainable = {n for n, p in step.box.student.named_parameters()
                 if p.requires_grad}
    assert trainable and all(not n.startswith(tuple(f + "." for f in
                                                    want["frozen"]))
                             for n in trainable)
    assert all(n.startswith("backbone.body.") for n in trainable)
    for key in ("image_sizes", "original_sizes"):
        np.testing.assert_array_equal(batch[key].numpy(),
                                      want["batch"][key])
    np.testing.assert_array_equal(batch["images"].numpy(),
                                  want["batch"]["images"])


def _printed_keys(path: Path) -> set:
    """The keys of the dict literal that a script's ``main`` prints."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"
             and isinstance(n.args[0], ast.Dict)]
    return {k.value for k in dicts[-1].args[0].keys}


def test_bench_main_on_cpu_prints_jax_keys(monkeypatch, capsys):
    from hnd_ghnd_tpu_torch import bench
    from hnd_ghnd_tpu_torch.runners import common
    evaluate = common.coco_evaluate
    monkeypatch.setattr(bench, "BATCH", 1)
    monkeypatch.setattr(bench, "BUCKET", (64, 64))
    monkeypatch.setattr(bench, "LOOP_STEPS", 2)
    out = bench.main(["--device", "cpu", "--f32_steps", "1"])
    assert common.coco_evaluate is evaluate
    assert set(out) == _printed_keys(REPO / "bench.py")
    assert out["metric"] == "mimic_runner_distill_images_per_sec_per_chip"
    assert out["value"] > 0 and out["raw_step_img_s"] > 0
    assert out["vs_baseline"] == round(out["value"] / 10.0, 2)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[-1] == out
    earlier = lines[:-1]
    assert all(x["card"] == "cpu" for x in earlier)
    assert [x["loop"]["value"] for x in earlier if "loop" in x] == \
        [out["value"]]
    assert [x["float32"]["steps"] for x in earlier if "float32" in x] == [1]
    assert any("peak_memory_gib" in x for x in earlier)
    assert any("epoch2_step_ms" in x for x in earlier)


@pytest.mark.parametrize("runner", ["mimic", "coco"])
def test_runner_loop_on_cpu_has_jax_keys(runner, capsys):
    from hnd_ghnd_tpu_torch.runners import common
    from hnd_ghnd_tpu_torch.tools import runner_bench
    evaluate = common.coco_evaluate
    out = runner_bench.main(["--runner", runner, "--batch", "1", "--steps",
                             "2", "--hw", "64,64", "--device", "cpu"])
    assert common.coco_evaluate is evaluate     # the stub is gone
    function = {"mimic": "measure_runner_loop",
                "coco": "measure_coco_runner_loop"}[runner]
    jax_keys = _returned_keys(TOOLS / "runner_bench.py", function)
    assert jax_keys <= set(out)
    assert set(out) - jax_keys == {"step_ms", "peak_memory_gib",
                                   "window_syncs"}
    assert out["steps"] == 2 and out["value"] > 0
    # the two marks: epoch 1 (with its first calls) before the window
    assert 0 < out["window_s"] <= out["total_s"]
    assert out["epoch1_s"] + out["window_s"] <= out["total_s"] + 0.01
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))


def test_runner_loop_raises_without_marks(monkeypatch):
    from hnd_ghnd_tpu_torch.runners import common, mimic_runner
    from hnd_ghnd_tpu_torch.tools import runner_bench
    evaluate = common.coco_evaluate
    monkeypatch.setattr(mimic_runner, "distill_coco", lambda *a: None)
    with pytest.raises(RuntimeError, match="two epoch marks"):
        runner_bench.measure_runner_loop(1, 1, (64, 64), device="cpu")
    assert common.coco_evaluate is evaluate
    with pytest.raises(NotImplementedError):
        runner_bench.measure_runner_loop(1, 1, (64, 64), device="cpu",
                                         steps_per_dispatch=2)


def test_e2e_demo_on_cpu(monkeypatch, capsys):
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    from hnd_ghnd_tpu_torch.tools import e2e_demo
    make_step = mimic_runner.make_step
    before = {}

    def capture(teacher, student, config, steps_per_epoch, seed=0):
        before["teacher"] = {k: v.clone() for k, v in
                             teacher.state_dict().items()}
        before["student"] = {k: v.clone() for k, v in
                             student.state_dict().items()}
        return make_step(teacher, student, config, steps_per_epoch, seed)
    monkeypatch.setattr(mimic_runner, "make_step", capture)
    # batch 2 of the 2 images; float32 teacher steps are shorter on the CPU
    monkeypatch.setattr(e2e_demo, "BATCH", 2)
    monkeypatch.setattr(e2e_demo, "TEACHER_DTYPE", "float32")
    out = e2e_demo.main(["--device", "cpu", "--images", "2", "--steps", "2",
                         "--distill_steps", "2"])
    teacher, student = before["teacher"], before["student"]
    inherited = [k for k in student if k.startswith(e2e_demo.INHERITED)]
    assert sorted(inherited) == out["inherited"]
    assert any(k.startswith("backbone.body.layer1.") for k in student)
    for k in inherited:
        assert torch.equal(student[k], teacher[k]), k
    assert not any(k.startswith("backbone.body.layer1.") for k in inherited)
    text = capsys.readouterr().out
    m = re.search(r"^RESULT teacher mAP=([\d.]+) student mAP=([\d.]+) "
                  r"retention=([\d.]+)% distill loss ([\d.]+) -> ([\d.]+)$",
                  text, re.M)
    assert m, text
    assert float(m.group(1)) == pytest.approx(out["teacher"]["bbox"],
                                              abs=1e-4)
    assert float(m.group(2)) == pytest.approx(out["student"]["bbox"],
                                              abs=1e-4)
    assert float(m.group(4)) > 0 and all(
        np.isfinite(v) for v in out["distill_loss"] + out["teacher_loss"])
    raw = re.search(r"^student mAP raw=([\d.]+) quantized=([\d.]+)$", text,
                    re.M)
    assert raw and float(raw.group(1)) == pytest.approx(
        out["student_raw"]["bbox"], abs=1e-4)


def test_ext_demo_on_cpu(capsys):
    from hnd_ghnd_tpu_torch.tools import ext_demo
    out = ext_demo.main(["--device", "cpu", "--epochs", "1"])
    assert out["steps"] == 4 and out["n"] == 16
    assert 0 < out["positives"] < 16
    assert np.isfinite(out["loss"]).all() and 0.0 <= out["auc"] <= 1.0
    m = re.search(r"^RESULT ext-filter ROC-AUC=([\d.]+)$",
                  capsys.readouterr().out, re.M)
    assert m and float(m.group(1)) == pytest.approx(out["auc"], abs=1e-4)


def test_pipeline_bench_on_cpu_has_jax_metric():
    from hnd_ghnd_tpu_torch.tools import pipeline_bench
    out = pipeline_bench.main(["--images", "6", "--batch", "2", "--workers",
                               "1,2", "--epochs", "1"])
    assert set(out) == {"metric", "value", "cores_for_98_img_s"}
    assert out["metric"] == "host_pipeline_img_s_per_core"
    assert out["value"] > 0
