"""The port's cost_analyzer and visualizer against the JAX package's, on the
CPU, on a tests/fixtures.py COCO fixture at tests/test_runners.py's tiny
buckets (96x96, min side 64).

The student is seeded, with live BNs and its class logits spread x300, and
written as the config's checkpoint; the fixture's annotations are its own
detections (chip_smoke.teacher_annotations), so its mAP is near 1 and a
changed detection shows.

  * ``-model_params`` with ``--modules`` prints JAX's lines, its
    ``count_params`` over the same config's params tree;
  * ``--data_size`` prints JAX's lines, with and without ``-resized``;
  * ``--split_model``: every image head -> bytes -> tail, its COCO stats
    and detections equal ``coco_evaluate``'s with the round trip on the
    same loader and weights;
  * ``--bottleneck_size`` logs the (C, H, W) of the b3ch bottleneck;
  * ``-skip_tail`` prints the head's latency and the wire's size only;
    bare selector flags mean ``test``;
  * ``--split_model --int8_tail`` calibrates the int8 tail and prints its
    latency and mAP delta lines in JAX's format; a 16-bit wire with
    ``--int8_tail`` raises, as JAX's assert does;
  * ``visualizer`` writes one overlay and one count line an image, from an
    image and from a directory.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from chip_smoke import live_norms_, teacher_annotations
from hnd_ghnd_tpu.models.convert import convert_state_dict
from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
from hnd_ghnd_tpu.runners import common as jax_common
from hnd_ghnd_tpu.runners import cost_analyzer as jax_cost
from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
from hnd_ghnd_tpu_torch.models.factory import get_model
from hnd_ghnd_tpu_torch.runners import common, cost_analyzer, visualizer
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
from tests.fixtures import make_coco_fixture
from tests.test_runners import dataset_block, model_block, tiny_tpu_block

LOGIT_SPREAD = 300.0
MODULES = ["backbone.body.layer1", "rpn.head"]


# The tier-1 run shares the machine's cores among its workers; torch's
# default of one thread a core then oversubscribes them.  This file's CPU
# forwards run on two.
THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, THREADS))
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(config path, config, image dir, root): a 2-image fixture whose
    annotations are the seeded student's own detections."""
    root = tmp_path_factory.mktemp("cost_tools")
    img_dir, ann_file = make_coco_fixture(str(root), num_images=2, seed=5)
    model_cfg = model_block("faster_rcnn", bottleneck=3, num_classes=5)
    model = live_norms_(get_model(model_cfg, seed=0, device="cpu"), 0)
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(LOGIT_SPREAD)
    ckpt = str(root / "student.pt")
    params, state = jax_params_from_state_dict(model.state_dict())
    ckpt_util.save_ckpt(ckpt, params=params, state=state)
    config = {"dataset": dataset_block(img_dir, ann_file),
              "student_model": dict(model_cfg, ckpt=ckpt),
              "test": {"batch_size": 1}, "tpu": tiny_tpu_block()}
    own = str(root / "own.json")
    n, _, _ = teacher_annotations(model, config, own)
    assert n > 0
    for split in config["dataset"]["splits"].values():
        split["annotations"] = own
    cfg_path = root / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    return str(cfg_path), config, img_dir, str(root)


def _args(cfg_path, *flags):
    return cost_analyzer.get_argparser().parse_args(
        ["--config", cfg_path, "--device", "cpu", *flags])


def test_model_params_print_jax_counts(setup, capsys):
    cfg_path, config, _, _ = setup
    out = cost_analyzer.main(_args(cfg_path, "-model_params", "--modules",
                                   *MODULES))
    got = capsys.readouterr().out
    model_cfg = config["student_model"]
    sd = get_model(model_cfg, device="cpu").state_dict()
    jax_cost.analyze_model_params(jax_build_model(model_cfg),
                                  convert_state_dict(sd)[0], MODULES)
    want = capsys.readouterr().out
    assert got == want
    assert "[Specified module(s)]" in got and "split head (edge)" in got
    counts = out["model_params"]
    assert counts["head"] + counts["tail"] == counts["total"]


@pytest.mark.parametrize("resized", [False, True], ids=["raw", "resized"])
def test_data_size_prints_jax_lines(setup, capsys, resized):
    cfg_path, config, _, _ = setup
    flags = ["--data_size", "test", "--max_images", "1"]
    cost_analyzer.main(_args(cfg_path, *flags,
                             *(["-resized"] if resized else [])))
    got = capsys.readouterr().out
    _, _, loader = jax_common.loaders_from_config(config, "faster_rcnn", 1)
    jax_cost.analyze_data_size(loader, 1, resized=resized)
    want = capsys.readouterr().out
    assert got == want
    assert "comm delay" in got and "Tensor shape" in got


def test_split_model_map_equals_round_trip_eval(setup, capsys):
    cfg_path, config, _, _ = setup
    out = cost_analyzer.main(_args(cfg_path, "--split_model",
                                   "--bottleneck_size"))
    printed = capsys.readouterr().out
    for line in ("head latency", "tail latency", "wire payload",
                 "bottleneck fp32", "bottleneck int8", "mAP"):
        assert line in printed, line
    assert out["bottleneck_size"].get_data()[3][0] == (3, 28, 28)
    split = out["split_model"]
    assert len(split["head_s"]) == len(split["tail_s"]) == 2
    model = get_model(config["student_model"], device="cpu")
    _, _, loader = common.loaders_from_config(config, model.kind, 1)
    ev, _ = common.coco_evaluate(model, loader, True)
    got = split["evaluator"]
    assert got.evals["bbox"].dts == ev.evals["bbox"].dts
    np.testing.assert_array_equal(got.stats["bbox"], ev.stats["bbox"])
    assert ev.stats["bbox"][0] > 0.5


def test_skip_tail_prints_head_and_wire_only(setup, capsys):
    cfg_path, _, _, _ = setup
    args = _args(cfg_path, "--split_model", "test", "-skip_tail",
                 "--quantize", "8", "--max_images", "1")
    assert args.split_model == "test" and args.skip_tail
    assert args.quantization == 8
    out = cost_analyzer.main(args)
    printed = capsys.readouterr().out
    assert "head latency" in printed and "wire payload" in printed
    assert "tail latency" not in printed and "mAP" not in printed
    assert out["split_model"]["evaluator"] is None
    assert len(out["split_model"]["wire_kb"]) == 1


def test_bare_selector_flags_mean_test():
    args = cost_analyzer.get_argparser().parse_args(
        ["--config", "x", "--split_model", "--bottleneck_size"])
    assert args.split_model == "test"
    assert args.bottleneck_size == "test"
    assert args.data_size is None
    assert args.device == "cuda"


def test_int8_tail_prints_latency_and_map_delta(setup, capsys):
    cfg_path, _, _, _ = setup
    out = cost_analyzer.main(_args(cfg_path, "--split_model", "--int8_tail",
                                   "--calib_images", "1"))
    printed = capsys.readouterr().out
    assert "int8 tail calibrated on 1 images (44 activation sites)" in printed
    assert "int8 tail latency:" in printed
    assert "int8 tail evaluation:" in printed
    split = out["split_model"]
    assert len(split["int8_tail_s"]) == len(split["tail_s"]) == 2
    delta = split["int8_map_delta"]["bbox"]
    stats, stats8 = (split[k].stats["bbox"]
                     for k in ("evaluator", "int8_evaluator"))
    assert delta == float(stats8[0]) - float(stats[0])
    assert (f"int8 tail mAP delta [bbox]: {delta:+.4f} (fp {stats[0]:.4f} "
            f"-> int8 {stats8[0]:.4f})") in printed


def test_int8_tail_requires_an_8_bit_wire(setup):
    cfg_path, _, _, _ = setup
    with pytest.raises(ValueError, match="8-bit wire"):
        cost_analyzer.main(_args(cfg_path, "--split_model", "--int8_tail",
                                 "--quantization", "16"))


@pytest.mark.parametrize("from_dir", [False, True], ids=["image", "dir"])
def test_visualizer_writes_one_overlay_an_image(setup, capsys, from_dir):
    import cv2
    cfg_path, _, img_dir, root = setup
    names = sorted(os.listdir(img_dir))
    inputs = [img_dir] if from_dir else [os.path.join(img_dir, names[0])]
    want = names if from_dir else names[:1]
    out_dir = os.path.join(root, f"viz_{from_dir}")
    args = visualizer.get_argparser().parse_args(
        ["--config", cfg_path, "--device", "cpu", "--image", *inputs,
         "--output", out_dir, "--score_threshold", "0.5"])
    written = visualizer.main(args)
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(os.listdir(out_dir)) == want
    assert written == [os.path.join(out_dir, n) for n in want]
    assert len(lines) == len(want)
    for name, line in zip(want, lines):
        assert line.startswith(os.path.join(img_dir, name) + ": ")
        assert "detections >= 0.5" in line and int(line.split()[1]) > 0
        im = cv2.imread(os.path.join(out_dir, name))
        src = cv2.imread(os.path.join(img_dir, name))
        assert im is not None and im.shape == src.shape
