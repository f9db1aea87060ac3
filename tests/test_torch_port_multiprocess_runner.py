"""``mimic_runner.main`` as two ranks on the CPU, over gloo.

The ranks are spawned by tests/test_torch_port_multiprocess.py's ``Ranks``
without a group; each calls ``mimic_runner.main`` with ``--world_size 2
--dist_url env://`` and RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT in its environment, as ``torchrun`` sets them, so ``main``
parses the launch and makes the group.  The train split has two buckets,
64x96 and 96x64: 8 images at batch 2 a rank, shard 0 with two portrait
images and shard 1 with one (chip_smoke.two_bucket_shapes), so that the
shards fill 2 and 3 batches (each bucket's remainder is padded into a
batch) and each rank must stop at the loader's length, 2, or wait alone
in the step's collectives.  The val and test splits (tests/fixtures.py)
hold 2 images, one per rank.  The b3ch student resumes from a checkpoint
whose best val mAP is -1, so that the first epoch's merged mAP (0 on
random weights) rises above it and rank 0 writes the checkpoint.

  * the shards' own batch counts differ;
  * both ranks run 2 steps and log the same global loss and terms, and see
    the same merged val and test stats;
  * one checkpoint, with no temporary file beside it, written by rank 0
    (only rank 0 prints), read by the JAX package's ``load_ckpt``;
  * both ranks end with the group destroyed.
"""
import json
import os

import numpy as np
import pytest
import yaml

from chip_smoke import (STUDENT_MODEL, TEACHER_MODEL, TRAIN,
                        two_bucket_shapes, write_runner_fixture)
from hnd_ghnd_tpu_torch.parallel import multihost
from tests.test_torch_port_multiprocess import Ranks, WORLD

RUNNER_TIMEOUT_S = 180.0
TRAIN_IMAGES, TRAIN_BATCH, EVAL_IMAGES = 8, 2, 2
PORTRAITS = (2, 1)      # of each shard's 4 train images
LANDSCAPE, PORTRAIT = (48, 72), (72, 48)
TINY_TPU = {"buckets": [[64, 96], [96, 64]], "min_sizes": [64],
            "max_size": 96, "compute_dtype": "float32",
            "eval_batch_size": 1}


def task_main(config_path: str):
    import contextlib
    import io
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = mimic_runner.main(mimic_runner.get_argparser().parse_args(
            ["--config", config_path, "--device", "cpu", "--world_size",
             str(WORLD), "--dist_url", "env://", "-distill",
             "-transform_bottleneck", "-student_only"]))
    result["distill"]["epochs"] = [
        {k: e[k] for k in ("val_map", "saved", "stats")}
        for e in result["distill"]["epochs"]]
    result["stdout"] = out.getvalue()
    result["group_up"] = multihost.group_up()
    return result


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    # the ranks start (import torch) while the fixture is written
    ranks = Ranks(module=__name__, init_group=False)
    ranks.start()
    try:
        path, ckpt = write_case(tmp_path_factory.mktemp("mp_runner"))
        outs = ranks.run("task_main", timeout=RUNNER_TIMEOUT_S,
                         config_path=path)
    finally:
        ranks.close()
    return ckpt, outs, path


def write_case(root):
    """The fixture, the student's starting checkpoint and the YAML.
    Returns (the YAML's path, the checkpoint's)."""
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.utils import ckpt as port_ckpt
    from tests.fixtures import make_coco_fixture
    shapes = two_bucket_shapes(TRAIN_IMAGES, PORTRAITS, LANDSCAPE, PORTRAIT)
    train = write_runner_fixture(str(root), np.random.RandomState(1),
                                 {"train": TRAIN_IMAGES}, tuple(shapes))
    val = make_coco_fixture(str(root / "val"), EVAL_IMAGES, seed=2,
                            num_classes=4)
    splits = {name: {"images": img_dir, "annotations": ann,
                     "remove_non_annotated_imgs": False, "jpeg_quality": None}
              for name, (img_dir, ann) in (("train", train["train"]),
                                           ("val", val))}
    splits["test"] = splits["val"]
    params = {"num_classes": 5, "pretrained": False}
    student_cfg = dict(STUDENT_MODEL, params=params,
                       ckpt=str(root / "ckpt" / "student.pt"))
    student = get_model(student_cfg, seed=1, device="cpu")
    weights, state = jax_params_from_state_dict(student.state_dict())
    port_ckpt.save_ckpt(student_cfg["ckpt"], params=weights, state=state,
                        best_value=-1.0)
    config = {"dataset": {"name": "fixture", "num_workers": 2,
                          "splits": splits},
              "teacher_model": dict(TEACHER_MODEL, params=params),
              "student_model": student_cfg,
              "train": dict(TRAIN, batch_size=TRAIN_BATCH, num_epochs=1),
              "test": {"batch_size": 1}, "tpu": TINY_TPU}
    path = str(root / "mp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(config)), f)
    return path, student_cfg["ckpt"]


def test_the_shards_fill_other_batch_counts(two_ranks):
    from hnd_ghnd_tpu_torch.core.config import load_config
    from hnd_ghnd_tpu_torch.runners import common
    _, _, path = two_ranks
    loaders = [common.loaders_from_config(
        load_config(path), "faster_rcnn", TRAIN_BATCH, shard_index=r,
        num_shards=WORLD)[0] for r in range(WORLD)]
    assert [len(loader) for loader in loaders] == [2, 2]
    assert [sum(1 for _ in loader) for loader in loaders] == [2, 3]


def test_two_ranks_log_the_same_global_run(two_ranks):
    _, (r0, r1), _ = two_ranks
    steps = [s[:3] for s in r0["distill"]["steps"]]
    assert [s[0] for s in steps] == [0, 1]      # len(loader) on both ranks
    assert steps == [s[:3] for s in r1["distill"]["steps"]]
    for _, loss, terms in steps:
        assert np.isfinite(loss) and len(terms) == 4
    assert r0["distill"]["epochs"] == r1["distill"]["epochs"]
    (epoch,) = r0["distill"]["epochs"]
    assert epoch["saved"]
    assert r0["student"]["stats"] == r1["student"]["stats"]
    assert not r0["group_up"] and not r1["group_up"]
    # rank 0 alone prints
    assert "saved best ckpt" in r0["stdout"] and "2 process(es)" in \
        r0["stdout"]
    assert r1["stdout"] == ""


def test_rank_0_writes_one_checkpoint_jax_reads(two_ranks):
    from hnd_ghnd_tpu.utils import ckpt as jax_ckpt
    path, (r0, _), _ = two_ranks
    assert os.listdir(os.path.dirname(path)) == ["student.pt"]
    payload = jax_ckpt.load_ckpt(path)
    (epoch,) = r0["distill"]["epochs"]
    assert payload["best_value"] == epoch["val_map"]
    assert payload["lr_step"] == len(r0["distill"]["steps"])
    assert payload["torch_opt_state"]["state"]
    assert payload["params"]["backbone"]["body"]["layer1"]
