"""The port's local mode (hnd_ghnd_tpu_torch/parallel/mesh.py) against the
JAX package's one-process mesh over every local chip, on the CPU.

JAX runs in this process on the 8 host devices tests/conftest.py gives
it.  The port's workers are spawned over gloo, two OpenMP threads each:
the distill epoch through ``mimic_runner.run``'s own launch, the val eval
and a failing worker through ``mesh.launch_local``.  A worker imports
this module, which imports no JAX at its top (JAX is imported inside the
tests).

  * ``mesh_size_for_batch`` equals ``make_mesh_for_batch``'s device count
    over a grid of batches and device counts;
  * each worker's loader (``rows=(k, 2)``), on a train split with two
    buckets and padded remainders (the val split has one bucket), yields the rows ``put_batch`` puts on
    device k of a 2-device mesh (images, sizes, targets, padding flags),
    decoding only its own rows;
  * the 2-worker val eval with ``-transform_bottleneck`` at eval batch 2
    equals JAX's ``evaluate(..., mesh=<2 devices>)`` on the same weights:
    each worker's quantizer scale is JAX's on that device's rows, every
    JAX detection is the port's within SCORE_TOL and BOX_TOL, and the
    COCOeval stats agree within STATS_TOL;
  * one epoch of ``mimic_runner -distill`` at 2 local workers equals one
    port process at the same global batch: the logged losses within
    LOSS_TOL, each leaf's move within MOVE_TOL, the trainable BatchNorms'
    statistics within STATS_BN_TOL (a mean in units of its standard
    deviation);
  * ``--world_size 1``, one device, a launch, a pinned card and the CPU
    keep one process; a worker that raises fails the launch.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from chip_smoke import STUDENT_MODEL, TEACHER_MODEL, TRAIN, \
    write_runner_fixture
from hnd_ghnd_tpu_torch.parallel import mesh, multihost
from tests.test_torch_port_multiprocess import THREADS
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

NUM_CLASSES = 5
TINY_TPU = {"buckets": [[64, 96], [96, 64]], "min_sizes": [64],
            "max_size": 96, "compute_dtype": "float32",
            "eval_batch_size": 2}
LANDSCAPE, PORTRAIT = (48, 72), (72, 48)
TRAIN_IMAGES, VAL_IMAGES, BATCH, WORKERS = 10, 4, 4, 2
# the eval's detections against JAX's (tests/test_torch_port_slice.py)
SCORE_TOL = 1e-5
BOX_TOL = 1e-4 * 96
# COCOeval on detections that agree to float noise: a stat moves only
# where a box crosses an IoU threshold or two scores swap
# (tests/test_torch_port_runner.py); 1.5e-3 on this fixture
STATS_TOL = 0.02
# the quantizer's scale of the same rows: one float32 division of the
# same max and min
SCALE_TOL = 1e-6
# two workers' summed float32 gradients against one process's sums (the
# same numbers in another order), through 3 SGD steps whose moves are
# linear in the gradient
LOSS_TOL = 1e-5
MOVE_TOL = 1e-4
STATS_BN_TOL = 1e-5
SGD = {"type": "SGD", "params": {"lr": 1e-7, "momentum": 0.9}}
LAUNCH_TIMEOUT_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def pure_host_prep():
    """Both packages on their pure host path (tests/test_torch_port_data
    .py); the spawned workers inherit the switch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HND_TPU_NATIVE_PREP", "0")
        yield


@pytest.fixture
def worker_threads():
    """The spawned workers' OpenMP threads (C14)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", str(THREADS))
        yield


def split(img_dir, ann):
    return {"images": img_dir, "annotations": ann,
            "remove_non_annotated_imgs": False, "jpeg_quality": None}


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("local_mesh"))
    # train: both buckets; val: one (JAX compiles one eval program)
    fx = write_runner_fixture(root, np.random.RandomState(3),
                              {"train": TRAIN_IMAGES}, (LANDSCAPE, PORTRAIT))
    fx.update(write_runner_fixture(root, np.random.RandomState(4),
                                   {"val": VAL_IMAGES}, (LANDSCAPE,)))
    return root, {name: split(*paths) for name, paths in fx.items()}


def loader_config(splits):
    return {"dataset": {"name": "fixture", "num_workers": 2,
                        "splits": dict(splits, test=splits["val"])},
            "tpu": TINY_TPU, "test": {"batch_size": 1}}


# ------------------------------------------------------------ the mesh


@pytest.mark.parametrize("devices", range(1, 9))
def test_mesh_size_for_batch_equals_jax(devices):
    import jax
    from hnd_ghnd_tpu.parallel.mesh import make_mesh_for_batch
    for batch in range(1, 33):
        want = make_mesh_for_batch(batch, jax.devices()[:devices])
        assert mesh.mesh_size_for_batch(batch, devices) == \
            want.devices.size, (batch, devices)


class Flags:
    world_size = dist_url = coordinator_address = None
    num_processes = process_id = None
    device = "cuda"

    def __init__(self, **kw):
        self.__dict__.update(kw)


CPU2, CPU4 = ["cpu"] * 2, ["cpu"] * 4


@pytest.mark.parametrize("flags, devices, env, batch, want", [
    ({"world_size": 1}, CPU2, {}, 4, None),
    ({}, ["cpu"], {}, 4, None),
    ({"device": "cuda"}, None, {}, 4, None),    # no card here: one process
    ({"device": "cuda:0"}, None, {}, 4, None),  # a pinned card
    ({"device": "cpu"}, None, {}, 4, None),
    ({}, CPU2, {"RANK": "0", "WORLD_SIZE": "2"}, 4,
     None),                                     # torchrun's launch
    ({"process_id": 1, "num_processes": 2}, CPU2, {}, 4, None),
    ({}, CPU2, {}, 3, None),                    # 1 divides a batch of 3
    ({}, CPU2, {}, 4, 2),
    ({"world_size": 3}, CPU4, {}, 4, 2),
    ({}, CPU4, {}, 6, 3),
    ({}, ["cuda:0", "cuda:0"], {}, 2, 2),
])
def test_local_devices(monkeypatch, flags, devices, env, batch, want):
    for key in ("RANK", "WORLD_SIZE", "JAX_PROCESS_ID", "JAX_NUM_PROCESSES",
                "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = mesh.local_devices(Flags(**flags), batch, devices)
    assert (None if got is None else len(got)) == want


def test_one_process_runs_here_and_two_devices_share_over_gloo():
    from hnd_ghnd_tpu_torch.runners import common
    args = Flags(device="cpu", world_size=1)
    device = common.launch(lambda config, a, d: d,
                           {"train": {"batch_size": 4}}, args, CPU2)
    assert device == torch.device("cpu") and not multihost.group_up()

    def backend(*names):
        return mesh.backend_for([torch.device(n) for n in names])
    assert backend("cpu", "cpu") == "gloo"
    assert backend("cuda:0", "cuda:0") == "gloo"
    assert backend("cuda:0", "cuda:1") == "nccl"


def task_raise(device):
    if multihost.get_rank() == 1:
        raise RuntimeError("worker 1 fails")
    multihost.barrier()     # worker 0 waits for it in a collective


def test_a_worker_that_raises_fails_the_launch(worker_threads):
    import time
    t0 = time.perf_counter()
    with pytest.raises(tmp.ProcessExitedException, match="exit code 1"):
        mesh.launch_local(task_raise, ["cpu", "cpu"], (),
                          timeout_s=LAUNCH_TIMEOUT_S)
    assert time.perf_counter() - t0 < LAUNCH_TIMEOUT_S


# ---------------------------------------------------------- the loader


def test_worker_rows_equal_put_batch(fixture, monkeypatch):
    import jax
    from hnd_ghnd_tpu.parallel.mesh import make_mesh_for_batch, put_batch
    from hnd_ghnd_tpu.runners import common as jax_common
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset
    from hnd_ghnd_tpu_torch.runners import common
    _, splits = fixture
    config = loader_config(splits)
    jax_train = jax_common.loaders_from_config(config, "faster_rcnn",
                                               BATCH)[0]
    device_mesh = make_mesh_for_batch(BATCH, jax.devices()[:WORKERS])
    assert device_mesh.devices.size == WORKERS
    want = [[] for _ in range(WORKERS)]
    pads = []
    for batch, targets, host in jax_train:
        pads.append([t["is_padding"] for t in host])
        sharded = put_batch({**batch, **targets}, device_mesh)
        for key, arr in sharded.items():
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            for k in range(WORKERS):
                if len(want[k]) < len(pads):
                    want[k].append({})
                want[k][-1][key] = np.asarray(shards[k].data)
    assert any(any(p) for p in pads), "the fixture must pad a remainder"
    assert len({v["images"].shape for v in want[0]}) == 2, "two buckets"
    decoded = []
    getitem = CocoDataset.__getitem__
    monkeypatch.setattr(CocoDataset, "__getitem__",
                        lambda self, i: decoded.append(i) or getitem(self,
                                                                     i))
    base = common.loaders_from_config(config, "faster_rcnn", BATCH)[0]
    for k in range(WORKERS):
        loader = type(base)(base.dataset, BATCH, training=True,
                            min_sizes=base.min_sizes, max_size=base.max_size,
                            buckets=base.buckets, num_workers=2,
                            rows=(k, WORKERS))
        decoded.clear()
        got = list(loader)
        assert len(got) == len(want[k])
        # one decode an image of its rows: a padding row reuses its image
        assert len(decoded) == sum(len({t["image_id"] for t in host})
                                   for _, _, host in got)
        for i, (batch, targets, host) in enumerate(got):
            rows = want[k][i]
            for key, value in {**batch, **targets}.items():
                np.testing.assert_array_equal(value, rows[key],
                                              err_msg=f"{k} {i} {key}")
            n = BATCH // WORKERS
            assert [t["is_padding"] for t in host] == \
                pads[i][k * n:(k + 1) * n]


# ------------------------------------------------------------ the eval


def task_val_eval(config, ckpt, device):
    """A worker's val eval with the bottleneck round trip: the scale of
    each quantize it runs, and the merged evaluator's detections and
    stats (rank 0's)."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.ops import quant_kernels
    from hnd_ghnd_tpu_torch.runners import common
    scales = []
    quantize = quant_kernels.quantize

    def recording(x, num_bits=8):
        q = quantize(x, num_bits)
        scales.append(float(q.scale))
        return q

    quant_kernels.quantize = recording
    model = get_model(dict(STUDENT_MODEL, ckpt=ckpt), device=device)
    _, val, _ = common.loaders_from_config(config, model.kind, 1)
    evaluator, _ = common.coco_evaluate(model.eval(), val, True)
    dts = {f"{i} {c}": [(d["score"], d["bbox"]) for d in v]
           for (i, c), v in evaluator.evals["bbox"].dts.items()}
    return {"scales": multihost.all_gather_objects(scales),
            "stats": evaluator.stats["bbox"].tolist(), "dts": dts}


def test_two_worker_val_eval_equals_jax_mesh_eval(fixture, worker_threads):
    import jax
    import jax.numpy as jnp
    from chip_smoke import teacher_annotations
    from hnd_ghnd_tpu.parallel.mesh import make_mesh_for_batch
    from hnd_ghnd_tpu.runners import common as jax_common
    from hnd_ghnd_tpu.split.deploy import SplitRCNN
    from chip_smoke import live_norms_
    from hnd_ghnd_tpu.models.convert import convert_state_dict
    from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.utils import ckpt as port_ckpt
    root, splits = fixture
    # the seeded student with live BatchNorms, and JAX's model on its
    # weights (tests/test_torch_port_weights.live_models, without JAX's
    # own init)
    pm = live_norms_(get_model(STUDENT_MODEL, seed=0, device="cpu"), 0)
    params, state = convert_state_dict(pm.state_dict())
    jm = jax_build_model(STUDENT_MODEL)
    cls = params["roi_heads"]["box_predictor"]["cls_score"]
    cls["w"] = cls["w"] * np.float32(300.0)
    with torch.no_grad():
        pm.roi_heads.box_predictor.cls_score.weight.mul_(300.0)
    ckpt = os.path.join(root, "eval_student.pt")
    weights, buffers = jax_params_from_state_dict(pm.state_dict())
    port_ckpt.save_ckpt(ckpt, params=weights, state=buffers)
    config = loader_config(splits)
    gt = os.path.join(root, "val_gt.json")
    n_gt, _, _ = teacher_annotations(pm, config, gt)
    # every second of the model's own boxes: the rest are false positives,
    # so that AP lies strictly between 0 and 1
    with open(gt) as f:
        coco = json.load(f)
    coco["annotations"] = coco["annotations"][::2]
    with open(gt, "w") as f:
        json.dump(coco, f)
    assert n_gt > 1
    config["dataset"]["splits"]["val"] = dict(splits["val"], annotations=gt)
    config["dataset"]["splits"]["test"] = config["dataset"]["splits"]["val"]
    got = mesh.launch_local(task_val_eval, ["cpu", "cpu"], (config, ckpt),
                            timeout_s=LAUNCH_TIMEOUT_S)

    _, val, _ = jax_common.loaders_from_config(config, jm.kind, 1)
    device_mesh = make_mesh_for_batch(TINY_TPU["eval_batch_size"],
                                      jax.devices()[:WORKERS])
    want = jax_common.evaluate(jm, params, state, val,
                               use_bottleneck_transformer=True,
                               mesh=device_mesh)
    # each device's scale: JAX's quantizer on that device's rows alone
    head = SplitRCNN(jm, 8)
    n = TINY_TPU["eval_batch_size"] // WORKERS
    for b, (batch, _, _) in enumerate(val):
        for k in range(WORKERS):
            rows = jnp.asarray(batch["images"][k * n:(k + 1) * n])
            scale = float(head.head_fn(params, state, rows)[1])
            assert abs(got["scales"][k][b] - scale) <= SCALE_TOL * scale
        assert got["scales"][0][b] != got["scales"][1][b]
    jax_dts = want.evals["bbox"].dts
    assert sum(map(len, got["dts"].values())) == \
        sum(map(len, jax_dts.values())) > 0
    for (img, cat), dets in jax_dts.items():
        port = got["dts"][f"{img} {cat}"]
        for d in dets:
            assert any(abs(s - d["score"]) <= SCORE_TOL and np.abs(
                np.subtract(box, d["bbox"])).max() <= BOX_TOL
                for s, box in port), (img, cat, d)
    np.testing.assert_allclose(got["stats"], want.stats["bbox"],
                               atol=STATS_TOL)
    assert 0 < want.stats["bbox"][0] < 1


# ------------------------------------------------------- the distill epoch


@pytest.fixture(scope="module")
def distill_case(fixture):
    from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.utils import ckpt as port_ckpt
    root, splits = fixture
    model_params = {"num_classes": NUM_CLASSES, "pretrained": False}
    student_cfg = dict(STUDENT_MODEL, params=model_params)
    student = get_model(student_cfg, seed=1, device="cpu")
    names = [n for n, p in student.named_parameters() if p.requires_grad]
    weights, buffers = jax_params_from_state_dict(student.state_dict())
    ckpts = {}
    for tag in ("start", "local", "one"):
        ckpts[tag] = os.path.join(root, f"distill_{tag}.pt")
        port_ckpt.save_ckpt(ckpts[tag], params=weights, state=buffers,
                            best_value=-1.0)
    # val and test: the first two images of the val split (one val batch
    # of 2, a row a worker; the test's images one a worker)
    with open(splits["val"]["annotations"]) as f:
        coco = json.load(f)
    coco["images"] = coco["images"][:2]
    coco["annotations"] = [a for a in coco["annotations"] if a["image_id"]
                           in {im["id"] for im in coco["images"]}]
    ann = os.path.join(root, "val_two.json")
    with open(ann, "w") as f:
        json.dump(coco, f)
    config = loader_config(dict(splits, val=dict(splits["val"],
                                                 annotations=ann)))
    config.update(teacher_model=dict(TEACHER_MODEL, params=model_params),
                  train=dict(TRAIN, batch_size=BATCH, num_epochs=1,
                             optimizer=SGD))
    return config, student_cfg, ckpts, names


def run_distill(config, student_cfg, ckpt, devices=None):
    import contextlib
    import io
    from hnd_ghnd_tpu_torch.runners import mimic_runner
    args = mimic_runner.get_argparser().parse_args(
        ["--config", "unused.yaml", "--device", "cpu", "-distill",
         "-student_only"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = mimic_runner.run(
            dict(config, student_model=dict(student_cfg, ckpt=ckpt)), args,
            devices)
    return result, out.getvalue()


def test_local_distill_epoch_equals_one_process(distill_case,
                                                worker_threads):
    from hnd_ghnd_tpu_torch.runners.common import \
        loaders_from_config as port_loaders
    from tests.test_torch_port_multiprocess import ZERO_GRAD
    from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
    from hnd_ghnd_tpu_torch.utils import ckpt as port_ckpt
    config, student_cfg, ckpts, names = distill_case
    local, stdout = run_distill(config, student_cfg, ckpts["local"], CPU2)
    assert "local mode: 2 workers on cpu, cpu (gloo), global batch 4" in \
        stdout
    assert not multihost.group_up()
    one, _ = run_distill(config, student_cfg, ckpts["one"])
    train = port_loaders(config, "faster_rcnn", BATCH)[0]
    n_batches = sum(1 for _ in train)
    assert n_batches > len(train)   # the padded remainders run too
    for run in (local, one):
        assert len(run["distill"]["steps"]) == n_batches
        assert run["distill"]["epochs"][0]["saved"]
    for (_, loss, terms, _), (_, w_loss, w_terms, _) in zip(
            local["distill"]["steps"], one["distill"]["steps"]):
        assert abs(loss - w_loss) <= LOSS_TOL * abs(w_loss)
        for k, v in w_terms.items():
            assert abs(terms[k] - v) <= LOSS_TOL * abs(v), k

    def state(path):
        payload = port_ckpt.load_ckpt(path)
        return {k: torch.as_tensor(np.asarray(v)).double() for k, v in
                state_dict_from_jax(payload["params"],
                                    payload["state"]).items()}

    start, got, want = (state(ckpts[t]) for t in ("start", "local", "one"))
    for name in names:
        if name in ZERO_GRAD:   # moved by float noise alone
            continue
        moved = want[name] - start[name]
        err = float((got[name] - start[name] - moved).norm() / moved.norm())
        assert err <= MOVE_TOL, (name, err)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))
             and not torch.equal(want[k], start[k])]
    assert stats
    for k in stats:
        assert bn_stat_err(got, want, k) <= STATS_BN_TOL, k


def bn_stat_err(got: dict, want: dict, key: str) -> float:
    """A BatchNorm statistic's distance from ``want``'s: a variance's over
    its norm, a mean's over the norm of the standard deviation beside it
    (a mean near 0 has no relative precision of its own)."""
    if key.endswith("running_var"):
        scale = want[key].norm()
    else:
        scale = want[key[:-len("mean")] + "var"].sqrt().norm()
    return float((got[key] - want[key]).norm() / scale)
