"""The port's distill step at two ranks with the org term and in bfloat16.

Two ranks on the CPU over gloo, spawned once for the module
(tests/test_torch_port_multiprocess.py's ``Ranks``); this module's
``task_*`` functions import no JAX.

  * with ``org_loss_factor != 0`` the step keeps JAX's ``shard_map``
    semantics (hnd_ghnd_tpu/parallel/mesh.py:298-307): each rank's loss on
    its own shard with BN statistics of its own shard and its own draws
    (``fold_in(seed, rank)``), the gradients, loss, terms and float
    buffers averaged.  Two ranks equal the average of two one-process
    port steps, one per shard;
  * the bfloat16 step without the org term keeps JAX's GSPMD sum and the
    cross-process BN: two ranks on half batches equal one process on the
    whole batch.
"""
import copy

import numpy as np
import pytest
import torch

from chip_smoke import STUDENT_MODEL, TEACHER_MODEL, TRAIN
from hnd_ghnd_tpu_torch.parallel import multihost
from tests.test_torch_port_multiprocess import (AVG_TOL, DET_SEED,
                                                MEAN_SGD, SGD, WORLD,
                                                ZERO_GRAD, ZERO_GRAD_TOL,
                                                Ranks, detection_shard,
                                                distill_images,
                                                distill_weights,
                                                float_buffers, shard,
                                                trained_state)

# HND's layer1 term at 1e-5 (the MSE sum is ~1e5 at 64x96, the detection
# losses ~6) with org_loss_factor 1: both shares reach the gradients
ORG_CRITERION = {"type": "general", "params": {"org_loss_factor": 1.0},
                 "terms": {"layer1": dict(TRAIN["criterion"]["terms"]
                                          ["layer1"], factor=1e-5)}}


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks(module=__name__)
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def one_process():
    pool = Ranks(world=1, module=__name__, init_group=False)
    yield pool
    pool.close()


def org_box():
    """The seeded teacher and b3ch student with the 91 classes of
    ``detection_shard``'s labels."""
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.models.factory import get_model
    params = {"num_classes": 91, "pretrained": False}
    teacher = get_model(dict(TEACHER_MODEL, params=params), seed=0,
                        device="cpu")
    student = get_model(dict(STUDENT_MODEL, params=params), seed=1,
                        device="cpu")
    teacher.eval().requires_grad_(False)
    return DistillationBox(teacher, student.train(), ORG_CRITERION)


def task_distill_org():
    from hnd_ghnd_tpu_torch.parallel.train_step import make_distill_train_step
    box = org_box()
    step = make_distill_train_step(box, MEAN_SGD, compute_dtype=torch.float32,
                                   seed=DET_SEED)
    with torch.backends.mkldnn.flags(enabled=False):
        loss, terms = step(*detection_shard(multihost.get_rank()))
    return {"loss": float(loss), "terms": {k: float(v) for k, v in
                                           terms.items()},
            "params": {n: p.detach().numpy().copy() for n, p in
                       box.student.named_parameters() if p.requires_grad},
            "buffers": float_buffers(box.student)}


def task_distill_org_reference():
    """The manual average of two one-process steps, one per shard with its
    rank's draws: gradients, float buffers and terms averaged, then the
    update."""
    from hnd_ghnd_tpu_torch.parallel.train_step import (
        make_distill_train_step, uniform_draw)
    box = org_box()
    student = box.student
    step = make_distill_train_step(box, MEAN_SGD, compute_dtype=torch.float32,
                                   seed=DET_SEED)
    start = {n: b.clone() for n, b in student.named_buffers()}
    trainable = [(n, p) for n, p in student.named_parameters()
                 if p.requires_grad]
    before = {n: p.detach().numpy().copy() for n, p in trainable}
    grads, buffers, losses = [], [], []
    for r in range(WORLD):
        student.load_state_dict(start, strict=False)
        step.optimizer.zero_grad(set_to_none=True)
        draw = uniform_draw(torch.Generator().manual_seed(
            multihost.fold_in(DET_SEED, r)))
        batch, targets = detection_shard(r)
        with torch.backends.mkldnn.flags(enabled=False):
            total, terms = box.loss(batch["images"], targets, draw,
                                    batch["image_sizes"])
            total.backward()
        grads.append([p.grad.clone() for _, p in trainable])
        buffers.append(float_buffers(student))
        losses.append((float(total.detach()),
                       {k: float(v.detach()) for k, v in terms.items()}))
    for i, (_, p) in enumerate(trainable):
        p.grad = (grads[0][i] + grads[1][i]) / 2
    with torch.no_grad():
        for n, b in student.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.from_numpy((buffers[0][n] + buffers[1][n]) / 2))
    step.apply_update()
    return {"before": before, "losses": losses, "shard_buffers": buffers,
            "params": {n: p.detach().numpy().copy() for n, p in trainable},
            "buffers": float_buffers(student)}


def test_org_distill_step_at_two_ranks_averages_the_shards(ranks,
                                                           one_process):
    ranks.submit("task_distill_org")
    (ref,) = one_process.run("task_distill_org_reference")
    outs = ranks.collect()
    losses, before = ref["losses"], ref["before"]
    want_loss = (losses[0][0] + losses[1][0]) / 2
    want_terms = {k: (losses[0][1][k] + losses[1][1][k]) / 2
                  for k in losses[0][1]}
    assert set(want_terms) == {"layer1", "org_loss_classifier",
                               "org_loss_box_reg", "org_loss_objectness",
                               "org_loss_rpn_box_reg"}
    moves = {n: ref["params"][n] - p0 for n, p0 in before.items()}
    moved = 0
    for out in outs:
        assert out["terms"].keys() == want_terms.keys()
        for k, v in want_terms.items():
            assert out["terms"][k] == pytest.approx(v, rel=AVG_TOL), k
        assert out["loss"] == pytest.approx(want_loss, rel=AVG_TOL)
        assert out["params"].keys() == before.keys()
        for n, p0 in before.items():
            got = out["params"][n] - p0
            if n in ZERO_GRAD:
                scale = np.abs(moves[n[:-len("bias")] + "weight"]).max()
                for u in (got, moves[n]):
                    assert np.abs(u).max() <= ZERO_GRAD_TOL * scale, n
                continue
            scale = np.abs(moves[n]).max()
            moved += scale > 0
            ulp = np.spacing(np.abs(p0).max())
            assert np.abs(got - moves[n]).max() <= AVG_TOL * scale + ulp, n
        for n, b in ref["buffers"].items():
            assert np.abs(out["buffers"][n] - b).max() <= \
                AVG_TOL * np.abs(b).max(), n
    assert moved > 0
    # each rank drew its own proposals, and its BNs saw its own image: the
    # terms are each shard's own (1/N of a global sum), not the GSPMD sum
    assert losses[0] != losses[1]
    name = "backbone.body.layer1.encoder.encoder.1.running_mean"
    shards = ref["shard_buffers"]
    assert not np.array_equal(shards[0][name], shards[1][name])


def task_distill_dtype(sharded: bool, dtype: str):
    """Two HND steps in ``dtype``, on this rank's half batches or, with
    ``sharded`` off, on the whole batches in one process."""
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.parallel.train_step import make_distill_train_step
    from tests.test_torch_port_multiprocess import HND_CRITERION
    teacher, student = distill_weights()
    teacher.eval().requires_grad_(False)
    student.train()
    step = make_distill_train_step(
        DistillationBox(teacher, student, HND_CRITERION), SGD,
        compute_dtype=getattr(torch, dtype))
    before = copy.deepcopy(trained_state(student))
    losses = []
    with torch.backends.mkldnn.flags(enabled=False):
        for images in distill_images():
            loss, terms = step({"images": torch.from_numpy(
                shard(images) if sharded else images)})
            assert loss.dtype == torch.float32
            losses.append((float(loss), {k: float(v)
                                         for k, v in terms.items()}))
    return {"losses": losses, "before": before,
            "state": trained_state(student)}


def test_bf16_distill_step_at_two_ranks_is_one_process(ranks, one_process):
    """Two bfloat16 steps: the ranks' losses, terms and trained state
    against one process's on the whole batches, each within twice that
    process's own bfloat16-vs-float32 gap (the scheme of
    tests/test_torch_port_distill_org.py); the ranks hold the same state
    bit for bit."""
    ranks.submit("task_distill_dtype", sharded=True, dtype="bfloat16")
    ref, ref32 = (one_process.run("task_distill_dtype", sharded=False,
                                  dtype=d)[0]
                  for d in ("bfloat16", "float32"))
    outs = ranks.collect()
    assert len(ref["losses"]) == 2 and ref["losses"][0][1].keys() == {
        "layer1"}
    for out in outs:
        for (loss, terms), (w_loss, w_terms), (f_loss, f_terms) in zip(
                out["losses"], ref["losses"], ref32["losses"]):
            for got, want, f32 in [(loss, w_loss, f_loss)] + [
                    (terms[k], w_terms[k], f_terms[k]) for k in w_terms]:
                gap = abs(want - f32)
                assert gap > 0 and abs(got - want) <= 2.0 * gap
    for k in ref["state"]:
        np.testing.assert_array_equal(outs[0]["state"][k],
                                      outs[1]["state"][k])
    moved = 0
    for k, want in ref["state"].items():
        if k in ZERO_GRAD:
            continue
        gap = np.abs(want - ref32["state"][k]).max()
        err = np.abs(outs[0]["state"][k] - want).max()
        assert gap > 0 and err <= 2.0 * gap, (k, err, gap)
        moved += not np.array_equal(want, ref["before"][k])
    assert moved == len(ref["state"]) - len(ZERO_GRAD)
