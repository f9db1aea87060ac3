"""The port's multi-process steps against the JAX package's global batch.

Two ranks run on the CPU over gloo: a module fixture spawns them once
(``torch.multiprocessing``, the spawn method, two torch threads each) and
hands them tasks, this module's ``task_*`` functions, which import no JAX.
A task's result comes back within TASK_TIMEOUT_S, and a collective that
waits longer raises, so a rank that fails cannot hang the other.

  * helpers: ``parallel/multihost.py`` at one rank (in this process, no
    group) and at two;
  * the cross-process BatchNorm on two unequal shards against JAX's
    ``batch_norm`` on the concatenated batch and its ``jax.vjp``; at one
    rank the port's module is ``nn.BatchNorm2d`` bit for bit;
  * the distill step: two ranks on half batches against JAX's jitted
    single-process ``make_distill_train_step`` on the whole batch, from the
    same weights (``models/convert.py``);
  * the detection step: two ranks against the average of two one-process
    port steps, one per shard, with each rank's draws (``fold_in``): JAX's
    ``shard_map`` semantics, which tests/test_multiprocess.py
    ``TestShardedDetectionTrainStep`` holds on the JAX side;
  * the ext step against JAX's jitted GSPMD ext step on the global batch,
    and ``collect_probs`` against JAX's on each shard in rank order;
  * the CocoEvaluator merge, with an image both ranks hold, against JAX's
    evaluator fed the same detections in one process.

tests/test_torch_port_multiprocess_runner.py runs ``mimic_runner.main`` as
two ranks.
"""
import contextlib
import ctypes
import importlib
import os
import socket
import traceback

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from chip_smoke import EXT_MODEL, STUDENT_MODEL, TEACHER_MODEL, TRAIN
from hnd_ghnd_tpu_torch.models import layers as L
from hnd_ghnd_tpu_torch.parallel import multihost

WORLD = 2
THREADS = 2
TASK_TIMEOUT_S = 60.0
# float32 sums of the same numbers in another order (the global batch on
# two ranks, or XLA's order)
SUM_TOL = 1e-5
NUM_CLASSES = 5
# a global batch of 4 at 64x96 (two per rank), two steps
BATCH, H, W, STEPS = 4, 64, 96, 2
# HND: the layer1 term alone (config/hnd/*.yaml), so the trunk stops there
HND_CRITERION = {"type": "general", "params": {"org_loss_factor": 0.0},
                 "terms": {"layer1": TRAIN["criterion"]["terms"]["layer1"]}}
# small enough for the MSE sum's gradients (~1e4) that two steps do not
# diverge
SGD = {"type": "SGD", "params": {"lr": 1e-7, "momentum": 0.9}}
# the org and ext configs' SGD, for a loss of order 1
MEAN_SGD = {"type": "SGD", "params": {"lr": 0.02, "momentum": 0.9}}
# the logged loss and terms against JAX's: XLA's float32 sum of a term is
# itself up to ~2e-5 off the exact sum (tests/test_torch_port_runner.py);
# here the port's and JAX's first losses differ by 8.6e-6
LOSS_TOL = 5e-5
# an SGD update is lr x the momentum trace of the gradients: the update of
# each leaf is held to the gradient tolerance of
# tests/test_torch_port_distill.py (JAX's float32 gradients 1.04e-3 of a
# leaf's largest element off float64, the port's 3.6e-4 without oneDNN)
UPDATE_TOL = 2e-3
# the average of two one-process steps against the two ranks': the same
# arithmetic, but each process's float32 sums split over its own threads
# (3.1e-6 of a leaf's largest move here)
AVG_TOL = 1e-5
# BN biases followed by an unpadded conv and a train-mode BN have a zero
# gradient: both sides move them by float noise, held below this fraction
# of the move of the BN's weight (tests/test_torch_port_distill.py)
ZERO_GRAD_TOL = 1e-5
ZERO_GRAD = ("backbone.body.layer1.decoder.3.bias",
             "backbone.body.layer1.decoder.8.bias")


@contextlib.contextmanager
def omp_threads(n: int = THREADS):
    """torch's intra-op threads in this process limited to ``n`` through
    the OpenMP runtime alone, and restored after (ROADMAP C14).
    ``torch.set_num_threads`` would also turn MKL's dynamic choice of
    threads off for the rest of the process (``mkl_set_dynamic(0)``, even
    at the count it already has), and MKL's float32 products then sum in
    another order for every later test of the worker:
    tests/test_torch_port_detection.py's float32 gradients move from
    3.8e-5 to 5.0e-4 of their largest element off float64 (the box head's
    fc6, whose sum over the RoIs cancels), as under ``MKL_DYNAMIC=FALSE``.
    Where torch's OpenMP runtime is not the one found here, nothing is
    limited."""
    before = torch.get_num_threads()
    want = min(n, before)
    try:
        gomp = ctypes.CDLL("libgomp.so.1")
    except OSError:
        gomp = None
    if gomp is not None:
        gomp.omp_set_num_threads(want)
        if torch.get_num_threads() != want:   # not torch's runtime
            gomp.omp_set_num_threads(before)
            gomp = None
    try:
        yield
    finally:
        if gomp is not None:
            gomp.omp_set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def xdist_threads():
    """Under pytest-xdist (``PYTEST_XDIST_WORKER`` set), torch's threads in
    this worker limited to THREADS for the module (``omp_threads``): six
    workers of one OpenMP thread per core each oversubscribe the host, and
    the heavy CPU files then took 5-9x their serial time.  A serial run
    keeps every thread.  A port test file that computes with torch in the
    pytest process imports this fixture (it is autouse)."""
    if "PYTEST_XDIST_WORKER" in os.environ:
        with omp_threads():
            yield
    else:
        yield


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(rank, world, port, module, init_group, inbox, outbox):
    torch.set_num_threads(THREADS)
    tasks = importlib.import_module(module)
    if init_group:
        multihost.init_distributed_mode(f"tcp://127.0.0.1:{port}", world,
                                        rank, timeout_s=TASK_TIMEOUT_S)
    else:   # what torchrun sets
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
    while True:
        task = inbox.get()
        if task is None:
            break
        name, kwargs = task
        try:
            outbox.put((True, getattr(tasks, name)(**kwargs)))
        except Exception:
            outbox.put((False, traceback.format_exc()))
    multihost.destroy()
    # every result is delivered: skip the interpreter's and torch's
    # finalization (seconds of the module's teardown)
    os._exit(0)


class Ranks:
    """WORLD spawned processes that run the tasks of ``module``, each rank
    with the same arguments, in a gloo group of their own; with
    ``init_group`` off, in no group but with the environment ``torchrun``
    gives its ranks (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and a free
    MASTER_PORT).  Broken (a task failed or timed out): restarted at the
    next ``run``."""

    def __init__(self, world: int = WORLD, module: str = __name__,
                 init_group: bool = True):
        self.world, self.module, self.init_group = world, module, init_group
        self.procs = []

    def start(self) -> None:
        ctx = mp.get_context("spawn")
        port = free_port()
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outboxes = [ctx.Queue() for _ in range(self.world)]
        old = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = str(THREADS)
        try:
            self.procs = [ctx.Process(
                target=_serve, daemon=True,
                args=(r, self.world, port, self.module, self.init_group,
                      self.inboxes[r], self.outboxes[r]))
                for r in range(self.world)]
            for p in self.procs:
                p.start()
        finally:
            if old is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = old

    def run(self, name: str, timeout: float = TASK_TIMEOUT_S, **kwargs):
        """Every rank's result of ``name(**kwargs)``, in rank order."""
        self.submit(name, **kwargs)
        return self.collect(timeout)

    def submit(self, name: str, **kwargs) -> None:
        """Start ``name(**kwargs)`` on every rank; ``collect`` returns the
        results."""
        if not self.procs:
            self.start()
        for box in self.inboxes:
            box.put((name, kwargs))

    def collect(self, timeout: float = TASK_TIMEOUT_S):
        out, errors = [], []
        try:
            for r, box in enumerate(self.outboxes):
                ok, value = box.get(timeout=timeout)
                (out if ok else errors).append(value if ok
                                               else f"rank {r}:\n{value}")
        except Exception:
            self.close()
            raise
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for p, box in zip(self.procs, self.inboxes):
            if p.is_alive():
                box.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            assert not p.is_alive()
        self.procs = []


@pytest.fixture(scope="module")
def ranks():
    pool = Ranks()
    yield pool
    pool.close()


@pytest.fixture(scope="module")
def one_process():
    """A spawned process in no group, for the one-process reference: it
    sums on the ranks' torch threads.  This process's thread count is left
    alone, since ``torch.set_num_threads`` (even to the count it has) pins
    MKL's and so changes the float32 sums of every test after it in the
    worker."""
    pool = Ranks(world=1, init_group=False)
    yield pool
    pool.close()


def shard(x, rank: int = None, world: int = WORLD):
    """Rank ``rank``'s contiguous share of the leading axis."""
    rank = multihost.get_rank() if rank is None else rank
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


# ------------------------------------------------------------------ helpers

def task_helpers(path):
    rank = multihost.get_rank()
    f32 = torch.tensor([1.0, 2.0], dtype=torch.float32) * (rank + 1)
    f64 = torch.tensor([3.0], dtype=torch.float64) * (rank + 1)
    i64 = torch.tensor([rank + 1, 10], dtype=torch.int64)
    multihost.all_reduce_([f32, f64, i64], "sum")
    avg = torch.tensor([rank + 1.0])
    multihost.all_reduce_([avg], "avg")
    multihost.save_on_master(lambda: open(path, "a").write(f"{rank}\n"))
    multihost.barrier()
    with open(path) as f:
        written = f.read()
    return {"rank": rank, "world": multihost.get_world_size(),
            "main": multihost.is_main_process(),
            "gathered": multihost.all_gather_objects({"r": rank}),
            "mean": multihost.reduce_scalars({"a": rank + 1.0, "b": 2.0}),
            "sum": multihost.reduce_scalars({"a": rank + 1.0}, average=False),
            "f32": f32.tolist(), "f64": f64.tolist(), "i64": i64.tolist(),
            "avg": avg.tolist(), "written": written}


def test_helpers_at_two_ranks(ranks, tmp_path):
    path = str(tmp_path / "master.txt")
    for r, out in enumerate(ranks.run("task_helpers", path=path)):
        assert (out["rank"], out["world"], out["main"]) == (r, 2, r == 0)
        assert out["gathered"] == [{"r": 0}, {"r": 1}]
        assert out["mean"] == {"a": 1.5, "b": 2.0}
        assert out["sum"] == {"a": 3.0}
        assert out["f32"] == [3.0, 6.0] and out["f64"] == [9.0]
        assert out["i64"] == [3, 20] and out["avg"] == [1.5]
        assert out["written"] == "0\n"


def test_helpers_at_one_rank(tmp_path):
    assert not multihost.group_up()
    assert (multihost.get_rank(), multihost.get_world_size()) == (0, 1)
    assert multihost.is_main_process()
    assert multihost.all_gather_objects({"x": 1}) == [{"x": 1}]
    assert multihost.reduce_scalars({"a": 2.5}) == {"a": 2.5}
    t = torch.tensor([1.0, 2.0])
    multihost.all_reduce_([t], "avg")
    assert t.tolist() == [1.0, 2.0]
    with pytest.raises(ValueError):
        multihost.all_reduce_([t], "max")
    path = tmp_path / "x"
    multihost.save_on_master(path.write_text, "y")
    assert path.read_text() == "y"
    multihost.barrier()
    # seeds of their own, the same for the same (seed, rank)
    assert multihost.fold_in(3, 0) == multihost.fold_in(3, 0)
    assert len({multihost.fold_in(3, r) for r in range(4)}
               | {multihost.fold_in(4, 0)}) == 5


class Flags:
    world_size = dist_url = coordinator_address = None
    num_processes = process_id = None

    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("flags, env, want", [
    ({}, {}, None),
    ({"world_size": 2}, {}, None),               # no rank: one process
    ({}, {"RANK": "1", "WORLD_SIZE": "2"}, ("env://", 2, 1)),   # torchrun
    ({"world_size": 2, "dist_url": "env://"}, {"RANK": "0"},
     ("env://", 2, 0)),
    ({"dist_url": "env://"}, {"WORLD_SIZE": "1"}, ("env://", 1, 0)),
    ({"coordinator_address": "h:5", "num_processes": 2, "process_id": 1},
     {}, ("tcp://h:5", 2, 1)),
    ({}, {"JAX_COORDINATOR_ADDRESS": "h:6", "JAX_NUM_PROCESSES": "3",
          "JAX_PROCESS_ID": "2"}, ("tcp://h:6", 3, 2)),
    ({"process_id": 0, "world_size": 2}, {"RANK": "1"}, ("env://", 2, 0)),
])
def test_rendezvous_sources(flags, env, want):
    assert multihost.rendezvous_from(Flags(**flags), env) == want


def test_rendezvous_without_a_world_size_raises():
    with pytest.raises(ValueError):
        multihost.rendezvous_from(Flags(), {"RANK": "0"})


# -------------------------------------------------------------- BatchNorm

BN_SHARDS = (1, 3)      # images per rank: the global count is all-reduced
BN_SHAPE = (4, 5, 6, 7)


def bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(*BN_SHAPE) * 2 + 0.5).astype(np.float32)
    gy = rng.randn(*BN_SHAPE).astype(np.float32)
    c = BN_SHAPE[1]
    affine = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.uniform(-.1, .1, c),
              "running_mean": rng.uniform(-.1, .1, c),
              "running_var": rng.uniform(0.5, 2.0, c)}
    return x, gy, {k: v.astype(np.float32) for k, v in affine.items()}


def bn_module(affine):
    bn = L.BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        for k, v in affine.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    return bn


def task_batch_norm():
    x, gy, affine = bn_inputs()
    lo = sum(BN_SHARDS[:multihost.get_rank()])
    hi = lo + BN_SHARDS[multihost.get_rank()]
    bn = bn_module(affine)
    xs = torch.from_numpy(x[lo:hi]).requires_grad_(True)
    y = bn(xs)
    y.backward(torch.from_numpy(gy[lo:hi]))
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
            "tracked": int(bn.num_batches_tracked)}


def test_cross_process_batch_norm_is_jax_on_the_global_batch(ranks):
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.models import layers as JL
    x, gy, affine = bn_inputs()
    params = {"gamma": jnp.asarray(affine["weight"]),
              "beta": jnp.asarray(affine["bias"])}
    state = {"mean": jnp.asarray(affine["running_mean"]),
             "var": jnp.asarray(affine["running_var"])}
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1))

    @jax.jit
    def f_vjp(p, xx, g):
        def f(p, xx):
            return JL.batch_norm(p, state, xx, training=True)

        (y, new_state), vjp = jax.vjp(f, p, xx)
        zero = jax.tree_util.tree_map(jnp.zeros_like, new_state)
        return y, new_state, vjp((g, zero))

    ranks.submit("task_batch_norm")
    y, new_state, (d_params, dx) = f_vjp(params, jnp.asarray(nhwc(x)),
                                         jnp.asarray(nhwc(gy)))
    outs = ranks.collect()

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= SUM_TOL * np.abs(want).max()

    close(np.concatenate([o["y"] for o in outs]), np.transpose(y, (0, 3, 1, 2)))
    close(np.concatenate([o["dx"] for o in outs]),
          np.transpose(dx, (0, 3, 1, 2)))
    # the affine's gradients: each rank's partial sums, summed by the step
    close(sum(o["dw"] for o in outs), d_params["gamma"])
    close(sum(o["db"] for o in outs), d_params["beta"])
    for o in outs:
        close(o["mean"], new_state["mean"])
        close(o["var"], new_state["var"])
        assert o["tracked"] == 1
    # the global statistics are the same bits on both ranks
    for k in ("mean", "var"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_norm_at_one_rank_is_torch_bit_for_bit(dtype):
    x, gy, affine = bn_inputs()
    ours = bn_module(affine).to(dtype)
    ref = torch.nn.BatchNorm2d(BN_SHAPE[1]).train().to(dtype)
    ref.load_state_dict(ours.state_dict())
    outs = []
    for m in (ours, ref):
        xx = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = m(xx)
        y.backward(torch.from_numpy(gy).to(dtype))
        outs.append([y, xx.grad, m.weight.grad, m.bias.grad,
                     m.running_mean, m.running_var])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------------------------ distill step

def distill_weights():
    """The ResNet-50 teacher and the b3ch student, seeded.  Their frozen
    BNs are at mean 0 and variance 1, so the port's frozen-BN ``weight``
    is JAX's ``scale`` (the student's stem BN trains, ROADMAP C6)."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    params = {"num_classes": NUM_CLASSES, "pretrained": False}
    return (get_model(dict(TEACHER_MODEL, params=params), seed=0,
                      device="cpu"),
            get_model(dict(STUDENT_MODEL, params=params), seed=1,
                      device="cpu"))


def trunk_to_layer1(state_dict):
    """The entries an HND step reads: the stem and layer1."""
    return {k: v for k, v in state_dict.items() if k.startswith(
        ("backbone.body.conv1.", "backbone.body.bn1.",
         "backbone.body.layer1."))}


def distill_images():
    rng = np.random.RandomState(5)
    return rng.rand(STEPS, BATCH, H, W, 3).astype(np.float32)


def trained_state(model):
    """The trainable parameters and the BN running statistics, as numpy."""
    out = {n: p.detach().numpy().copy() for n, p in model.named_parameters()
           if p.requires_grad}
    out.update({n: b.numpy().copy() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))
                and ".layer1." in n})
    return out


def task_distill():
    from hnd_ghnd_tpu_torch.distill.box import DistillationBox
    from hnd_ghnd_tpu_torch.parallel.train_step import make_distill_train_step
    teacher, student = distill_weights()
    teacher.eval().requires_grad_(False)
    student.train()
    step = make_distill_train_step(
        DistillationBox(teacher, student, HND_CRITERION), SGD)
    losses = []
    with torch.backends.mkldnn.flags(enabled=False):
        for images in distill_images():
            loss, terms = step(torch.from_numpy(shard(images)))
            losses.append((float(loss), {k: float(v)
                                         for k, v in terms.items()}))
    return {"losses": losses, "state": trained_state(student)}


def test_distill_step_at_two_ranks_is_jax_on_the_global_batch(ranks):
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.distill.box import DistillationBox as JaxBox
    from hnd_ghnd_tpu.models.convert import convert_state_dict
    from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
    from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_optimizer
    from hnd_ghnd_tpu.parallel.mesh import make_distill_train_step as jax_step
    from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
    ranks.submit("task_distill")
    teacher, student = distill_weights()
    before = trained_state(student)
    tp, _ = convert_state_dict(trunk_to_layer1(teacher.state_dict()))
    ts = {"backbone": {"body": {}}}     # frozen BNs only: no JAX state
    sp, ss = convert_state_dict(trunk_to_layer1(student.state_dict()))
    params = {"num_classes": NUM_CLASSES, "pretrained": False}
    box = JaxBox(jax_build_model(dict(TEACHER_MODEL, params=params)),
                 jax_build_model(dict(STUDENT_MODEL, params=params)),
                 HND_CRITERION)
    optimizer, _ = jax_optimizer(SGD, None, 1, 0)
    step = jax_step(box, optimizer, STUDENT_MODEL["frozen_modules"],
                    compute_dtype=jnp.float32, donate=False)
    opt_state = optimizer.init(sp)
    want = []
    for images in distill_images():
        sizes = jnp.asarray(np.tile([H, W], (len(images), 1)), jnp.int32)
        batch = {"images": jnp.asarray(images), "image_sizes": sizes,
                 "original_sizes": sizes}
        loss, terms, sp, ss, opt_state = step(tp, ts, sp, ss, opt_state,
                                              batch, jax.random.PRNGKey(0))
        want.append((float(loss), {k: float(v) for k, v in terms.items()}))
    jax_after = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, sp),
        jax.tree_util.tree_map(np.asarray, ss)).items()}
    outs = ranks.collect()
    for out in outs:
        # every rank logs the global loss and terms
        for (loss, terms), (w_loss, w_terms) in zip(out["losses"], want):
            assert abs(loss - w_loss) <= LOSS_TOL * abs(w_loss)
            assert terms.keys() == w_terms.keys()
            for k in terms:
                assert abs(terms[k] - w_terms[k]) <= LOSS_TOL * abs(w_terms[k])
    # the ranks hold the same parameters and statistics, bit for bit
    assert outs[0]["state"].keys() == outs[1]["state"].keys() == before.keys()
    for k in before:
        np.testing.assert_array_equal(outs[0]["state"][k], outs[1]["state"][k])
    moved = 0
    for k, v in outs[0]["state"].items():
        want_v = jax_after[k]
        if "running_" in k:
            # a mean held to the data's scale, its standard deviation
            var = jax_after[k.replace("running_mean", "running_var")]
            scale = np.sqrt(var).max() if "mean" in k else var.max()
            assert np.abs(v - want_v).max() <= SUM_TOL * scale, k
            continue
        update, want_update = v - before[k], want_v - before[k]
        if k in ZERO_GRAD:
            weight = k[:-len("bias")] + "weight"
            scale = np.abs(jax_after[weight] - before[weight]).max()
            for u in (update, want_update):
                assert np.abs(u).max() <= ZERO_GRAD_TOL * scale, k
            continue
        scale = np.abs(want_update).max()
        moved += scale > 0
        assert np.abs(update - want_update).max() <= UPDATE_TOL * scale, k
    assert moved > 0


# ---------------------------------------------------------- detection step

DET_SEED = 7
DET_SHAPE = (64, 96)


def detection_model():
    """The b3ch student as a detector: its trainable stem and bottleneck
    (eight BNs in train mode) under the whole detector's loss."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    return get_model(dict(STUDENT_MODEL, params={
        "num_classes": 91, "pretrained": False}), seed=2,
        device="cpu").train()


def detection_shard(rank: int):
    """Rank ``rank``'s image of the global batch of WORLD, and targets."""
    from chip_smoke import org_batch
    batch, targets = org_batch(np.random.RandomState(9), DET_SHAPE, WORLD)
    return ({k: torch.from_numpy(shard(v, rank)) for k, v in batch.items()},
            {k: torch.from_numpy(shard(v, rank)) for k, v in targets.items()})


def float_buffers(model):
    return {n: b.numpy().copy() for n, b in model.named_buffers()
            if b.is_floating_point()}


def task_detection():
    from hnd_ghnd_tpu_torch.parallel.train_step import \
        make_detection_train_step
    model = detection_model()
    step = make_detection_train_step(model, MEAN_SGD,
                                     compute_dtype=torch.float32,
                                     seed=DET_SEED)
    loss, terms = step(*detection_shard(multihost.get_rank()))
    return {"loss": float(loss), "terms": {k: float(v) for k, v in
                                           terms.items()},
            "params": {n: p.detach().numpy().copy() for n, p in
                       model.named_parameters() if p.requires_grad},
            "buffers": float_buffers(model)}


def task_detection_reference():
    """The manual average of two one-process steps, one per shard, each
    with its rank's draws: the averaged gradients, float buffers and
    terms, then the optimizer update."""
    from hnd_ghnd_tpu_torch.parallel.train_step import (
        make_detection_train_step, uniform_draw)
    model = detection_model()
    step = make_detection_train_step(model, MEAN_SGD,
                                     compute_dtype=torch.float32)
    start = {n: b.clone() for n, b in model.named_buffers()}
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    before = {n: p.detach().numpy().copy() for n, p in trainable}
    grads, buffers, losses = [], [], []
    for r in range(WORLD):
        model.load_state_dict(start, strict=False)
        step.optimizer.zero_grad(set_to_none=True)
        draw = uniform_draw(torch.Generator().manual_seed(
            multihost.fold_in(DET_SEED, r)))
        terms = model(*detection_shard(r), draw)
        sum(terms.values()).backward()
        grads.append([p.grad.clone() for _, p in trainable])
        buffers.append(float_buffers(model))
        losses.append({k: float(v.detach()) for k, v in terms.items()})
    for i, (_, p) in enumerate(trainable):
        p.grad = (grads[0][i] + grads[1][i]) / 2
    with torch.no_grad():
        for n, b in model.named_buffers():
            if b.is_floating_point():
                b.copy_(torch.from_numpy((buffers[0][n] + buffers[1][n]) / 2))
    step.apply_update()
    return {"before": before, "losses": losses, "shard_buffers": buffers,
            "params": {n: p.detach().numpy().copy() for n, p in trainable},
            "buffers": float_buffers(model)}


def test_detection_step_at_two_ranks_averages_the_shards(ranks, one_process):
    """JAX's ``shard_map`` step (mesh.py:322-396): each shard's loss with its
    own BN statistics and its own draws (``fold_in(seed, rank)``), the
    gradients, the loss, its terms and the float buffers averaged."""
    ranks.submit("task_detection")
    (ref,) = one_process.run("task_detection_reference")
    outs = ranks.collect()
    losses, before = ref["losses"], ref["before"]
    want_terms = {k: (losses[0][k] + losses[1][k]) / 2 for k in losses[0]}
    moves = {n: ref["params"][n] - p0 for n, p0 in before.items()}
    moved = 0
    for out in outs:
        assert out["terms"].keys() == want_terms.keys()
        for k, v in want_terms.items():
            assert out["terms"][k] == pytest.approx(v, rel=AVG_TOL)
        assert out["loss"] == pytest.approx(sum(want_terms.values()),
                                            rel=AVG_TOL)
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
            # and one rounding of the parameter itself
            ulp = np.spacing(np.abs(p0).max())
            assert np.abs(got - moves[n]).max() <= AVG_TOL * scale + ulp, n
        for n, b in ref["buffers"].items():
            assert np.abs(out["buffers"][n] - b).max() <= \
                AVG_TOL * np.abs(b).max(), n
    assert moved > 0
    # each rank drew its own proposals, and its BNs saw its own image
    assert losses[0] != losses[1]
    name = "backbone.body.layer1.encoder.encoder.1.running_mean"
    shards = ref["shard_buffers"]
    assert not np.array_equal(shards[0][name], shards[1][name])


# ---------------------------------------------------------------- ext step

EXT_SHAPE = (64, 64)
# the ext config's SGD at a tenth of its lr: at 0.02 one of the first BN's
# outputs lands within float noise of the next ReLU's kink at the second
# step, and the port's one process already parts from JAX there by 0.5% of
# the first conv's update
EXT_SGD = {"type": "SGD", "params": {"lr": 0.002, "momentum": 0.9}}
# the losses and the filter's leaves after two SGD steps against JAX's:
# each leaf within this fraction of JAX's largest element (float32 sums in
# another order; 3.7e-7 of the loss and 1.5e-6 of a leaf seen here), and
# each update within EXT_UPDATE_TOL of JAX's largest update (1.4e-5 seen;
# one step: 4.9e-5 at most, tests/test_torch_port_ext.py); the conv
# biases, whose gradient before a train-mode BN is zero, are held by their
# values alone
EXT_TOL = 1e-5
EXT_UPDATE_TOL = 1e-4
# the gathered P(valid) against JAX's collect_probs on each shard with
# JAX's own trained leaves (equal here)
PROB_TOL = 1e-5


def ext_config():
    return dict(EXT_MODEL, ckpt=None, params=dict(
        EXT_MODEL["params"], pretrained=False), backbone=dict(
        EXT_MODEL["backbone"], ext_config=dict(
            EXT_MODEL["backbone"]["ext_config"], ckpt=None)))


def ext_model():
    from hnd_ghnd_tpu_torch.models.factory import get_model
    return get_model(ext_config(), seed=3, device="cpu")


def ext_batches():
    """STEPS global batches of BATCH images in [0, 1) and labels."""
    rng = np.random.RandomState(4)
    images = rng.rand(STEPS, BATCH, *EXT_SHAPE, 3).astype(np.float32)
    return images, rng.randint(0, 2, (STEPS, BATCH))


def ext_eval_batches():
    """Four eval batches of two (the last one padded), host targets with
    and without ten visible keypoints."""
    rng = np.random.RandomState(6)
    out = []
    for i in range(4):
        images = rng.rand(2, *EXT_SHAPE, 3).astype(np.float32)
        host = []
        for j in range(2):
            kps = np.zeros((1, 17, 3), np.float32)
            kps[0, :, 2] = 2 if (i + j) % 2 else 0
            host.append({"boxes": np.asarray([[4., 4., 40., 50.]]),
                         "keypoints": kps, "is_padding": i == 3 and j == 1})
        out.append(({"images": images}, None, host))
    return out


def ext_state(model):
    from hnd_ghnd_tpu_torch.runners.ext_runner import EXT_PREFIX
    return {n: t.detach().numpy().copy() for n, t in
            list(model.named_parameters()) + list(model.named_buffers())
            if n.startswith(EXT_PREFIX) and t.is_floating_point()}


def task_ext():
    from hnd_ghnd_tpu_torch.runners.ext_runner import (collect_probs,
                                                       make_ext_train_step)
    model = ext_model()
    step = make_ext_train_step(model, EXT_SGD)
    model.train()
    images, labels = ext_batches()
    losses = [float(step(torch.from_numpy(shard(x)), torch.from_numpy(
        shard(y)))) for x, y in zip(images, labels)]
    probs, truth = collect_probs(model, shard(ext_eval_batches()), True)
    return {"losses": losses, "state": ext_state(model), "probs": probs,
            "labels": truth}


def test_ext_step_and_probs_at_two_ranks_are_jax_on_the_global_batch(ranks):
    """JAX's jitted GSPMD ext step (ext_runner.py:73-96) on the global
    batch: the mean cross-entropy, the filter's BNs on the global
    statistics; then JAX's ``collect_probs`` on each shard, concatenated in
    rank order (:132-137)."""
    import jax
    import jax.numpy as jnp
    from hnd_ghnd_tpu.models.convert import convert_state_dict
    from hnd_ghnd_tpu.models.factory import build_model as jax_build_model
    from hnd_ghnd_tpu.parallel.mesh import build_optimizer as jax_optimizer
    from hnd_ghnd_tpu.parallel.mesh import make_mesh
    from hnd_ghnd_tpu.runners import ext_runner as jax_ext
    from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
    ranks.submit("task_ext")
    model = ext_model()
    before = ext_state(model)
    conv_biases = {f"{n}.bias" for n, m in model.named_modules()
                   if isinstance(m, torch.nn.Conv2d)} & before.keys()
    # the ext forward reads the stem and layer1 alone
    params, state = convert_state_dict(trunk_to_layer1(model.state_dict()))
    del model
    jm = jax_build_model(ext_config())
    sgd, _ = jax_optimizer(EXT_SGD, None, 1)
    step = jax_ext.make_ext_train_step(jm, sgd, make_mesh(jax.devices()[:1]))
    params, state = (jax.tree_util.tree_map(jnp.asarray, t)
                     for t in (params, state))
    opt_state = sgd.init(params)
    want_losses = []
    for x, y in zip(*ext_batches()):
        loss, params, state, opt_state = step(params, state, opt_state,
                                              jnp.asarray(x),
                                              jnp.asarray(y, jnp.int32))
        want_losses.append(float(loss))
    params, state = (jax.tree_util.tree_map(np.asarray, t)
                     for t in (params, state))
    after = {k: v.numpy() for k, v in state_dict_from_jax(
        params, state).items() if k in before}
    parts = [jax_ext.collect_probs(jm, params, state,
                                   shard(ext_eval_batches(), r), True)
             for r in range(WORLD)]
    outs = ranks.collect()
    assert after.keys() == before.keys() and len(conv_biases) == 3
    for out in outs:
        np.testing.assert_allclose(out["losses"], want_losses, rtol=EXT_TOL)
        assert out["state"].keys() == after.keys()
        for k, want in after.items():
            got = out["state"][k]
            assert np.abs(got - want).max() <= EXT_TOL * np.abs(want).max(), k
            if "running_" in k or k in conv_biases:
                continue
            update = want - before[k]
            assert np.abs(update).max() > 0, k
            assert np.abs((got - before[k]) - update).max() <= \
                EXT_UPDATE_TOL * np.abs(update).max(), k
        np.testing.assert_allclose(
            out["probs"], np.concatenate([p for p, _ in parts]),
            rtol=0, atol=PROB_TOL)
        np.testing.assert_array_equal(out["labels"], np.concatenate(
            [t for _, t in parts]))
    np.testing.assert_array_equal(outs[0]["probs"], outs[1]["probs"])
    assert len(outs[0]["probs"]) == 7 and set(outs[0]["labels"]) == {0, 1}


# ----------------------------------------------------- CocoEvaluator merge

MERGE_IMAGES = 6
# rank 0 evaluates images 1-4, rank 1 images 4-6: image 4 on both (a
# shard's wrap-around), with other detections on rank 1
MERGE_SHARDS = ((1, 2, 3, 4), (4, 5, 6))


def merge_detections(ann_file: str, rank: int):
    """Each image's GT boxes jittered, with a few labels wrong and random
    scores, seeded by image and rank."""
    import json
    with open(ann_file) as f:
        anns = json.load(f)["annotations"]
    out = {}
    for image_id in MERGE_SHARDS[rank]:
        rng = np.random.RandomState(100 * rank + image_id)
        mine = [a for a in anns if a["image_id"] == image_id]
        boxes = np.asarray([a["bbox"] for a in mine], np.float64)
        boxes[:, 2:] += boxes[:, :2]
        boxes += rng.uniform(-3, 3, boxes.shape)
        labels = np.asarray([a["category_id"] for a in mine])
        labels[rng.rand(len(labels)) < 0.2] = 1
        out[image_id] = {"boxes": boxes, "labels": labels,
                         "scores": rng.rand(len(labels))}
    return out


def task_coco_merge(img_dir, ann_file):
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset
    from hnd_ghnd_tpu_torch.evals.coco_eval import CocoEvaluator
    ev = CocoEvaluator(CocoDataset(img_dir, ann_file), ["bbox"])
    ev.update(merge_detections(ann_file, multihost.get_rank()))
    ev.synchronize_between_processes()
    ev.accumulate()
    return ev.summarize()["bbox"], sorted(ev.evals["bbox"].img_ids)


def test_coco_evaluator_merge_is_jax_in_one_process(ranks, tmp_path):
    from hnd_ghnd_tpu.data.coco import CocoDataset as JaxDataset
    from hnd_ghnd_tpu.evals.coco_eval import CocoEvaluator as JaxEvaluator
    from tests.fixtures import make_coco_fixture
    img_dir, ann_file = make_coco_fixture(str(tmp_path), MERGE_IMAGES,
                                          seed=3, num_classes=3)
    ranks.submit("task_coco_merge", img_dir=img_dir, ann_file=ann_file)
    jax_ev = JaxEvaluator(JaxDataset(img_dir, ann_file), ["bbox"])
    first = merge_detections(ann_file, 0)
    jax_ev.update(first)
    jax_ev.update({k: v for k, v in merge_detections(ann_file, 1).items()
                   if k not in first})
    jax_ev.accumulate()
    want = jax_ev.summarize()["bbox"]
    outs = ranks.collect()
    for stats, img_ids in outs:
        assert img_ids == list(range(1, MERGE_IMAGES + 1))
        np.testing.assert_array_equal(stats, want)
    # rank 1's copy of image 4 would give other stats
    assert 0.0 < want[0] < 1.0
