"""The runners' shared machinery: CLI arguments, loaders, the eval loop
and the lag-1 read of training scalars.

Counterpart of hnd_ghnd_tpu/runners/common.py (reference
src/utils/main_util.py evaluate :75-113).  ``eval_forward`` is the ``fwd``
of its JitCache.eval_forward (uint8 pixels become float * 1/255, as
parallel/mesh.py:images_to_compute does), and ``evaluate`` is the lag-1
device loop of its ``evaluate``: batch k's detections are copied to pinned
host memory behind a CUDA event while batch k+1 is dispatched, and only then
turned into numpy and, under ``coco_evaluate``, finalized and fed to the
CocoEvaluator on the host while batch k+1 runs on the card.  When the eval
has ``segm`` or ``keypoints``, a batch's images are finalized on a thread
pool (their mask paste and heatmap resize are cv2 work that releases the
GIL), as JAX's ``evaluate`` does (common.py:258-287): its size is
``HND_TPU_POSTPROC_THREADS``, ``os.cpu_count()`` by default, and 0 or 1
turns it off.  The forward
runs in float32 whatever the config's compute dtype, as JAX's eval forward
does (runners/common.py:180-184).  ``StepMetrics`` is its counterpart for
the training loops: each step's loss and terms go to pinned host memory
behind a CUDA event and are read one step later.

One process on one device runs every loop: JAX's meshes, MicrobatchBuffer
(``steps_per_dispatch``), JitCache and persistent compilation cache have no
counterpart (XLA-only, or measured slower, BASELINE.md round 5).
"""
from __future__ import annotations

import argparse
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hnd_ghnd_tpu_torch.evals.coco_eval import CocoEvaluator
from hnd_ghnd_tpu_torch.evals.postprocess import finalize_predictions
from hnd_ghnd_tpu_torch.models.convert import jax_params_from_state_dict
from hnd_ghnd_tpu_torch.models.factory import get_iou_types, load_weights
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel.train_step import images_to_compute
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util


COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """--config/--json/--device/--seed of every runner (reference
    src/mimic_runner.py:17-29).  The runners run on the card unless
    ``--device cpu``; ``--world_size`` above 1 raises (ROADMAP A12)."""
    parser.add_argument("--config", required=True, help="yaml config path")
    parser.add_argument("--json", default=None,
                        help="JSON string merged over the config")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models (cuda or cpu)")
    parser.add_argument("--world_size", type=int, default=None,
                        help="number of processes; only 1 is ported")
    parser.add_argument("--seed", type=int, default=0)


def check_unported_args(args: argparse.Namespace) -> None:
    """Raise on a flag whose feature the port does not have yet."""
    if (getattr(args, "world_size", None) or 1) > 1:
        raise NotImplementedError("--world_size > 1: multi-process runs are "
                                  "ROADMAP A12")
    for flag in ("tb_dir", "profile_dir"):
        if getattr(args, flag, None):
            raise NotImplementedError(f"--{flag}: TensorBoard curves and the "
                                      "profiler trace are ROADMAP A18")


def keypoint_min_sizes(model_kind: str, training: bool) -> Tuple[int, ...]:
    """KeypointRCNN trains at random min sides 640..800
    (reference src/models/org/rcnn.py:325-326)."""
    if model_kind == "keypoint_rcnn" and training:
        return (640, 672, 704, 736, 768, 800)
    return (800,)


def loaders_from_config(config: Dict[str, Any], model_kind: str,
                        batch_size: int, min_sizes: Sequence[int] = (800,)):
    """(train, val, test) loaders of one process from the config's
    ``dataset`` and ``tpu`` blocks: the buckets, min sizes, max size,
    ``pixel_dtype``, the per-epoch val batch (``tpu.eval_batch_size``) and
    the test batch (``test.batch_size``, 1 by default, the reference's
    protocol)."""
    from hnd_ghnd_tpu_torch.data.loader import get_coco_data_loaders
    from hnd_ghnd_tpu_torch.data.transforms import DEFAULT_BUCKETS
    tpu_cfg = config.get("tpu", {}) or {}
    buckets = tuple(tuple(b) for b in tpu_cfg.get("buckets", DEFAULT_BUCKETS))
    min_sizes = tuple(tpu_cfg.get("min_sizes", min_sizes))
    max_size = int(tpu_cfg.get("max_size", 1333))
    eval_bs = int((config.get("test", {}) or {}).get("batch_size", 1))
    val_bs = tpu_cfg.get("eval_batch_size")
    return get_coco_data_loaders(
        config["dataset"], batch_size,
        with_masks=model_kind == "mask_rcnn",
        with_keypoints=model_kind == "keypoint_rcnn",
        min_sizes=min_sizes, buckets=buckets, max_size=max_size,
        eval_batch_size=eval_bs,
        val_batch_size=int(val_bs) if val_bs is not None else None,
        pixel_dtype=str(tpu_cfg.get("pixel_dtype", "float32")))


def _numpy_tree(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_numpy_tree(v) for v in obj]
    return obj


def _torch_tree(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, dict):
        return {k: _torch_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_torch_tree(v) for v in obj]
    return obj


def check_ckpt_backend(config: Dict[str, Any]) -> None:
    backend = (config.get("train", {}) or {}).get("ckpt_backend", "pickle")
    if backend != "pickle":
        raise NotImplementedError(f"train.ckpt_backend `{backend}`: only "
                                  "pickle is ported; orbax is ROADMAP A16")


def save_checkpoint(path: str, model: RCNN, step, best_value: float,
                    config: Dict[str, Any], args: argparse.Namespace) -> None:
    """``model``'s checkpoint in the JAX package's payload (utils/ckpt.py),
    with ``step``'s optimizer state and schedule step (a train_step
    ``_Step``)."""
    params, state = jax_params_from_state_dict(model.state_dict())
    ckpt_util.save_ckpt(
        path, params=params, state=state,
        torch_opt_state=_numpy_tree(step.optimizer.state_dict()),
        lr_step=step.step, best_value=best_value, config=config,
        args=vars(args))


def resume(path: str, model: RCNN, step, metric: str = "val mAP") -> float:
    """Resume from ``path`` (JAX's mimic_runner.py:88-96,
    coco_runner.py:75-87, ext_runner.py:206-214): the model's weights, and
    the optimizer state and schedule step when the port wrote the file (a
    JAX checkpoint's optax state is not read: a fresh optimizer state).
    Returns the best value of ``metric`` so far."""
    payload = ckpt_util.load_ckpt(path)
    load_weights(model, payload["params"], payload.get("state"))
    if payload.get("torch_opt_state") is not None:
        step.optimizer.load_state_dict(_torch_tree(payload["torch_opt_state"]))
    else:
        print(f"{path} holds no optimizer state of this package: a fresh "
              "optimizer state", flush=True)
    step.step = int(payload.get("lr_step") or 0)
    best = float(payload.get("best_value", 0.0))
    print(f"resumed from {path} (best {metric} {best:.4f}, step {step.step})",
          flush=True)
    return best


def compute_dtype_from_config(config: Dict[str, Any]) -> torch.dtype:
    """``tpu.compute_dtype``: bfloat16 (the JAX package's default) or
    float32."""
    name = (config.get("tpu", {}) or {}).get("compute_dtype", "bfloat16")
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"tpu.compute_dtype `{name}` is not one of "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def configure_precision(compute_dtype: torch.dtype) -> None:
    """Honour the compute dtype.  TF32 stays off: it would compute the
    float32 parts (bfloat16 training's float32 losses and the float32
    eval) as another function."""
    if compute_dtype not in COMPUTE_DTYPES.values():
        raise NotImplementedError(f"compute dtype {compute_dtype}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def eval_forward(model: RCNN, batch: Dict[str, torch.Tensor],
                 use_bottleneck_transformer: bool) -> Dict[str, torch.Tensor]:
    batch = dict(batch, images=images_to_compute(batch["images"],
                                                 torch.float32))
    return model(batch, use_bottleneck_transformer=use_bottleneck_transformer)


def to_device(batch: Dict[str, Any], device: torch.device):
    """A dict of arrays as tensors on ``device``; host arrays go to the
    card through pinned memory, without blocking the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


class Timed:
    """Iterates ``iterable`` and adds the time each item took to arrive to
    ``seconds`` (a loader's share of a loop), counting the items in
    ``items``."""

    def __init__(self, iterable: Iterable):
        self.iterable = iterable
        self.seconds = 0.0
        self.items = 0

    def __iter__(self):
        it = iter(self.iterable)
        while True:
            t0 = time.perf_counter()
            item = next(it, None)
            self.seconds += time.perf_counter() - t0
            if item is None:
                return
            self.items += 1
            yield item


def evaluate(model: RCNN, batches: Iterable, use_bottleneck_transformer:
             bool = False, evaluator: Optional[CocoEvaluator] = None
             ) -> List[Dict[str, Any]]:
    """Serve ``batches`` on the model's device: dicts of arrays (images
    [B, H, W, 3] uint8 or float in [0, 1], image_sizes, original_sizes), or
    the loader's (batch, targets, host_targets).

    Returns one record per batch: ``ms``, the time from the batch's
    dispatch to its detections on the host (CUDA events on the card, the
    host clock on the CPU), and ``dets`` (numpy arrays).  With
    ``evaluator`` (loader batches), each batch's detections are finalized
    and fed to it, skipping the ``is_padding`` rows, while the next batch
    runs, as JAX's evaluate does (common.py:272-287); its records then hold
    ``host_ms``, the time of that step, in place of ``dets``.  The
    images of a batch are finalized on ``HND_TPU_POSTPROC_THREADS``
    threads (``os.cpu_count()`` unless set) when the evaluator has ``segm``
    or ``keypoints`` and that is more than one."""
    heavy = evaluator is not None and bool(
        {"segm", "keypoints"} & set(evaluator.iou_types))
    n_threads = int(os.environ.get("HND_TPU_POSTPROC_THREADS",
                                   os.cpu_count() or 1))
    if heavy and n_threads > 1:
        with ThreadPoolExecutor(n_threads) as pool:
            return _evaluate(model, batches, use_bottleneck_transformer,
                             evaluator, pool)
    return _evaluate(model, batches, use_bottleneck_transformer, evaluator,
                     None)


def _evaluate(model: RCNN, batches: Iterable, use_bottleneck_transformer:
              bool, evaluator: Optional[CocoEvaluator],
              pool: Optional[ThreadPoolExecutor]) -> List[Dict[str, Any]]:
    configure_precision(torch.float32)
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    records: List[Dict[str, Any]] = []
    pending = None

    def finish(p):
        host, done, start, t0, host_targets, sizes = p
        if cuda:
            done.synchronize()
            ms = start.elapsed_time(done)
        else:
            ms = (time.perf_counter() - t0) * 1e3
        dets = {k: v.numpy() for k, v in host.items()}
        if evaluator is None:
            records.append({"dets": dets, "ms": ms})
            return
        t1 = time.perf_counter()
        live = [(i, tgt) for i, tgt in enumerate(host_targets)
                if not tgt.get("is_padding")]

        def one(item):
            i, tgt = item
            return tgt["image_id"], finalize_predictions(
                dets, i, tuple(tgt["original_size"]),
                (int(sizes[i][0]), int(sizes[i][1])))

        evaluator.update(dict(map(one, live) if pool is None
                              else pool.map(one, live)))
        records.append({"ms": ms,
                        "host_ms": (time.perf_counter() - t1) * 1e3})

    for item in batches:
        batch, host_targets = item, None
        if isinstance(item, tuple):
            batch, _, host_targets = item
        if evaluator is not None and host_targets is None:
            raise ValueError("evaluate: an evaluator needs the loader's "
                             "(batch, targets, host_targets)")
        t0 = time.perf_counter()
        start = done = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
        dets = eval_forward(model, to_device(batch, device),
                            use_bottleneck_transformer)
        if cuda:
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in dets.items()}
            for k, v in dets.items():
                host[k].copy_(v, non_blocking=True)
            done.record()
        else:
            host = dets
        if pending is not None:
            finish(pending)
        pending = (host, done, start, t0, host_targets,
                   None if host_targets is None
                   else np.asarray(batch["image_sizes"]))
    if pending is not None:
        finish(pending)
    return records


def coco_evaluate(model: RCNN, loader, use_bottleneck_transformer: bool =
                  False) -> Tuple[CocoEvaluator, Dict[str, float]]:
    """One COCO evaluation pass over ``loader`` (JAX's ``evaluate``):
    returns the summarized CocoEvaluator (``stats[iou_type]``, the 12 or 10
    COCOeval numbers) and the pass's times: ``seconds`` (wall),
    ``loader_s`` (waiting on the loader), ``forward_ms`` (the batches'
    dispatch-to-host times), ``cocoeval_s`` (finalize, update, accumulate
    and summarize on the host) and ``batches``."""
    evaluator = CocoEvaluator(loader.dataset, get_iou_types(model))
    batches = Timed(loader)
    t0 = time.perf_counter()
    records = evaluate(model, batches, use_bottleneck_transformer, evaluator)
    t1 = time.perf_counter()
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    evaluator.summarize()
    t2 = time.perf_counter()
    return evaluator, {
        "seconds": t2 - t0, "loader_s": batches.seconds,
        "batches": len(records),
        "forward_ms": sum(r["ms"] for r in records),
        "cocoeval_s": sum(r["host_ms"] for r in records) / 1e3 + (t2 - t1)}


class StepMetrics:
    """Delayed reads of step scalars (hnd_ghnd_tpu/runners/common.py
    StepMetrics, with a lag of one step).

    ``push`` starts a copy of the step's loss and terms into pinned host
    memory and records a CUDA event behind it; the host waits on that event
    only when the entry is one step old, by which time the next step is
    already queued.  On the CPU the values are read as they
    are.  Each entry read is (step index, loss, {term: value}, ms), with ms
    the time between the step's start and end events (None on the CPU)."""

    LAG = 1

    def __init__(self):
        self._pending: deque = deque()

    def push(self, step_index: int, loss: torch.Tensor,
             terms: Dict[str, torch.Tensor], start=None) -> List[Tuple]:
        """``start``: a CUDA event recorded before the step was queued."""
        names = list(terms)
        values = torch.stack([loss.float()] + [terms[k].float() for k in names])
        done = None
        if values.is_cuda:
            host = torch.empty(values.shape, dtype=values.dtype,
                               pin_memory=True)
            host.copy_(values, non_blocking=True)
            done = torch.cuda.Event(enable_timing=start is not None)
            done.record()
            values = host
        self._pending.append((step_index, names, values, start, done))
        out = []
        while len(self._pending) > self.LAG:
            out.append(self._read_one())
        return out

    def drain(self) -> List[Tuple]:
        out = []
        while self._pending:
            out.append(self._read_one())
        return out

    def _read_one(self):
        idx, names, values, start, done = self._pending.popleft()
        ms = None
        if done is not None:
            done.synchronize()
            if start is not None:
                ms = start.elapsed_time(done)
        vals = values.tolist()
        return idx, vals[0], dict(zip(names, vals[1:])), ms
