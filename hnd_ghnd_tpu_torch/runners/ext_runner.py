"""Neural-filter ("ext") training entry point.

Counterpart of hnd_ghnd_tpu/runners/ext_runner.py (reference
src/ext_runner.py): trains the two-class filter that sits on the
bottleneck of a frozen detector (models/ext.py).  A label says whether an
image holds a valid target (``check_if_valid_target``); the loss is the
cross-entropy averaged over every row of the batch, the loader's padding
rows included, as in JAX; the epoch's model is kept when its val ROC-AUC
rises, written to ``ext_config.ckpt`` with its optimizer state, and
training resumes from that file.  The test report (accuracy, recall,
specificity, ROC-AUC and the threshold/TPR/FPR table at ``--min_recall``)
always runs the best checkpoint.

The filter trains in float32 whatever ``tpu.compute_dtype`` says: JAX's
ext step feeds the loader's float32 pixels to float32 parameters
(ext_runner.py:73-99).  Only the filter's parameters train, by SGD with
MultiStepLR by epoch and no warmup; every other parameter stays
bit-identical (JAX's chain decays them by lr * weight_decay * p a step,
ROADMAP C7).  ROC metrics are evals/roc.py's numpy ones and the table is
printed without pandas.

    python -m hnd_ghnd_tpu_torch.runners.ext_runner --config <yaml> \\
        -train [--device cpu]

N ranks (``torchrun``, or ``--dist_url env://``) run JAX's GSPMD step on
the global batch (``ExtStep``) and gather the scores, so the best
checkpoint, written by rank 0, is the same choice on every rank.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from hnd_ghnd_tpu_torch.core.config import load_config, overwrite_config
from hnd_ghnd_tpu_torch.data.coco import check_if_valid_target
from hnd_ghnd_tpu_torch.evals.roc import roc_auc_score, roc_curve
from hnd_ghnd_tpu_torch.models.factory import get_model, load_weights
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.parallel import multihost
from hnd_ghnd_tpu_torch.parallel.train_step import (_Step, build_optimizer,
                                                    images_to_compute)
from hnd_ghnd_tpu_torch.runners import common
from hnd_ghnd_tpu_torch.runners.common import (StepMetrics,
                                               configure_precision, to_device)
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util

EXT_PREFIX = "backbone.body.layer1.encoder.ext_classifier."


def get_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Ext (neural filter) runner")
    common.add_common_args(parser)
    parser.add_argument("-train", action="store_true")
    parser.add_argument("-test_only", action="store_true")
    parser.add_argument("--min_recall", type=float, default=0.98)
    parser.add_argument("--profile_dir", default=None,
                        help="not ported (ROADMAP A18): raises")
    parser.add_argument("--tb_dir", default=None,
                        help="not ported (ROADMAP A18): raises")
    return parser


def host_target_to_ext_label(target: Dict, keypoint_task: bool) -> int:
    """1 when the loader's host target holds a valid target (the
    reference's convert_target2ext_targets, src/ext_runner.py:34-36)."""
    anns = []
    boxes = target.get("boxes", np.zeros((0, 4)))
    for i in range(len(boxes)):
        ann = {"bbox": [float(boxes[i, 0]), float(boxes[i, 1]),
                        float(boxes[i, 2] - boxes[i, 0]),
                        float(boxes[i, 3] - boxes[i, 1])]}
        if "keypoints" in target:
            ann["keypoints"] = np.asarray(
                target["keypoints"][i]).reshape(-1).tolist()
        anns.append(ann)
    return int(check_if_valid_target(anns, keypoint_task=keypoint_task))


class ExtStep(_Step):
    """One step of the filter: zero grads, the mean cross-entropy of its
    float32 logits, backward, lr = schedule(step), SGD.  Returns the loss
    as a device tensor, without waiting for the device.

    With N > 1 ranks the step is JAX's GSPMD one (ext_runner.py:73-96) on
    the global batch: the filter's BNs take the global statistics and the
    gradients and the loss are averaged over the ranks (each rank's loss
    is the mean over its equal share of the batch)."""

    def __init__(self, model: RCNN, optimizer: torch.optim.Optimizer,
                 schedule):
        super().__init__(optimizer, schedule)
        self.model = model

    def __call__(self, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model({"images": images_to_compute(images,
                                                         torch.float32)},
                            ext_training=True)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        loss, _ = self.all_reduce(loss, {}, "avg")
        self.apply_update()
        return loss


def make_ext_train_step(model: RCNN, optimizer_cfg: dict,
                        scheduler_cfg: Optional[dict] = None,
                        steps_per_epoch: int = 1) -> ExtStep:
    """The step over the filter's parameters alone: ``requires_grad`` is
    turned off for every other one (JAX's ``_ext_only_mask``)."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith(EXT_PREFIX))
        if p.requires_grad:
            trainable.append(p)
    if not trainable:
        raise ValueError("ext_runner needs a bottleneck model with an "
                         "ext_config")
    optimizer, schedule = build_optimizer(trainable, optimizer_cfg,
                                          scheduler_cfg, steps_per_epoch)
    return ExtStep(model, optimizer, schedule)


def collect_probs(model: RCNN, loader, keypoint_task: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The filter's P(valid) and the label of every image of ``loader``
    that is not padding, in eval mode.  With N > 1 ranks, each scores its
    shard and the arrays are every rank's, concatenated in rank order
    (ext_runner.py:132-137), so the ROC-AUC and the best checkpoint agree
    on every rank."""
    device = next(model.parameters()).device
    model.eval()
    probs: List[float] = []
    labels: List[int] = []
    for batch, _, host_targets in loader:
        images = to_device({"images": batch["images"]}, device)["images"]
        pr = model({"images": images_to_compute(images, torch.float32)},
                   ext_training=True)[:, 1].cpu().numpy()
        for i, tgt in enumerate(host_targets):
            if tgt.get("is_padding"):
                continue
            probs.append(float(pr[i]))
            labels.append(host_target_to_ext_label(tgt, keypoint_task))
    gathered = multihost.all_gather_objects((np.asarray(probs),
                                             np.asarray(labels)))
    return (np.concatenate([g[0] for g in gathered]),
            np.concatenate([g[1] for g in gathered]))


def summarize_cls(probs: np.ndarray, labels: np.ndarray,
                  threshold: float = 0.5):
    """(accuracy, recall, specificity, ROC-AUC) at ``threshold``, printed
    as JAX's ``summarize_cls`` prints them; ROC-AUC is NaN on one class."""
    preds = (probs >= threshold).astype(int)
    acc = float((preds == labels).mean())
    tp = int(((preds == 1) & (labels == 1)).sum())
    tn = int(((preds == 0) & (labels == 0)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    recall = tp / max(tp + fn, 1)
    specificity = tn / max(tn + fp, 1)
    try:
        auc = roc_auc_score(labels, probs)
    except ValueError:
        auc = float("nan")
    print(f"accuracy: {acc:.4f} recall: {recall:.4f} "
          f"specificity: {specificity:.4f} ROC-AUC: {auc:.4f}", flush=True)
    return acc, recall, specificity, auc


def print_threshold_table(probs: np.ndarray, labels: np.ndarray,
                          min_recall: float) -> List[Tuple[float, ...]]:
    """The reference's threshold/TPR/FPR report (src/ext_runner.py:112-119):
    the ROC curve's operating points with TPR >= ``min_recall``, or all of
    them when none reaches it.  Returns the printed rows (threshold, tpr,
    fpr)."""
    try:
        fpr, tpr, thr = roc_curve(labels, probs)
    except ValueError:
        print("single-class labels; no ROC curve", flush=True)
        return []
    rows = list(zip(thr.tolist(), tpr.tolist(), fpr.tolist()))
    ok = [r for r in rows if r[1] >= min_recall]
    rows = ok or rows
    cells = [("threshold", "tpr", "fpr")] + [
        tuple(f"{v:.6f}" for v in r) for r in rows]
    widths = [max(len(c[j]) for c in cells) for j in range(3)]
    print(f"operating points with recall >= {min_recall}:")
    for c in cells:
        print(" ".join(v.rjust(w) for v, w in zip(c, widths)))
    return rows


def train_ext(model: RCNN, config: Dict[str, Any], args: argparse.Namespace,
              train_loader, val_loader, keypoint_task: bool,
              ckpt_path: Optional[str]) -> Dict[str, List]:
    """The epochs of ext_runner.py:196-280: each over ``train_loader``, its
    val scores, the checkpoint at ``ckpt_path`` when the val ROC-AUC rises;
    resumed from that file when it exists.  Returns {"steps": [(step,
    loss, {}, ms)], "epochs": [{"val": (acc, recall, specificity, auc),
    "saved", "train" and "eval": {"seconds", "loader_s", "batches"}}]}
    (the train times the ranks' mean).  At N ranks an epoch is
    ``len(train_loader)`` steps on every rank (``common.epoch_batches``)."""
    train_cfg = config["train"]
    device = next(model.parameters()).device
    cuda = device.type == "cuda"
    step = make_ext_train_step(model, train_cfg["optimizer"],
                               train_cfg.get("scheduler"),
                               max(len(train_loader), 1))
    best = 0.0
    if ckpt_util.check_if_exists(ckpt_path):
        best = common.resume(ckpt_path, model, step, metric="ROC-AUC")
    history: Dict[str, List] = {"steps": [], "epochs": []}
    for epoch in range(int(train_cfg["num_epochs"])):
        train_loader.set_epoch(epoch)
        model.train()
        metrics = StepMetrics()
        t0 = time.perf_counter()
        batches = common.Timed(common.epoch_batches(train_loader))
        for batch, _, host in batches:
            labels = torch.tensor([host_target_to_ext_label(t, keypoint_task)
                                   for t in host], device=device)
            images = to_device({"images": batch["images"]}, device)["images"]
            start = None
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            loss = step(images, labels)
            history["steps"] += metrics.push(step.step - 1, loss, {}, start)
        history["steps"] += metrics.drain()
        train = common.mean_over_ranks({
            "seconds": time.perf_counter() - t0, "loader_s": batches.seconds,
            "batches": batches.items})
        t0 = time.perf_counter()
        val = common.Timed(val_loader)
        probs, labels = collect_probs(model, val, keypoint_task)
        scores = summarize_cls(probs, labels)
        ev = {"seconds": time.perf_counter() - t0, "loader_s": val.seconds,
              "batches": val.items}
        saved = bool(scores[3] > best and ckpt_path)
        if saved:
            best = scores[3]
            multihost.save_on_master(common.save_checkpoint, ckpt_path,
                                     model, step, best, config, args)
            print(f"saved best ckpt (val ROC-AUC {best:.4f})", flush=True)
        history["epochs"].append({"val": scores, "saved": saved,
                                  "train": train, "eval": ev})
    return history


def run(config: Dict[str, Any], args: argparse.Namespace) -> Dict[str, Any]:
    """``main`` after the config is loaded.  Returns {"train": the history
    of ``train_ext`` (with -train), "test": {"scores": (acc, recall,
    specificity, auc), "table": the threshold rows, "n": images,
    "batches"}}.  As N ranks (``common.distributed``), each on its shard;
    the scores are the gathered arrays'."""
    common.check_unported_args(args)
    common.check_ckpt_backend(config)
    with common.distributed(args) as device:
        return _run(config, args, device)


def _run(config: Dict[str, Any], args: argparse.Namespace,
         device: torch.device) -> Dict[str, Any]:
    configure_precision(torch.float32)
    model = get_model(config["model"], seed=args.seed, device=device)
    keypoint_task = model.kind == "keypoint_rcnn"
    ckpt_path = (config["model"]["backbone"].get("ext_config") or {}).get(
        "ckpt")
    batch_size = int(config["train"]["batch_size"])
    train_loader, val_loader, test_loader = common.loaders_from_config(
        config, model.kind, batch_size)
    out: Dict[str, Any] = {}
    if args.train:
        common.log_global_batch(batch_size, train_loader)
        out["train"] = train_ext(model, config, args, train_loader,
                                 val_loader, keypoint_task, ckpt_path)
        # rank 0's last checkpoint write is done before any rank reads it
        multihost.barrier()
    # the test report always runs the best filter (ext_runner.py:282-286)
    if ckpt_util.check_if_exists(ckpt_path):
        payload = ckpt_util.load_ckpt(ckpt_path)
        load_weights(model, payload["params"], payload.get("state"))
    test = common.Timed(test_loader)
    probs, labels = collect_probs(model, test, keypoint_task)
    scores = summarize_cls(probs, labels)
    table = print_threshold_table(probs, labels, args.min_recall)
    out["test"] = {"scores": scores, "table": table, "n": len(labels),
                   "batches": test.items}
    return out


def main(args: argparse.Namespace) -> Dict[str, Any]:
    config = overwrite_config(load_config(args.config), args.json)
    return run(config, args)


def cli():
    main(get_argparser().parse_args())


if __name__ == "__main__":
    cli()
