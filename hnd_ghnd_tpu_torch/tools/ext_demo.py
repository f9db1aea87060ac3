"""Ext neural-filter learning demonstration, on one card.

Counterpart of tools/ext_demo.py: trains the two-class filter of a frozen
GHND b3ch student on a synthetic fixture where ~45% of the images are
empty (16 images, seed 21, two classes), through
``runners/ext_runner.ExtStep`` (float32, SGD 0.01, momentum 0.9, no decay;
40 epochs of 4 batches of 4 at the 96x96 bucket), then scores every image
with ``collect_probs`` and prints ``summarize_cls``, the threshold table
at recall 0.98 and ``RESULT ext-filter ROC-AUC=``.

    python -m hnd_ghnd_tpu_torch.tools.ext_demo [--epochs 40]
        [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time
from typing import Any, Dict

import torch

BUCKETS = ((96, 96),)

MODEL = {
    "name": "faster_rcnn",
    "backbone": {"name": "custom_resnet50",
                 "params": {"pretrained": False, "freeze_layers": True,
                            "layer1": {"name": "Bottleneck4LargeResNet",
                                       "bottleneck_channel": 3}},
                 "ext_config": {"backbone_frozen": True, "threshold": 0.01}},
    "params": {"num_classes": 3}}


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ext filter learning demo")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--out", default=None,
                   help="fixture directory (a temporary one by default)")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def main(argv=None) -> Dict[str, Any]:
    args = get_argparser().parse_args(argv)
    with contextlib.ExitStack() as stack:
        out_dir = args.out or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="ext_demo_"))
        return run(args, out_dir)


def run(args: argparse.Namespace, out_dir: str) -> Dict[str, Any]:
    from hnd_ghnd_tpu_torch.data.coco import CocoDataset
    from hnd_ghnd_tpu_torch.data.fixtures import make_coco_fixture
    from hnd_ghnd_tpu_torch.data.loader import DetectionLoader
    from hnd_ghnd_tpu_torch.models.factory import get_model
    from hnd_ghnd_tpu_torch.runners import common
    from hnd_ghnd_tpu_torch.runners.ext_runner import (
        collect_probs, host_target_to_ext_label, make_ext_train_step,
        print_threshold_table, summarize_cls)

    device = common.rank_device(args.device)
    common.configure_precision(torch.float32)
    img_dir, ann_file = make_coco_fixture(out_dir, num_images=16, seed=21,
                                          num_classes=2, empty_prob=0.45)
    ds = CocoDataset(img_dir, ann_file)
    loader = DetectionLoader(ds, 4, training=True, min_sizes=(64,),
                             max_size=96, buckets=BUCKETS, hflip_prob=0.0,
                             num_workers=2)
    eval_loader = DetectionLoader(ds, 1, training=False, min_sizes=(64,),
                                  max_size=96, buckets=BUCKETS, num_workers=2)
    model = get_model(MODEL, seed=0, device=device)
    step = make_ext_train_step(model, {"type": "SGD", "params": {
        "lr": 0.01, "momentum": 0.9, "weight_decay": 0.0}})
    batches = [(torch.as_tensor(batch["images"]).to(device),
                torch.tensor([host_target_to_ext_label(t, False)
                              for t in host], device=device))
               for batch, _, host in loader]
    model.train()
    t0 = time.perf_counter()
    losses = []
    for _ in range(args.epochs):
        for images, labels in batches:
            losses.append(step(images, labels))
    final = float(losses[-1])
    seconds = time.perf_counter() - t0
    print(f"final CE loss: {final:.6f} ({args.epochs} epochs of "
          f"{len(batches)} batches, {seconds:.1f} s)", flush=True)
    probs, labels = collect_probs(model, eval_loader, False)
    acc, recall, specificity, auc = summarize_cls(probs, labels)
    table = print_threshold_table(probs, labels, min_recall=0.98)
    print(f"RESULT ext-filter ROC-AUC={auc:.4f}", flush=True)
    return {"loss": (float(losses[0]), final), "train_s": seconds,
            "steps": len(losses), "auc": auc, "accuracy": acc,
            "recall": recall, "specificity": specificity, "table": table,
            "n": len(labels), "positives": int(labels.sum())}


if __name__ == "__main__":
    main()
