"""Student-design helper: does a candidate student backbone give the
teacher's tensor shapes at the capture points?

Counterpart of tools/design_helper.py (the reference's
src/student_design_helper.ipynb, ``compare_io_shapes`` /
``check_if_shape_match`` on a random input).  Shapes are NCHW; the names
are the port's module paths (the reference's).

    python -m hnd_ghnd_tpu_torch.tools.design_helper [--teacher resnet50]
        [--student custom_resnet50] [--bottleneck 3] [--height 192]
        [--width 256] [--device cpu]

Exits 0 when every capture point matches, else 1.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import numpy as np
import torch

CAPTURE_POINTS = ("backbone.body.layer1", "backbone.body.layer2",
                  "backbone.body.layer3", "backbone.body.layer4",
                  "backbone.fpn")


@torch.no_grad()
def shapes_at_capture_points(model, images: torch.Tensor) -> Dict[str, Any]:
    """{``backbone.body.layer{i}``: NCHW shape, ``backbone.fpn``: [the
    shapes of P2..P6]} of ``model``'s eval forward on ``images``
    [B, H, W, 3]."""
    body, fpn = model.eval().backbone_features(images)
    out = {f"backbone.body.layer{i}": tuple(body[f"layer{i}"].shape)
           for i in (1, 2, 3, 4)}
    out["backbone.fpn"] = [tuple(f.shape) for f in fpn]
    return out


def check_if_shape_match(teacher_shapes, student_shapes) -> bool:
    ok = True
    for key in teacher_shapes:
        t, s = teacher_shapes[key], student_shapes.get(key)
        match = t == s
        print(f"{key:26s} teacher={t} student={s} "
              f"{'OK' if match else 'MISMATCH'}")
        ok &= match
    return ok


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="student design helper")
    p.add_argument("--teacher", default="resnet50")
    p.add_argument("--student", default="custom_resnet50")
    p.add_argument("--bottleneck", type=int, default=3)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def main(argv=None) -> Dict[str, Any]:
    """Returns {"teacher", "student": the shapes, "ok": all match}."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    args = get_argparser().parse_args(argv)
    teacher = get_model({
        "name": "faster_rcnn",
        "backbone": {"name": args.teacher,
                     "params": {"pretrained": False, "freeze_layers": True}},
        "params": {"num_classes": 91}}, seed=0, device=args.device)
    student = get_model({
        "name": "faster_rcnn",
        "backbone": {"name": args.student,
                     "params": {"pretrained": False, "freeze_layers": False,
                                "layer1": {"name": "Bottleneck4LargeResNet",
                                           "bottleneck_channel":
                                               args.bottleneck}}},
        "params": {"num_classes": 91}}, seed=1, device=args.device)
    images = torch.from_numpy(np.random.RandomState(0).rand(
        1, args.height, args.width, 3).astype(np.float32)).to(args.device)
    t_shapes = shapes_at_capture_points(teacher, images)
    s_shapes = shapes_at_capture_points(student, images)
    ok = check_if_shape_match(t_shapes, s_shapes)
    print("shape-compatible" if ok else "NOT compatible", flush=True)
    return {"teacher": t_shapes, "student": s_shapes, "ok": ok}


def cli() -> None:
    sys.exit(0 if main()["ok"] else 1)


if __name__ == "__main__":
    cli()
