"""Complexity analyzer: parameter counts by module depth and the tensor
sizes of each backbone stage.

Counterpart of tools/complexity_analyzer.py (the reference's
src/complexity_analyzer.ipynb: ``count_model_params`` tables, and the
tensor sizes that put the split at layer1, the first point where the
feature tensor is smaller than the input).  Names are the port's module
paths (the reference's); shapes are NCHW.

    python -m hnd_ghnd_tpu_torch.tools.complexity_analyzer \\
        [--model faster_rcnn] [--bottleneck 3] [--height 256 --width 256] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def param_table(model: torch.nn.Module, depth: int = 2
                ) -> List[Tuple[str, int]]:
    """(module path cut to ``depth`` components, parameter count) in the
    order the modules come, frozen parameters included."""
    out: Dict[str, int] = {}
    for name, p in model.named_parameters():
        key = ".".join(name.split(".")[:-1][:depth])
        out[key] = out.get(key, 0) + p.numel()
    return list(out.items())


def _kb(t: torch.Tensor) -> float:
    return float(np.prod(t.shape)) * 4 / 1024


@torch.no_grad()
def tensor_size_report(model, h: int, w: int) -> Dict[str, Any]:
    """Prints the input's and each stage's fp32 size at ``h`` x ``w``
    (batch 1), and the bottleneck tensor's at fp32, fp16 and int8.
    Returns {name: NCHW shape}."""
    device = next(model.parameters()).device
    images = torch.zeros((1, h, w, 3), device=device)
    x = model.normalize(images)
    input_kb = _kb(x)
    print(f"input  {tuple(x.shape)}  {input_kb:9.1f} KB (fp32)")
    body = model.eval().backbone.body
    feats = body(x)
    shapes = {"input": tuple(x.shape)}
    for name in ("layer1", "layer2", "layer3", "layer4"):
        f = feats[name]
        kb = _kb(f)
        marker = "  <= smaller than input" if kb < input_kb else ""
        print(f"{name:6s} {tuple(f.shape)}  {kb:9.1f} KB{marker}")
        shapes[name] = tuple(f.shape)
    if body.injected:
        z = body.layer1.encode(body.stem(x))
        kb32 = _kb(z)
        print(f"bottleneck z {tuple(z.shape)}  fp32 {kb32:.1f} KB  "
              f"fp16 {kb32 / 2:.1f} KB  int8 {kb32 / 4:.1f} KB  "
              f"({100 * (kb32 / 4) / (input_kb / 4):.1f}% of uint8 input)")
        shapes["bottleneck"] = tuple(z.shape)
    return shapes


def get_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="complexity analyzer")
    p.add_argument("--model", default="faster_rcnn",
                   choices=["faster_rcnn", "mask_rcnn", "keypoint_rcnn"])
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--bottleneck", type=int, default=None)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    return p


def model_config(model: str, backbone: str, bottleneck=None,
                 num_classes: int = 91) -> Dict[str, Any]:
    """The analyzer's model block (JAX's complexity_analyzer.main)."""
    bb = {"name": backbone,
          "params": {"pretrained": False, "freeze_layers": False}}
    if bottleneck:
        bb["name"] = backbone if backbone.startswith("custom_") \
            else f"custom_{backbone}"
        bb["params"]["layer1"] = {"name": "Bottleneck4LargeResNet",
                                  "bottleneck_channel": bottleneck}
    return {"name": model, "backbone": bb,
            "params": {"num_classes": num_classes}}


def main(argv=None) -> Dict[str, Any]:
    """Returns {"params": [(name, count)], "total", "shapes"}."""
    from hnd_ghnd_tpu_torch.models.factory import get_model
    args = get_argparser().parse_args(argv)
    model = get_model(model_config(args.model, args.backbone,
                                   args.bottleneck), seed=0,
                      device=args.device)
    print("== parameter counts ==")
    table = param_table(model, depth=2)
    for name, n in table:
        print(f"{name:32s} {n:>12,}")
    total = sum(n for _, n in table)
    print(f"{'TOTAL':32s} {total:>12,}")
    print()
    print(f"== intermediate tensor sizes at {args.height}x{args.width} ==")
    shapes = tensor_size_report(model, args.height, args.width)
    return {"params": table, "total": total, "shapes": shapes}


if __name__ == "__main__":
    main()
