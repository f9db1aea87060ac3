"""Config-driven construction of the models (reference YAML schema).

Counterpart of hnd_ghnd_tpu/models/factory.py for the slices this package
runs: a ``faster_rcnn`` with the stock ResNet-50 trunk (the org model of
config/org and the distillation teacher), and a ``faster_rcnn`` student
whose ``layer1`` is a Bottleneck4LargeResNet, with an optional [quantizer,
dequantizer] bottleneck transformer.  Every other feature of the schema
raises NotImplementedError naming the ROADMAP item that ports it; nothing
falls back silently.  ``frozen_modules``, and the trunk's conv1, bn1 and
layer1 under ``backbone.params.freeze_layers`` (the reference's
freeze_layers, as hnd_ghnd_tpu/runners/coco_runner.py:53-58 adds them),
turn ``requires_grad`` off (utils/params.set_trainable).

``init_model`` draws seeded random weights from an explicit
``torch.Generator`` with the JAX package's init distributions.  The zoo
weights that ``params.pretrained`` asks for are not in the repository:
``get_model`` says so and keeps the seeded init, as JAX's does.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List

import torch
from torch import nn

from hnd_ghnd_tpu_torch.models import layers as L
from hnd_ghnd_tpu_torch.models.bottleneck import Bottleneck4LargeResNet
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.utils.params import set_trainable

logger = logging.getLogger(__name__)

BOTTLENECK_NAMES = {"Bottleneck4LargeResNet", "Bottleneck4SmallResNet"}
# what the reference's freeze_layers leaves out of training: the trunk
# except layer2-4 (src/models/org/rcnn.py:399-404)
FREEZE_LAYERS = ["backbone.body.conv1", "backbone.body.bn1",
                 "backbone.body.layer1"]


def _quant_bits(transformer_cfg) -> int:
    if not transformer_cfg:
        return 8
    order = list(transformer_cfg["order"])
    if order != ["quantizer", "dequantizer"]:
        raise NotImplementedError(
            f"bottleneck transformer {order}: only [quantizer, dequantizer] is "
            "ported; JPEG chains are ROADMAP A10")
    comp = transformer_cfg.get("components", {}) or {}
    q = (comp.get("quantizer", {}) or {}).get("params", {}) or {}
    return int(q.get("num_bits", 8))


def frozen_modules(model_config: Dict[str, Any]) -> List[str]:
    """``frozen_modules`` plus, under ``backbone.params.freeze_layers``,
    the trunk's conv1, bn1 and layer1."""
    frozen = list(model_config.get("frozen_modules", []) or [])
    if (model_config["backbone"].get("params", {}) or {}).get("freeze_layers"):
        frozen += FREEZE_LAYERS
    return frozen


def build_model(model_config: Dict[str, Any]) -> RCNN:
    """An RCNN in eval mode on the CPU from a ``model``, ``teacher_model``
    or ``student_model`` block, with ``frozen_modules`` frozen."""
    kind = model_config["name"]
    if kind in ("mask_rcnn", "keypoint_rcnn"):
        raise NotImplementedError(f"{kind}: mask/keypoint heads are ROADMAP A8")
    if kind != "faster_rcnn":
        raise KeyError(f"model name `{kind}` is not expected")
    backbone_cfg = model_config["backbone"]
    if backbone_cfg["name"] not in ("resnet50", "custom_resnet50"):
        raise NotImplementedError(
            f"backbone {backbone_cfg['name']}: only resnet50 is ported")
    if backbone_cfg.get("ext_config") is not None:
        raise NotImplementedError("ext_config: the ext filter is ROADMAP A9")
    layer1_cfg = (backbone_cfg.get("params", {}) or {}).get("layer1")
    if layer1_cfg is not None and layer1_cfg["name"] not in BOTTLENECK_NAMES:
        raise ValueError(f"layer1 name `{layer1_cfg['name']}` is not expected")
    params_cfg = model_config.get("params", {}) or {}
    if params_cfg.get("int8_roi_pool"):
        raise NotImplementedError("int8_roi_pool tables are ROADMAP B3")
    if params_cfg.get("roi_pool_impl", "auto") not in ("auto", "pallas"):
        raise NotImplementedError(
            "roi_pool_impl: the port has one RoIAlign (the CUDA kernel, its "
            "plain version on the CPU)")
    # the reference builds the Large variant for the Small name too
    bottleneck = None if layer1_cfg is None else Bottleneck4LargeResNet(
        int(layer1_cfg["bottleneck_channel"]),
        quant_bits=_quant_bits(model_config.get("bottleneck_transformer")))
    model = RCNN(bottleneck, num_classes=int(params_cfg.get("num_classes", 91)))
    set_trainable(model, frozen_modules(model_config))
    return model.eval()


def init_model(model: RCNN, generator: torch.Generator) -> RCNN:
    """Seeded init in place, with the JAX package's distributions: trunk
    convs kaiming-normal(fan_out), bottleneck convs and linears torch's
    default uniform, FPN uniform(a=1) with zero bias, RPN normal(0.01),
    identity frozen BN except a zero scale on each block's last BN."""
    injected = model.backbone.body.injected
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d):
            if injected and name.startswith("backbone.body.layer1."):
                L.kaiming_uniform_(m.weight, generator)
            elif name.startswith("backbone.body."):
                L.fan_out_normal_(m.weight, generator)
            elif name.startswith("backbone.fpn."):
                L.kaiming_uniform_(m.weight, generator, a=1.0)
            else:
                L.normal_(m.weight, 0.01, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Linear):
            L.linear_init_(m, generator)
        elif isinstance(m, (L.FrozenBatchNorm2d, nn.BatchNorm2d)):
            m.weight.data.fill_(0.0 if name.endswith(".bn3") else 1.0)
            m.bias.data.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return model


def get_model(model_config: Dict[str, Any], seed: int = 0,
              device: str | torch.device = "cuda") -> RCNN:
    """Build, init from ``seed``, and move to ``device``: the card unless
    the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: no CUDA device; pass device='cpu' to "
                           "build the model on the CPU")
    model = build_model(model_config)
    init_model(model, torch.Generator().manual_seed(seed))
    if (model_config.get("params", {}) or {}).get("pretrained"):
        logger.warning("pretrained=True but the zoo weights are not in the "
                       "repository; using the seeded init")
    return model.to(device)
