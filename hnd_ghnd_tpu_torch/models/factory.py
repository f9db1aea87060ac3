"""Config-driven construction of the models (reference YAML schema).

Counterpart of hnd_ghnd_tpu/models/factory.py for the slices this package
runs: a ``faster_rcnn``, ``mask_rcnn`` or ``keypoint_rcnn`` (``num_classes``
and ``num_keypoints`` from ``params``) with the stock ResNet-50 trunk (the
org model of config/org and the distillation teacher), or as a student
whose ``layer1`` is a Bottleneck4LargeResNet, with an optional
bottleneck transformer (a quantizer/dequantizer chain is the kernels' round
trip; one that names a JPEG component runs on the host) and, under
``backbone.ext_config``,
the ext filter with its gate (``threshold``, 0.01 by default);
``params.int8_roi_pool`` turns on the eval's int8 pooling tables, and
``params.kp_decode: device`` (with ``kp_decode_grid``, 224 by default) the
keypoint decode on the device.
Every other feature of the schema raises NotImplementedError naming the
ROADMAP item that ports it; nothing falls back silently.
``frozen_modules``, and the trunk's conv1, bn1 and layer1 under
``backbone.params.freeze_layers`` (the reference's freeze_layers, as
hnd_ghnd_tpu/runners/coco_runner.py:53-58 adds them), turn
``requires_grad`` off (utils/params.set_trainable).

``init_model`` draws seeded random weights from an explicit
``torch.Generator`` with the JAX package's init distributions.  The zoo
weights that ``params.pretrained`` asks for are not in the repository:
``get_model`` says so and keeps the seeded init, as JAX's does.  Then, as
in the JAX package (src/models/__init__.py:38-57's order), ``get_model``
loads the ext filter's ``ext_config.ckpt`` and then the model's own
``ckpt``, each when that file exists: a checkpoint of utils/ckpt.py,
written by either package, merged non-strictly.
"""
from __future__ import annotations

import logging
import math
from typing import Any, Dict, List

import torch
from torch import nn

from hnd_ghnd_tpu_torch.codec.quantizer import get_bottleneck_transformer
from hnd_ghnd_tpu_torch.models import layers as L
from hnd_ghnd_tpu_torch.models.bottleneck import Bottleneck4LargeResNet
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.ext import Ext4ResNet, init_ext_
from hnd_ghnd_tpu_torch.models.rcnn import RCNN
from hnd_ghnd_tpu_torch.utils import ckpt as ckpt_util
from hnd_ghnd_tpu_torch.utils.params import set_trainable

logger = logging.getLogger(__name__)

KINDS = ("faster_rcnn", "mask_rcnn", "keypoint_rcnn")
BOTTLENECK_NAMES = {"Bottleneck4LargeResNet", "Bottleneck4SmallResNet"}
# the mask head's convs: normal(std sqrt(2 / (kh * kw * cout))); the
# keypoint head's: normal(std sqrt(2 / fan_in)) (roi_heads.py:137-147,
# 165-180); zero biases
_HEAD_PREFIXES = ("roi_heads.mask_head.", "roi_heads.mask_predictor.",
                  "roi_heads.keypoint_head.", "roi_heads.keypoint_predictor.")
# what the reference's freeze_layers leaves out of training: the trunk
# except layer2-4 (src/models/org/rcnn.py:399-404)
FREEZE_LAYERS = ["backbone.body.conv1", "backbone.body.bn1",
                 "backbone.body.layer1"]


def _quant_bits(transformer_cfg) -> int:
    if not transformer_cfg:
        return 8
    comp = transformer_cfg.get("components", {}) or {}
    q = (comp.get("quantizer", {}) or {}).get("params", {}) or {}
    return int(q.get("num_bits", 8))


def _host_chain(transformer_cfg):
    """The host chain of a ``bottleneck_transformer`` that names a JPEG
    component, else None (a quantizer/dequantizer chain is the kernels'
    round trip at ``_quant_bits``), as JAX's factory.py:64-69 decides."""
    chain = get_bottleneck_transformer(transformer_cfg)
    return chain if chain is not None and chain.host_side else None


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
    if kind not in KINDS:
        raise KeyError(f"model name `{kind}` is not expected")
    backbone_cfg = model_config["backbone"]
    if backbone_cfg["name"] not in ("resnet50", "custom_resnet50"):
        raise NotImplementedError(
            f"backbone {backbone_cfg['name']}: only resnet50 is ported")
    ext_cfg = backbone_cfg.get("ext_config")
    layer1_cfg = (backbone_cfg.get("params", {}) or {}).get("layer1")
    if layer1_cfg is not None and layer1_cfg["name"] not in BOTTLENECK_NAMES:
        raise ValueError(f"layer1 name `{layer1_cfg['name']}` is not expected")
    params_cfg = model_config.get("params", {}) or {}
    if params_cfg.get("roi_pool_impl", "auto") not in ("auto", "pallas"):
        raise NotImplementedError(
            "roi_pool_impl: the port has one RoIAlign (the CUDA kernel, its "
            "plain version on the CPU)")
    # the reference builds the Large variant for the Small name too; the
    # ext filter lives in the bottleneck (JAX factory.py:59-72)
    transformer_cfg = model_config.get("bottleneck_transformer")
    bottleneck = None if layer1_cfg is None else Bottleneck4LargeResNet(
        int(layer1_cfg["bottleneck_channel"]),
        quant_bits=_quant_bits(transformer_cfg), ext=ext_cfg is not None,
        host_transformer=_host_chain(transformer_cfg))
    ext_threshold = None if bottleneck is None or ext_cfg is None \
        else float(ext_cfg.get("threshold", 0.01))
    model = RCNN(bottleneck, num_classes=int(params_cfg.get("num_classes", 91)),
                 kind=kind,
                 num_keypoints=int(params_cfg.get("num_keypoints", 17)),
                 int8_pool=bool(params_cfg.get("int8_roi_pool", False)),
                 kp_decode=str(params_cfg.get("kp_decode", "host")),
                 kp_decode_grid=int(params_cfg.get("kp_decode_grid", 224)),
                 ext_threshold=ext_threshold)
    set_trainable(model, frozen_modules(model_config))
    return model.eval()


def init_model(model: RCNN, generator: torch.Generator) -> RCNN:
    """Seeded init in place, with the JAX package's distributions: trunk
    convs kaiming-normal(fan_out), bottleneck convs and linears torch's
    default uniform, FPN uniform(a=1) with zero bias, RPN normal(0.01), the
    mask and keypoint heads' MSRA normals with zero bias, identity frozen
    BN except a zero scale on each block's last BN, and the ext filter's
    own (models/ext.init_ext_)."""
    injected = model.backbone.body.injected
    for name, m in model.named_modules():
        if isinstance(m, Ext4ResNet):
            init_ext_(m, generator)
        elif ".ext_classifier." in name:
            continue
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)) \
                and name.startswith(_HEAD_PREFIXES):
            kh, kw = m.kernel_size
            n = (m.out_channels if name.startswith("roi_heads.mask_")
                 else m.in_channels)
            L.normal_(m.weight, math.sqrt(2.0 / (kh * kw * n)), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
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


def load_weights(model: RCNN, params, state) -> RCNN:
    """Load JAX-layout (params, state) trees into ``model``, non-strict as
    the JAX package's ``merge_pytree`` (the reference's
    load_state_dict(strict=False)): entries the model lacks, or of another
    shape, are skipped with a warning."""
    own = model.state_dict()
    sd = {}
    for k, v in state_dict_from_jax(params, state or {}).items():
        if k not in own:
            logger.debug("checkpoint key %s not in the model; skipped", k)
        elif tuple(v.shape) != tuple(own[k].shape):
            logger.warning("shape mismatch at %s: model %s vs checkpoint %s; "
                           "kept the model's", k, tuple(own[k].shape),
                           tuple(v.shape))
        else:
            sd[k] = v.to(own[k].dtype)
    model.load_state_dict(sd, strict=False)
    return model


def get_model(model_config: Dict[str, Any], seed: int = 0,
              device: str | torch.device = "cuda") -> RCNN:
    """Build, init from ``seed``, load ``backbone.ext_config.ckpt`` and then
    ``model_config["ckpt"]`` when they exist, and move to ``device``: the
    card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("get_model: no CUDA device; pass device='cpu' to "
                           "build the model on the CPU")
    model = build_model(model_config)
    init_model(model, torch.Generator().manual_seed(seed))
    if (model_config.get("params", {}) or {}).get("pretrained"):
        logger.warning("pretrained=True but the zoo weights are not in the "
                       "repository; using the seeded init")
    ext_cfg = model_config["backbone"].get("ext_config") or {}
    for path in (ext_cfg.get("ckpt"), model_config.get("ckpt")):
        if ckpt_util.check_if_exists(path):
            payload = ckpt_util.load_ckpt(path)
            load_weights(model, payload["params"], payload.get("state"))
            logger.info("loaded checkpoint %s", path)
    return model.to(device)


def get_iou_types(model: RCNN) -> List[str]:
    """Eval IoU types per model kind (reference models/__init__.py:60-70)."""
    iou_types = ["bbox"]
    if model.kind == "mask_rcnn":
        iou_types.append("segm")
    elif model.kind == "keypoint_rcnn":
        iou_types.append("keypoints")
    return iou_types
