"""JAX-package weights <-> this package's ``state_dict``.

``state_dict_from_jax`` is the inverse of
hnd_ghnd_tpu/models/convert.py:convert_state_dict: it takes the JAX
package's (params, state) pytrees as numpy and returns the state_dict of
models/rcnn.RCNN.  ``jax_params_from_state_dict`` is the other direction
(the checkpoints' layout, utils/ckpt.py); the two are exact inverses on
every model kind the port builds, with a frozen BN's statistics folded into
its affine (``FrozenBatchNorm2d.folded``'s arithmetic, so the model's
output does not change).

  * conv kernels HWIO -> OIHW; linear weights [in, out] -> [out, in];
  * frozen BN {scale, bias} -> weight=scale, bias=bias, running_mean=0,
    running_var=1 (exact: FrozenBatchNorm2d uses eps=0, so it folds back to
    the same scale and bias);
  * bottleneck BN {gamma, beta} + state {mean, var} -> nn.BatchNorm2d fields
    at the reference's Sequential indices;
  * the ext filter (``layer1.ext_classifier.{conv,bn}{0,1,2}`` and
    ``.linear``) -> ``layer1.encoder.ext_classifier.extractor.{1,2,4,5,7,8}``
    and ``.linear``, its BNs as the bottleneck's;
  * a stock layer1 (the teacher's: ``layer1.0.conv1``,
    ``layer1.0.downsample.0``, ...) keeps its path, like layer2-4;
  * the mask head: ``mask_head.mask_fcnN`` keeps its path,
    ``mask_head.conv5_mask`` and ``mask_head.mask_fcn_logits`` go to
    ``roi_heads.mask_predictor``; the keypoint head: ``keypoint_head.{i}``
    goes to the Sequential index ``roi_heads.keypoint_head.{2i}`` and
    ``keypoint_head.kps_score_lowres`` to ``roi_heads.keypoint_predictor``;
  * transposed-conv kernels (``conv5_mask``, ``kps_score_lowres``) HWIO
    with I the input channels -> torch's [in, out, kh, kw]: the inverse of
    the JAX converter's (I, O, kh, kw) -> (kh, kw, I, O).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

# bottleneck param name -> the reference's Sequential index
_ENC_IDX = {"conv0": "0", "bn0": "1", "conv1": "2", "bn1": "3",
            "conv2": "5", "bn2": "6", "conv3": "7"}
_DEC_IDX = {"bn_in": "0", "conv0": "2", "bn0": "3", "conv1": "4", "bn1": "5",
            "conv2": "7", "bn2": "8", "conv3": "9", "bn3": "10"}
_LAYER1 = ("backbone", "body", "layer1")
_EXT_IDX = {"conv0": "1", "bn0": "2", "conv1": "4", "bn1": "5",
            "conv2": "7", "bn2": "8"}
_EXT = "ext_classifier"
_TRANSPOSED = ("conv5_mask", "kps_score_lowres")
_ENC_NAME = {v: k for k, v in _ENC_IDX.items()}
_DEC_NAME = {v: k for k, v in _DEC_IDX.items()}
_EXT_NAME = {v: k for k, v in _EXT_IDX.items()}


def _leaves(tree: Dict[str, Any], path=()) -> Iterator[Tuple[tuple, Dict]]:
    """Yield (path, node) for every dict whose values are arrays."""
    if all(not isinstance(v, dict) for v in tree.values()):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, path + (k,))


def _torch_prefix(path: tuple) -> str:
    if path[:4] == _LAYER1 + (_EXT,):
        inner = ("linear",) if path[4] == "linear" \
            else ("extractor", _EXT_IDX[path[4]])
        return ".".join(_LAYER1 + ("encoder", _EXT) + inner)
    if path[:3] == _LAYER1 and path[3] in ("encoder", "decoder"):
        part, name = path[3], path[4]
        idx = (_ENC_IDX if part == "encoder" else _DEC_IDX)[name]
        inner = "encoder.encoder" if part == "encoder" else "decoder"
        return ".".join(_LAYER1 + (inner, idx))
    if path[:2] == ("roi_heads", "mask_head") and path[2] in (
            "conv5_mask", "mask_fcn_logits"):
        return f"roi_heads.mask_predictor.{path[2]}"
    if path[:2] == ("roi_heads", "keypoint_head"):
        if path[2] == "kps_score_lowres":
            return "roi_heads.keypoint_predictor.kps_score_lowres"
        return f"roi_heads.keypoint_head.{2 * int(path[2])}"
    return ".".join(path)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def state_dict_from_jax(params: Dict[str, Any],
                        state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    for path, node in _leaves(params):
        prefix = _torch_prefix(path)
        if "w" in node:
            w = np.asarray(node["w"])
            if w.ndim != 4:
                w = w.T
            elif path[-1] in _TRANSPOSED:
                w = w.transpose(2, 3, 0, 1)
            else:
                w = w.transpose(3, 2, 0, 1)
            sd[f"{prefix}.weight"] = _t(w)
            if "b" in node:
                sd[f"{prefix}.bias"] = _t(node["b"])
        elif "scale" in node:
            sd[f"{prefix}.weight"] = _t(node["scale"])
            sd[f"{prefix}.bias"] = _t(node["bias"])
            sd[f"{prefix}.running_mean"] = torch.zeros(len(node["scale"]))
            sd[f"{prefix}.running_var"] = torch.ones(len(node["scale"]))
        elif "gamma" in node:
            stats = state
            for k in path:
                stats = stats[k]
            sd[f"{prefix}.weight"] = _t(node["gamma"])
            sd[f"{prefix}.bias"] = _t(node["beta"])
            sd[f"{prefix}.running_mean"] = _t(stats["mean"])
            sd[f"{prefix}.running_var"] = _t(stats["var"])
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            raise KeyError(f"unrecognised parameter group {'.'.join(path)}")
    return sd


def _jax_path(prefix: str) -> tuple:
    """The inverse of ``_torch_prefix``."""
    parts = tuple(prefix.split("."))
    if parts[:5] == _LAYER1 + ("encoder", _EXT):
        return _LAYER1 + (_EXT, "linear" if parts[5] == "linear"
                          else _EXT_NAME[parts[6]])
    if parts[:4] == _LAYER1 + ("encoder",):
        return _LAYER1 + ("encoder", _ENC_NAME[parts[5]])
    if parts[:4] == _LAYER1 + ("decoder",):
        return _LAYER1 + ("decoder", _DEC_NAME[parts[4]])
    if parts[:2] == ("roi_heads", "mask_predictor"):
        return ("roi_heads", "mask_head", parts[2])
    if parts[:2] == ("roi_heads", "keypoint_predictor"):
        return ("roi_heads", "keypoint_head", parts[2])
    if parts[:2] == ("roi_heads", "keypoint_head"):
        return ("roi_heads", "keypoint_head", str(int(parts[2]) // 2))
    return parts


def _put(tree: Dict[str, Any], path: tuple, node: Dict[str, np.ndarray]):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = node


def jax_params_from_state_dict(sd: Dict[str, torch.Tensor]):
    """A port ``state_dict`` -> the JAX package's (params, state) numpy
    trees: conv kernels OIHW -> HWIO (transposed convs [in, out, kh, kw] ->
    HWIO), linear weights transposed, a frozen BN folded to {scale, bias},
    a trainable BN (one with ``num_batches_tracked``) to {gamma, beta} and
    state {mean, var}."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, value in sd.items():
        prefix, leaf = key.rsplit(".", 1)
        groups.setdefault(prefix, {})[leaf] = value.detach().cpu()
    params: Dict[str, Any] = {}
    # the trunk's state subtree exists without trainable BNs too (JAX's
    # init gives the teacher {"backbone": {"body": {}}})
    state: Dict[str, Any] = {"backbone": {"body": {}}}

    def arr(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.float().numpy())

    for prefix, g in groups.items():
        path = _jax_path(prefix)
        if "num_batches_tracked" in g:
            _put(params, path, {"gamma": arr(g["weight"]),
                                "beta": arr(g["bias"])})
            _put(state, path, {"mean": arr(g["running_mean"]),
                               "var": arr(g["running_var"])})
        elif "running_var" in g:
            scale = g["weight"] * torch.rsqrt(g["running_var"])
            _put(params, path, {"scale": arr(scale),
                                "bias": arr(g["bias"]
                                            - g["running_mean"] * scale)})
        else:
            w = arr(g["weight"])
            if w.ndim != 4:
                w = w.T
            elif path[-1] in _TRANSPOSED:
                w = w.transpose(2, 3, 0, 1)
            else:
                w = w.transpose(2, 3, 1, 0)
            node = {"w": np.ascontiguousarray(w)}
            if "bias" in g:
                node["b"] = arr(g["bias"])
            _put(params, path, node)
    return params, state
