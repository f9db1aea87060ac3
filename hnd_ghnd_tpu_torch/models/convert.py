"""JAX-package weights -> this package's ``state_dict``.

The inverse of hnd_ghnd_tpu/models/convert.py:convert_state_dict for the
serving model: it takes the JAX package's (params, state) pytrees as numpy
and returns the state_dict of models/rcnn.RCNN.

  * conv kernels HWIO -> OIHW; linear weights [in, out] -> [out, in];
  * frozen BN {scale, bias} -> weight=scale, bias=bias, running_mean=0,
    running_var=1 (exact: FrozenBatchNorm2d uses eps=0, so it folds back to
    the same scale and bias);
  * bottleneck BN {gamma, beta} + state {mean, var} -> nn.BatchNorm2d fields
    at the reference's Sequential indices.
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


def _leaves(tree: Dict[str, Any], path=()) -> Iterator[Tuple[tuple, Dict]]:
    """Yield (path, node) for every dict whose values are arrays."""
    if all(not isinstance(v, dict) for v in tree.values()):
        yield path, tree
        return
    for k, v in tree.items():
        yield from _leaves(v, path + (k,))


def _torch_prefix(path: tuple) -> str:
    if path[:3] == _LAYER1:
        part, name = path[3], path[4]
        idx = (_ENC_IDX if part == "encoder" else _DEC_IDX)[name]
        inner = "encoder.encoder" if part == "encoder" else "decoder"
        return ".".join(_LAYER1 + (inner, idx))
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
            sd[f"{prefix}.weight"] = _t(w.transpose(3, 2, 0, 1) if w.ndim == 4
                                        else w.T)
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
