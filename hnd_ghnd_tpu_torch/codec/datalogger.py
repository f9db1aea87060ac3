"""DataLogger: the bottleneck payload sizes behind cost_analyzer's tables.

Counterpart of hnd_ghnd_tpu/codec/datalogger.py (reference
src/structure/transformer.py DataLogger :58-91, and the myutils
``get_binary_object_size`` convention, a pickled size in KB).  Per image
it records the pickled size of the bottleneck tensor in float32, float16
and quantized (the codes as a numpy array with Python floats for the scale
and zero point, from ``quantize_tensor`` on the CPU), and its (C, H, W).
It pickles numpy arrays and Python floats, never tensors, so the sizes are
the JAX package's.
"""
from __future__ import annotations

import pickle
from typing import List, Optional, Tuple

import numpy as np
import torch

from hnd_ghnd_tpu_torch.codec.quantizer import quantize_tensor


def binary_object_size_kb(obj) -> float:
    """Pickled size in KB (myutils file_util.get_binary_object_size)."""
    return len(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)) / 1024.0


class DataLogger:
    def __init__(self, num_bits: int = 8):
        self.num_bits4quant = num_bits
        self.data_size_list: List[float] = []
        self.fp16_data_size_list: List[float] = []
        self.quantized_data_size_list: List[float] = []
        self.tensor_shape_list: List[Tuple[int, int, int]] = []

    def clear(self) -> None:
        self.data_size_list.clear()
        self.fp16_data_size_list.clear()
        self.quantized_data_size_list.clear()
        self.tensor_shape_list.clear()

    def get_data(self):
        return (self.data_size_list.copy(), self.fp16_data_size_list.copy(),
                self.quantized_data_size_list.copy(),
                self.tensor_shape_list.copy())

    def __call__(self, z: Optional[np.ndarray], target=None):
        """z: [1, H, W, C] float32 bottleneck tensor, NHWC as on the wire
        (None: the ext filter stopped the image)."""
        if z is None:
            self.data_size_list.append(0.0)
            self.fp16_data_size_list.append(0.0)
            self.quantized_data_size_list.append(0.0)
            self.tensor_shape_list.append((0, 0, 0))
            return z, target
        z = np.asarray(z, dtype=np.float32)
        self.data_size_list.append(binary_object_size_kb(z))
        self.fp16_data_size_list.append(
            binary_object_size_kb(z.astype(np.float16)))
        q = quantize_tensor(torch.from_numpy(z), self.num_bits4quant)
        # read-only, as JAX's codes reach the host (and as np.frombuffer
        # reads them off a wire): numpy pickles a read-only array 4 bytes
        # shorter than a writable one
        codes = q.tensor.numpy()
        codes.flags.writeable = False
        self.quantized_data_size_list.append(binary_object_size_kb(
            (codes, float(q.scale), float(q.zero_point))))
        # (C, H, W) like the reference's shape log (transformer.py:89-90)
        self.tensor_shape_list.append((z.shape[-1], z.shape[1], z.shape[2]))
        return z, target
