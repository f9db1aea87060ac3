"""The RoIAlign kernels' channel-vector width, chosen on the host.

``roi_align_kernels.vector_width`` picks how many channels each thread of
the forward and backward kernels owns: the widest vector of 16, 8 or 4
bytes of the tables' type whose element count divides C and to which every
table pointer is aligned (else one element), with the outputs aligned to
the pieces they are written in.  The kernels themselves run only on the
card (tests/test_torch_port_cuda.py); here the choice, and that the
wrappers hand it to the C entry points, are checked on the CPU."""
import numpy as np
import pytest
import torch

from chip_smoke import box_mix
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
from hnd_ghnd_tpu_torch.ops.roi_align import assign_levels

ALIGNED = 1 << 20  # an address aligned to every width


@pytest.mark.parametrize("c,itemsize,out_itemsize,want", [
    (256, 4, 4, 4),    # f32, C=256: 16 bytes
    (256, 2, 2, 8),    # bf16: 16 bytes
    (256, 1, 4, 16),   # int8 tables, f32 out: 16 bytes
    (40, 4, 4, 4),
    (40, 2, 2, 8),
    (40, 1, 4, 8),     # 40 int8 channels: the 8-byte path
    (12, 1, 4, 4),     # the 4-byte path
    (6, 2, 2, 2),
    (2, 4, 4, 2),
    (3, 4, 4, 1),      # C=3: one element
    (3, 2, 2, 1),
    (3, 1, 4, 1),
])
def test_width_from_channels_and_type(c, itemsize, out_itemsize, want):
    got = RK.vector_width(c, itemsize, [ALIGNED] * 4, out_itemsize, [ALIGNED])
    assert got == want
    assert c % got == 0


@pytest.mark.parametrize("itemsize,out_itemsize,offset,want", [
    (4, 4, 4, 1),      # f32 level one element off: scalar
    (4, 4, 8, 2),
    (2, 2, 2, 1),      # bf16 one element off
    (2, 2, 4, 2),
    (2, 2, 8, 4),
    (1, 4, 1, 1),      # int8 one element off
    (1, 4, 4, 4),
    (1, 4, 8, 8),
])
def test_level_pointer_offset_drops_width(itemsize, out_itemsize, offset,
                                          want):
    addresses = [ALIGNED, ALIGNED + offset, ALIGNED, ALIGNED]
    assert RK.vector_width(256, itemsize, addresses, out_itemsize,
                           [ALIGNED]) == want


@pytest.mark.parametrize("itemsize,out_itemsize,offset,want", [
    (1, 4, 4, 1),      # int8 tables: 16 f32 outputs go out in float4s
    (1, 4, 16, 16),
    (4, 4, 8, 2),      # f32 out written as float2
    (2, 2, 8, 4),      # bf16 out: 4 channels are one 8-byte store
    (2, 4, 8, 2),      # bf16 cotangent, f32 float2 atomics
])
def test_output_pointer_offset_drops_width(itemsize, out_itemsize, offset,
                                           want):
    assert RK.vector_width(256, itemsize, [ALIGNED] * 4, out_itemsize,
                           [ALIGNED + offset]) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_width_of_tensor_views(dtype):
    base = torch.zeros(4 * 256 + 16, dtype=dtype)
    size = base.element_size()
    whole = base[:4 * 256].view(4, 256)
    off = base[1:1 + 4 * 256].view(4, 256)
    assert RK.vector_width(256, size, [whole.data_ptr()], 4,
                           [ALIGNED]) == 16 // size
    assert RK.vector_width(256, size, [off.data_ptr()], 4, [ALIGNED]) == 1


class _Lib:
    """Records the arguments of the C entry points instead of launching."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


@pytest.fixture
def recorded(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(RK._build, "load", lambda: lib)
    monkeypatch.setattr(RK, "_stream", lambda device: 0)
    return lib


def _inputs(c, dtype, offset):
    rng = np.random.RandomState(3)
    feats = []
    for s in (4, 8, 16, 32):
        f = torch.zeros(2 * (64 // s) * (128 // s) * c + offset, dtype=dtype)
        feats.append(f[offset:].view(2, 64 // s, 128 // s, c))
    boxes = torch.from_numpy(box_mix(rng, 2, 5, 64, 128))
    level = assign_levels(boxes.reshape(-1, 4)).contiguous()
    return feats, boxes, level


@pytest.mark.parametrize("c,dtype,offset,want", [
    (256, torch.float32, 0, 4), (40, torch.int8, 0, 8),
    (3, torch.bfloat16, 0, 1), (256, torch.bfloat16, 1, 1)])
def test_forward_hands_the_width_to_the_kernel(recorded, c, dtype, offset,
                                               want):
    feats, boxes, level = _inputs(c, dtype, offset)
    scale = torch.ones(4) if dtype == torch.int8 else None
    out = RK._forward(feats, boxes, level, None, (64, 128), 7, 2, scale)
    args = recorded.calls["hnd_roi_align_fwd"]
    assert args[-2] == want and args[-3] == RK._DTYPE_CODES[dtype]
    assert args[7] == out.data_ptr() and args[10] == c


@pytest.mark.parametrize("c,itemsize,offset,want", [
    (256, 4, 0, 4), (256, 2, 0, 4),   # one float4 atomic per thread and tap
    (40, 2, 0, 4), (6, 2, 0, 2), (3, 4, 0, 1),
    (256, 2, 2, 1), (256, 2, 4, 2), (256, 4, 8, 2)])
def test_backward_width_is_one_float4_at_most(c, itemsize, offset, want):
    assert RK.backward_width(c, itemsize, ALIGNED + offset,
                             [ALIGNED] * 4) == want


@pytest.mark.parametrize("c,dtype,want", [
    (256, torch.float32, 4), (256, torch.bfloat16, 4), (3, torch.float32, 1)])
def test_backward_hands_the_width_to_the_kernel(recorded, c, dtype, want):
    feats, boxes, level = _inputs(c, dtype, 0)
    cot = torch.zeros(2, 5, 7, 7, c, dtype=dtype)
    shapes = [tuple(f.shape[1:3]) for f in feats]
    RK.roi_align_backward(cot, shapes, dtype, boxes, level, None, (64, 128),
                          2)
    args = recorded.calls["hnd_roi_align_bwd"]
    assert args[-2] == want and args[-3] == int(dtype == torch.bfloat16)
    assert args[6] == cot.data_ptr() and args[9] == c
