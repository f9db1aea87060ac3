"""The port's bottleneck quantizer against the JAX package's.

Codes, scale and zero point are held bit-exact against JAX
``quantize_tensor`` (the CPU formula) and ``pallas_quantize`` in interpret
mode; dequantize exactly.  The CUDA kernels are held against the plain
version on the card in tests/test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import quant_input as _x
from hnd_ghnd_tpu.codec import quantizer as jq
from hnd_ghnd_tpu.ops.pallas_quant import pallas_dequantize, pallas_quantize
from hnd_ghnd_tpu_torch.codec import quantizer as tq
from hnd_ghnd_tpu_torch.ops import quant_kernels as QK

# NHWC bottleneck-like shapes; the second and third are no multiple of 4
SHAPES = [(2, 36, 52, 3), (1, 101, 77, 5), (3, 7, 11, 3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES)
def test_codes_bit_exact_vs_jax(seed, shape):
    x = _x(seed, shape)
    want = jq.quantize_tensor(jnp.asarray(x), 8)
    got = tq.quantize_tensor(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
    assert got.scale.item() == float(want.scale)
    assert got.zero_point.item() == float(want.zero_point)
    np.testing.assert_array_equal(tq.dequantize_tensor(got).numpy(),
                                  np.asarray(jq.dequantize_tensor(want)))


@pytest.mark.parametrize("seed", [3, 4])
def test_codes_bit_exact_vs_pallas_interpret(seed):
    x = _x(seed, SHAPES[0])
    want = pallas_quantize(jnp.asarray(x), 8, interpret=True)
    got = tq.quantize_tensor(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
    assert got.zero_point.item() == float(want.zero_point)
    # pallas_quantize returns a scale computed under jit, where XLA turns
    # `/ 255` into a reciprocal multiply: at most one ulp from the formula
    # its own kernel (and the port) uses for the codes
    assert abs(np.float32(got.scale.item()) - np.float32(want.scale)) <= \
        np.spacing(np.float32(want.scale))
    # dequantize is exact on the same (codes, scale, zero point)
    same = tq.QuantizedTensor(torch.from_numpy(np.array(want.tensor)),
                              torch.tensor(float(want.scale)),
                              torch.tensor(float(want.zero_point)))
    np.testing.assert_array_equal(
        tq.dequantize_tensor(same).numpy(),
        np.asarray(pallas_dequantize(want, interpret=True)))


# more than one of the Pallas kernel's 512 Ki-float chunks, with a ragged
# last chunk that the kernel pads with the last element
@pytest.mark.parametrize("shape", [(4, 212, 340, 3), (1, 524289)],
                         ids=["b4_bottleneck", "one_chunk_plus_1"])
def test_codes_bit_exact_vs_pallas_interpret_multi_chunk(shape):
    x = _x(7, shape)
    assert x.size > 512 * 1024 and x.size % (512 * 1024) != 0
    want = pallas_quantize(jnp.asarray(x), 8, interpret=True)
    got = tq.quantize_tensor(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
    assert got.zero_point.item() == float(want.zero_point)
    # the jitted scale: at most one ulp from the IEEE quotient (see above)
    assert abs(np.float32(got.scale.item()) - np.float32(want.scale)) <= \
        np.spacing(np.float32(want.scale))


def test_constant_tensor_guard():
    x = np.full((1, 4, 4, 3), 1.25, np.float32)
    want = jq.quantize_tensor(jnp.asarray(x), 8)
    got = tq.quantize_tensor(torch.from_numpy(x), 8)
    assert got.scale.item() == float(want.scale) == 1.0
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))


def test_roundtrip_on_cpu_uses_plain_version():
    x = _x(5, SHAPES[1])
    before = (QK.quantize.launches, QK.dequantize.launches)
    got = tq.roundtrip(torch.from_numpy(x), 8)
    assert (QK.quantize.launches, QK.dequantize.launches) == before
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.roundtrip(jnp.asarray(x), 8)))


def test_channels_last_view_quantizes_like_nhwc():
    x = torch.from_numpy(_x(6, SHAPES[0])).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    got = QK.quantize(x, 8)
    want = tq.quantize_tensor(x.contiguous(), 8)
    assert torch.equal(got.tensor, want.tensor)
