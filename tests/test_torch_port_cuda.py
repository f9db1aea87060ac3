"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither jax nor the JAX package, so it runs on the GPU host,
where tests/conftest.py (which imports jax) cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import box_mix as _boxes
from chip_smoke import quant_input as _x
from hnd_ghnd_tpu_torch.codec import quantizer as tq
from hnd_ghnd_tpu_torch.ops import quant_kernels as QK
from hnd_ghnd_tpu_torch.ops import roi_align as tra
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK

pytestmark = pytest.mark.cuda

ROI_TOL = 1e-5  # x max |plain|: the kernel repeats the plain arithmetic


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(8, 212, 340, 3), (1, 101, 77, 5),
                                   (3, 7, 11, 3)])
def test_quant_kernels_bit_exact_vs_cpu_formula(cuda, shape):
    x = torch.from_numpy(_x(7, shape)).to(cuda)
    n_q, n_d = QK.quantize.launches, QK.dequantize.launches
    got = QK.quantize(x, 8)
    for want in (tq.quantize_tensor(x.cpu(), 8), tq.quantize_tensor(x, 8)):
        assert torch.equal(got.tensor.cpu(), want.tensor.cpu())
        assert torch.equal(got.scale.cpu(), want.scale.cpu())
        assert torch.equal(got.zero_point.cpu(), want.zero_point.cpu())
    assert torch.equal(QK.dequantize(got).cpu(),
                       tq.dequantize_tensor(tq.quantize_tensor(x.cpu(), 8)))
    assert (QK.quantize.launches, QK.dequantize.launches) == (n_q + 1, n_d + 1)


def test_quant_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        QK.quantize(torch.zeros(8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        QK.quantize(torch.zeros(4, 4, device=cuda)[:, ::2])
    with pytest.raises(ValueError):
        QK.quantize(torch.zeros(8, device=cuda), num_bits=16)


@pytest.mark.parametrize("c,pool", [(256, 7), (40, 7), (256, 14)])
def test_roi_align_kernel_vs_plain(cuda, c, pool):
    rng = np.random.RandomState(14)
    b, n, h, w = 2, 200, 256, 512
    feats = [torch.from_numpy(rng.randn(b, h // s, w // s, c)
                              .astype(np.float32)).to(cuda)
             for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(_boxes(rng, b, n, h, w)).to(cuda)
    valid = torch.from_numpy(rng.rand(b, n) > 0.3).to(cuda)
    launches = RK.roi_align.launches
    got = RK.roi_align(feats, boxes, (h, w), pool, 2, valid)
    assert RK.roi_align.launches == launches + 1
    want = tra.multiscale_roi_align_batch(feats, boxes, (h, w), pool, 2, valid)
    err = float((got - want).abs().max())
    assert err <= ROI_TOL * float(want.abs().max())


def test_roi_align_kernel_rejects_what_it_does_not_take(cuda):
    boxes = torch.zeros(1, 2, 4, device=cuda)
    sizes = (8, 4, 2, 1)
    bf16 = [torch.zeros(1, s, s, 16, device=cuda, dtype=torch.bfloat16)
            for s in sizes]
    with pytest.raises(TypeError):
        RK.roi_align(bf16, boxes, (32, 32), 7)
    strided = [torch.zeros(1, 16, s, s, device=cuda).permute(0, 2, 3, 1)
               for s in sizes]
    with pytest.raises(ValueError):
        RK.roi_align(strided, boxes, (32, 32), 7)
    three = [torch.zeros(1, s, s, 16, device=cuda) for s in sizes[:3]]
    with pytest.raises(ValueError):
        RK.roi_align(three, boxes, (32, 32), 7)
