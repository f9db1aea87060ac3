"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips without one.
The file imports neither jax nor the JAX package, so it runs on the GPU host,
where tests/conftest.py (which imports jax) cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import (BUCKETS, EVAL_BATCH, INT8_CONV_ODD,
                        INT8_EPILOGUE_CASES, int8_epilogue,
                        int8_outputs_equal, int8_trunk_convs, nms_problem)
from chip_smoke import box_mix as _boxes
from chip_smoke import quant_input as _x
from hnd_ghnd_tpu_torch.codec import quantizer as tq
from hnd_ghnd_tpu_torch.ops import nms as NMS
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


def _quantize_like_cpu(x, bits=8):
    """Quantize on the card: codes, scale and zero point bit-exact with the
    CPU formula (and its run on the card), dequantize exact."""
    got = QK.quantize(x, bits)
    want_cpu = tq.quantize_tensor(x.cpu(), bits)
    for want in (want_cpu, tq.quantize_tensor(x, bits)):
        assert torch.equal(got.tensor.cpu(), want.tensor.cpu())
        assert torch.equal(got.scale.cpu(), want.scale.cpu())
        assert torch.equal(got.zero_point.cpu(), want.zero_point.cpu())
    # an infinite scale dequantizes 0 codes to NaN on both sides
    assert torch.allclose(QK.dequantize(got).cpu(),
                          tq.dequantize_tensor(want_cpu), rtol=0.0, atol=0.0,
                          equal_nan=True)
    return got


# past the grid's registers at batch 32 (27.7 MB), the 1344x832 bucket's
# bottleneck, and sizes under one block, with and without a scalar tail
@pytest.mark.parametrize("shape", [(32, 212, 340, 3), (8, 340, 212, 3), (1,),
                                   (5,), (4099,)])
def test_quant_kernels_shapes_vs_cpu_formula(cuda, shape):
    _quantize_like_cpu(torch.from_numpy(_x(8, shape)).to(cuda))


def test_quant_kernels_at_storage_offset_1(cuda):
    """A dense view whose data is 4 bytes past a 16-byte boundary takes the
    scalar path, for the codes and for dequantize's loads."""
    shape = (8, 212, 340, 3)
    n = int(np.prod(shape))
    base = torch.empty(n + 1, device=cuda)
    x = base[1:].view(shape)
    x.copy_(torch.from_numpy(_x(9, shape)))
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    got = _quantize_like_cpu(x)
    codes = torch.empty(n + 1, dtype=torch.uint8, device=cuda)[1:].view(shape)
    codes.copy_(got.tensor)
    odd = tq.QuantizedTensor(codes, got.scale, got.zero_point)
    assert torch.equal(QK.dequantize(odd).cpu(),
                       tq.dequantize_tensor(got).cpu())


@pytest.mark.parametrize("bits", [1, 4, 7])
@pytest.mark.parametrize("shape", [(8, 212, 340, 3), (3, 101, 77, 5)])
def test_quant_kernels_num_bits_vs_cpu_formula(cuda, shape, bits):
    _quantize_like_cpu(torch.from_numpy(_x(10, shape)).to(cuda), bits)


def test_quant_kernels_constant_tensor(cuda):
    got = _quantize_like_cpu(torch.full((8, 212, 340, 3), -1.25, device=cuda))
    assert got.scale.item() == 1.0


@pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "nan+-inf"])
def test_quant_kernels_non_finite_past_the_registers(cuda, case):
    """At batch 32 the last elements are read after the grid's registers are
    full; a NaN or an infinity there still reaches the scale."""
    values = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
              "nan+-inf": [np.nan, np.inf, -np.inf]}[case]
    x = _x(11, (32, 212, 340, 3))
    x.reshape(-1)[-len(values):] = values
    _quantize_like_cpu(torch.from_numpy(x).to(cuda))


def test_quantize_is_one_kernel_per_call(cuda):
    """torch.profiler sees one CUDA kernel per quantize call, and no copy or
    memset."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(_x(12, (8, 212, 340, 3))).to(cuda)
    QK.quantize(x, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            QK.quantize(x, 8)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 3, device
    assert all("quantize_kernel" in name for name in device), device


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
    before = RK.roi_align.launches.copy()
    got = RK.roi_align(feats, boxes, (h, w), pool, 2, valid)
    before[(torch.float32, pool)] += 1
    assert RK.roi_align.launches == before
    want = tra.multiscale_roi_align_batch(feats, boxes, (h, w), pool, 2, valid)
    err = float((got - want).abs().max())
    assert err <= ROI_TOL * float(want.abs().max())


def _int8_inputs(cuda, c, seed, nchw):
    """Float32 P2-P5 of a 256x512 bucket, as contiguous NHWC or as the NHWC
    views of contiguous NCHW maps, the last image's lower half zero."""
    rng = np.random.RandomState(seed)
    out = []
    for s in (4, 8, 16, 32):
        f = rng.randn(2, 256 // s, 512 // s, c).astype(np.float32) * s
        f[1, 128 // s:] = 0.0
        t = torch.from_numpy(f).to(cuda)
        out.append(t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                   if nchw else t)
    return out


@pytest.mark.parametrize("c,nchw", [(256, True), (256, False), (40, True),
                                    (3, False)])
def test_quantize_levels_kernel_bit_exact(cuda, c, nchw):
    levels = _int8_inputs(cuda, c, 17, nchw)
    n = RK.quantize_levels.launches
    codes, scales = RK.quantize_levels(levels)
    assert RK.quantize_levels.launches == n + 1
    for want_q, want_s in (tra.quantize_fpn_levels(levels),
                           tra.quantize_fpn_levels([f.cpu() for f in levels])):
        assert torch.equal(scales.cpu(), want_s.cpu())
        for q, w in zip(codes, want_q):
            assert q.dtype == torch.int8 and q.is_contiguous()
            assert torch.equal(q.cpu(), w.cpu())


def test_quantize_levels_kernel_zero_level(cuda):
    levels = _int8_inputs(cuda, 16, 18, True)
    levels[3] = torch.zeros_like(levels[3])
    codes, scales = RK.quantize_levels(levels)
    assert float(scales[3]) == 1.0 and int(codes[3].abs().max()) == 0


def _levels(cuda, b, c, shapes, seed, nchw, specials=None):
    """Float32 levels [b, h, w, c] of the given (h, w), as contiguous NHWC
    or as NHWC views of contiguous NCHW maps; ``specials[l]`` values go to
    seeded places of level l."""
    rng = np.random.RandomState(seed)
    out = []
    for i, (h, w) in enumerate(shapes):
        f = (rng.randn(b, h, w, c) * (1 + i)).astype(np.float32)
        values = (specials or {}).get(i, [])
        f.reshape(-1)[rng.choice(f.size, len(values), replace=False)] = values
        t = torch.from_numpy(f).to(cuda)
        out.append(t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                   if nchw else t)
    return out


def _assert_levels_like_plain(levels):
    """The kernel's codes and scales equal the plain version's on the card
    and on the CPU, and a second call gives the same bits."""
    codes, scales = RK.quantize_levels(levels)
    for want_q, want_s in (tra.quantize_fpn_levels(levels),
                           tra.quantize_fpn_levels([f.cpu() for f in levels])):
        assert torch.equal(scales.cpu(), want_s.cpu())
        for q, w in zip(codes, want_q):
            assert q.dtype == torch.int8 and q.is_contiguous()
            assert torch.equal(q.cpu(), w.cpu())
    again_q, again_s = RK.quantize_levels(levels)
    assert torch.equal(again_s, scales)
    assert all(torch.equal(a, q) for a, q in zip(again_q, codes))
    return codes, scales


# (b, c, P2-P5 shapes): levels of 13 x 21 pixels and smaller, none a
# multiple of 4, with C = 40; batch 1 of a 256x384 bucket; and C = 512
# (two channel groups)
LEVEL_SHAPES = {
    "ragged": (2, 40, [(13, 21), (7, 11), (5, 7), (3, 3)]),
    "batch1": (1, 256, [(64, 96), (32, 48), (16, 24), (8, 12)]),
    "c512": (2, 512, [(32, 48), (16, 24), (8, 12), (4, 6)]),
}


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("shape", list(LEVEL_SHAPES))
def test_quantize_levels_kernel_shapes_vs_plain(cuda, shape, nchw):
    b, c, shapes = LEVEL_SHAPES[shape]
    levels = _levels(cuda, b, c, shapes, 21, nchw)
    n = RK.quantize_levels.launches
    _assert_levels_like_plain(levels)
    assert RK.quantize_levels.launches == n + 2


@pytest.mark.parametrize("nchw", [True, False], ids=["nchw", "nhwc"])
def test_quantize_levels_kernel_non_finite_vs_plain(cuda, nchw):
    """P2 holds a NaN (scale 1, its code 0), P3 a +inf and P4 a -inf
    (scale inf, every code 0), P5 all three (scale 1, +-127 and 0)."""
    specials = {0: [np.nan], 1: [np.inf], 2: [-np.inf],
                3: [np.nan, np.inf, -np.inf]}
    levels = _levels(cuda, 2, 64, [(16, 24), (8, 12), (4, 6), (2, 3)], 22,
                     nchw, specials)
    _, scales = _assert_levels_like_plain(levels)
    assert scales.tolist() == [1.0, float("inf"), float("inf"), 1.0]


@pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "nan+-inf"])
def test_quant_kernels_non_finite_vs_cpu_formula(cuda, case):
    values = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
              "nan+-inf": [np.nan, np.inf, -np.inf]}[case]
    x = _x(23, (2, 37, 53, 3))
    x.reshape(-1)[[5, 1000, 7000][:len(values)]] = values
    x = torch.from_numpy(x).to(cuda)
    got = QK.quantize(x, 8)
    for want in (tq.quantize_tensor(x.cpu(), 8), tq.quantize_tensor(x, 8)):
        assert torch.equal(got.tensor.cpu(), want.tensor.cpu())
        assert torch.equal(got.scale.cpu(), want.scale.cpu())
        assert torch.equal(got.zero_point.cpu(), want.zero_point.cpu())
    # an infinite scale dequantizes 0 codes to NaN on both sides
    assert torch.allclose(QK.dequantize(got).cpu(),
                          tq.dequantize_tensor(tq.quantize_tensor(x.cpu(), 8)),
                          rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("c,pool", [(256, 7), (40, 7), (256, 14)])
def test_roi_align_int8_kernel_vs_plain(cuda, c, pool):
    feats = _int8_inputs(cuda, c, 19, True)
    rng = np.random.RandomState(19)
    boxes = torch.from_numpy(_boxes(rng, 2, 150, 256, 512)).to(cuda)
    valid = torch.from_numpy(rng.rand(2, 150) > 0.3).to(cuda)
    tables = tra.quantize_fpn_levels(feats)
    before = RK.roi_align.launches.copy()
    got = RK.roi_align(feats, boxes, (256, 512), pool, 2, valid, quant=tables)
    before[(torch.int8, pool)] += 1
    assert RK.roi_align.launches == before
    want = tra.multiscale_roi_align_batch(feats, boxes, (256, 512), pool, 2,
                                          valid, quant=tables)
    assert got.dtype == want.dtype == torch.float32
    # the plain float32 program, the same operations in the same order
    assert torch.equal(got, want)


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    feats = _int8_inputs(cuda, 8, 20, False)
    boxes = torch.zeros(2, 3, 4, device=cuda)
    codes, scales = RK.quantize_levels(feats)
    with pytest.raises(TypeError):      # int8 levels without their scales
        RK.roi_align(codes, boxes, (256, 512), 7)
    with pytest.raises(TypeError):      # scales with float levels
        RK.roi_align(feats, boxes, (256, 512), 7, quant=(feats, scales))
    with pytest.raises(TypeError):      # int8 tables for bf16 levels
        RK.roi_align([f.bfloat16() for f in feats], boxes, (256, 512), 7,
                     quant=(codes, scales))
    with pytest.raises(ValueError):
        RK.roi_align(feats, boxes, (256, 512), 7, quant=(codes, scales[:3]))
    with pytest.raises(TypeError):
        RK.quantize_levels([f.double() for f in feats])
    mixed = [feats[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)]
    with pytest.raises(ValueError):
        RK.quantize_levels(mixed + feats[1:])
    with pytest.raises(ValueError):
        RK.quantize_levels(feats[:3])


def _bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _train_inputs(cuda, dtype, c, seed):
    rng = np.random.RandomState(seed)
    b, n, h, w = 2, 120, 256, 512
    feats = [torch.from_numpy(rng.randn(b, h // s, w // s, c)
                              .astype(np.float32)).to(cuda, dtype)
             for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(_boxes(rng, b, n, h, w)).to(cuda)
    valid = torch.from_numpy(rng.rand(b, n) > 0.2).to(cuda)
    cot = torch.from_numpy(rng.randn(b, n, 7, 7, c).astype(np.float32)
                           ).to(cuda, dtype)
    return feats, boxes, valid, cot, (h, w)


@pytest.mark.parametrize("c,pool", [(256, 7), (40, 7), (256, 14)])
def test_roi_align_bf16_kernel_vs_plain(cuda, c, pool):
    feats, boxes, valid, _, size = _train_inputs(cuda, torch.bfloat16, c, 15)
    before = RK.roi_align.launches.copy()
    got = RK.roi_align(feats, boxes, size, pool, 2, valid)
    before[(torch.bfloat16, pool)] += 1
    assert RK.roi_align.launches == before
    want = tra.multiscale_roi_align_batch(feats, boxes, size, pool, 2, valid)
    assert got.dtype == want.dtype == torch.bfloat16
    # the plain float32 program rounded once, as the kernel rounds
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_roi_align_backward_kernel_vs_plain_autograd(cuda, dtype):
    feats, boxes, valid, cot, size = _train_inputs(cuda, dtype, 256, 16)
    ref = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(tra.multiscale_roi_align_batch(
        ref, boxes, size, 7, 2, valid), ref, cot)
    got_in = [f.clone().requires_grad_(True) for f in feats]
    fwd, bwd = (RK.roi_align.launches.copy(),
                RK.roi_align_backward.launches.copy())
    out = RK.roi_align_train(got_in, boxes, size, 7, 2, valid)
    got = torch.autograd.grad(out, got_in, cot)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    fwd[(dtype, 7)] += 1
    bwd[(dtype, 7)] += 1
    assert (RK.roi_align.launches, RK.roi_align_backward.launches) == (fwd,
                                                                        bwd)
    top = max(float(g.float().abs().max()) for g in want)
    # atomics add in another order: f32 within 1e-5 of the largest
    # gradient, bf16 within one bf16 ulp of it
    tol = ROI_TOL * top if f32 else _bf16_ulp(top)
    for g, r in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - r.float()).abs().max()) <= tol


def _mask_train_inputs(cuda, dtype, seed):
    """The mask and keypoint losses' pooling in training: 2 x 128 RoIs
    (positives first, then unsampled slots weighted 0; image 1 has no
    positive) over P2-P5 of one batch-2 832x1344 bucket, 14x14 bins, C=256,
    and a cotangent."""
    rng = np.random.RandomState(seed)
    b, n, h, w = 2, 128, 832, 1344
    gen = torch.Generator(device=cuda).manual_seed(seed)
    feats = [torch.randn((b, h // s, w // s, 256), generator=gen,
                         device=cuda).to(dtype) for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(_boxes(rng, b, n, h, w)).to(cuda)
    valid = np.zeros((b, n), bool)
    valid[0, :40] = True
    valid = torch.from_numpy(valid).to(cuda)
    cot = torch.randn((b, n, 14, 14, 256), generator=gen,
                      device=cuda).to(dtype)
    return feats, boxes, valid, cot, (h, w)


def test_roi_align_bf16_p14_train_shape_bit_identical(cuda):
    feats, boxes, valid, _, size = _mask_train_inputs(cuda, torch.bfloat16,
                                                      30)
    n = RK.roi_align.launches[(torch.bfloat16, 14)]
    got = RK.roi_align(feats, boxes, size, 14, 2, valid)
    assert RK.roi_align.launches[(torch.bfloat16, 14)] == n + 1
    want = tra.multiscale_roi_align_batch(feats, boxes, size, 14, 2, valid)
    assert got.shape == (2, 128, 14, 14, 256)
    assert torch.equal(got, want)
    assert not bool(got[1].any())  # no positive: every slot pools zeros


@pytest.mark.parametrize("finite", [True, False],
                         ids=["finite", "non_finite"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_roi_align_backward_p14_train_shape_vs_plain_autograd(cuda, dtype,
                                                              finite):
    """Through ``roi_align_train``'s autograd, against the plain autograd,
    within the 7x7 tests' bounds; the non-finite case puts +inf on RoI 0,
    NaN on RoI 1 and -inf on one channel of RoI 2 of image 0 (the C9 rule:
    NaN and +-inf land where the plain autograd puts them), and NaN on a
    slot of image 1, which is weighted 0 and adds NaN through its +0 taps
    as the plain autograd's 0 * NaN does."""
    feats, boxes, valid, cot, size = _mask_train_inputs(cuda, dtype, 31)
    if not finite:
        cot[0, 0] = float("inf")
        cot[0, 1] = float("nan")
        cot[0, 2, :, :, 3] = float("-inf")
        cot[1, 5] = float("nan")
    ref = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(tra.multiscale_roi_align_batch(
        ref, boxes, size, 14, 2, valid), ref, cot)
    got_in = [f.clone().requires_grad_(True) for f in feats]
    n = RK.roi_align_backward.launches[(dtype, 14)]
    out = RK.roi_align_train(got_in, boxes, size, 14, 2, valid)
    got = torch.autograd.grad(out, got_in, cot)
    torch.cuda.synchronize()
    assert RK.roi_align_backward.launches[(dtype, 14)] == n + 1
    finite_ref = [r[torch.isfinite(r)].float() for r in want]
    top = max(float(r.abs().max()) for r in finite_ref if r.numel())
    tol = ROI_TOL * top if dtype == torch.float32 else _bf16_ulp(top)
    if not finite:
        assert any(bool(torch.isnan(r).any()) for r in want)
    for g, r in zip(got, want):
        assert g.dtype == dtype
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert torch.equal(torch.isinf(g), torch.isinf(r))
        assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
        ok = torch.isfinite(r)
        if bool(ok.any()):
            assert float((g[ok].float() - r[ok].float()).abs().max()) <= tol


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _edge_boxes(rng, b, n, h, w):
    """The box mix with, in every image, RoIs fully off the image (both
    sides), sub-pixel RoIs whose samples all fall in one cell of P2, and
    the last 16 RoIs on one spot (the backward's atomics all hit the same
    cells)."""
    boxes = _boxes(rng, b, n, h, w)
    boxes[:, 0] = (w + 60, h + 60, w + 140, h + 120)
    boxes[:, 1] = (-300, -260, -200, -230)
    boxes[:, 2] = (8.0, 12.0, 8.1, 12.05)     # P2 (x, y) = (2.0, 3.0)
    boxes[:, 3] = (40.0, 20.0, 40.5, 20.5)
    boxes[:, -16:] = (30.0, 30.0, 90.0, 70.0)
    return boxes


# (dtype, C, misaligned levels and cotangent, channels per thread)
WIDTH_CASES = [
    (torch.float32, 256, False, 4), (torch.float32, 40, False, 4),
    (torch.float32, 3, False, 1), (torch.float32, 256, True, 1),
    (torch.bfloat16, 256, False, 8), (torch.bfloat16, 40, False, 8),
    (torch.bfloat16, 3, False, 1), (torch.bfloat16, 256, True, 1),
    (torch.int8, 256, False, 16), (torch.int8, 40, False, 8),
    (torch.int8, 3, False, 1), (torch.int8, 256, True, 1),
]


def _width_inputs(cuda, dtype, c, misaligned, seed):
    rng = np.random.RandomState(seed)
    b, n, h, w = 2, 96, 256, 512
    f32 = [torch.from_numpy(rng.randn(b, h // s, w // s, c)
                            .astype(np.float32) * s).to(cuda)
           for s in (4, 8, 16, 32)]
    boxes = torch.from_numpy(_edge_boxes(rng, b, n, h, w)).to(cuda)
    valid = rng.rand(b, n) > 0.3
    valid[:, 1] = False
    valid = torch.from_numpy(valid).to(cuda)
    if dtype == torch.int8:
        feats, scales = tra.quantize_fpn_levels(f32)
    else:
        feats, scales = [f.to(dtype) for f in f32], None
    if misaligned:
        feats = [_misaligned(f) for f in feats]
    return feats, scales, boxes, valid, (h, w)


@pytest.mark.parametrize("dtype,c,misaligned,vec", WIDTH_CASES)
@pytest.mark.parametrize("pool", [7, 14])
def test_roi_align_kernel_widths_vs_plain(cuda, dtype, c, misaligned, vec,
                                          pool):
    feats, scales, boxes, valid, size = _width_inputs(cuda, dtype, c,
                                                      misaligned, 21)
    out_size = 4 if dtype == torch.int8 else feats[0].element_size()
    assert RK.vector_width(c, feats[0].element_size(),
                           [f.data_ptr() for f in feats], out_size,
                           [1 << 20]) == vec
    quant = None if scales is None else (feats, scales)
    plain_in = [f.float() for f in feats] if quant else feats
    got = (RK.roi_align(plain_in, boxes, size, pool, 2, valid, quant=quant)
           if quant else RK.roi_align(feats, boxes, size, pool, 2, valid))
    want = tra.multiscale_roi_align_batch(plain_in, boxes, size, pool, 2,
                                          valid, quant=quant)
    assert got.dtype == want.dtype
    # off-image and invalid RoIs pool to zero
    assert float(got[:, :2].float().abs().max()) == 0.0
    if dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= ROI_TOL * float(want.abs().max())
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,c,misaligned,vec",
                         [case for case in WIDTH_CASES
                          if case[0] != torch.int8])
def test_roi_align_backward_widths_vs_plain_autograd(cuda, dtype, c,
                                                     misaligned, vec):
    feats, _, boxes, valid, size = _width_inputs(cuda, dtype, c, misaligned,
                                                 22)
    rng = np.random.RandomState(23)
    cot = torch.from_numpy(rng.randn(2, 96, 7, 7, c).astype(np.float32)
                           ).to(cuda, dtype)
    if misaligned:
        cot = _misaligned(cot)
    assert RK.backward_width(c, cot.element_size(), cot.data_ptr(),
                             [1 << 20]) == min(vec, RK.ATOMIC_FLOATS)
    ref = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(tra.multiscale_roi_align_batch(
        ref, boxes, size, 7, 2, valid), ref, cot)
    boxes_c, level, weight = RK.checked_inputs(feats, boxes, valid)
    got = RK.roi_align_backward(cot, [tuple(f.shape[1:3]) for f in feats],
                                dtype, boxes_c, level, weight, size, 2)
    torch.cuda.synchronize()
    top = max(float(g.float().abs().max()) for g in want)
    tol = ROI_TOL * top if dtype == torch.float32 else _bf16_ulp(top)
    for g, r in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - r.float()).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_roi_align_backward_non_finite_cotangent_vs_plain_autograd(cuda,
                                                                   dtype):
    """+inf on RoI 0 and NaN on RoI 1 of each image, both fully off the
    image (every sample off its level, so every tap weighs 0), and -inf on
    one channel of an in-image RoI: the kernel puts NaN and +-inf in the
    cells the plain autograd does, and the finite cells stay within the
    finite case's tolerance."""
    feats, _, boxes, valid, size = _width_inputs(cuda, dtype, 256, False, 24)
    valid[:, :2] = True
    rng = np.random.RandomState(25)
    cot = rng.randn(2, 96, 7, 7, 256).astype(np.float32)
    cot[:, 0] = np.inf
    cot[:, 1] = np.nan
    cot[:, 20, :, :, 3] = -np.inf
    cot = torch.from_numpy(cot).to(cuda, dtype)
    ref = [f.clone().requires_grad_(True) for f in feats]
    want = torch.autograd.grad(tra.multiscale_roi_align_batch(
        ref, boxes, size, 7, 2, valid), ref, cot)
    boxes_c, level, weight = RK.checked_inputs(feats, boxes, valid)
    got = RK.roi_align_backward(cot, [tuple(f.shape[1:3]) for f in feats],
                                dtype, boxes_c, level, weight, size, 2)
    torch.cuda.synchronize()
    assert any(bool(torch.isnan(r).any()) for r in want)
    finite = [r[torch.isfinite(r)].float() for r in want]
    top = max(float(r.abs().max()) for r in finite if r.numel())
    tol = ROI_TOL * top if dtype == torch.float32 else _bf16_ulp(top)
    for g, r in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert torch.equal(torch.isinf(g), torch.isinf(r))
        assert torch.equal(g[torch.isinf(g)], r[torch.isinf(r)])
        ok = torch.isfinite(r)
        if bool(ok.any()):
            assert float((g[ok].float() - r[ok].float()).abs().max()) <= tol


def test_roi_align_kernel_rejects_what_it_does_not_take(cuda):
    boxes = torch.zeros(1, 2, 4, device=cuda)
    sizes = (8, 4, 2, 1)
    f16 = [torch.zeros(1, s, s, 16, device=cuda, dtype=torch.float16)
           for s in sizes]
    with pytest.raises(TypeError):
        RK.roi_align(f16, boxes, (32, 32), 7)
    strided = [torch.zeros(1, 16, s, s, device=cuda).permute(0, 2, 3, 1)
               for s in sizes]
    with pytest.raises(ValueError):
        RK.roi_align(strided, boxes, (32, 32), 7)
    three = [torch.zeros(1, s, s, 16, device=cuda) for s in sizes[:3]]
    with pytest.raises(ValueError):
        RK.roi_align(three, boxes, (32, 32), 7)


# the stem's sums run in another order than cuDNN's: 147-term sums for the
# forward, B x OH x OW-term sums for dW
STEM_FWD_TOL = 1e-5    # x max |plain output|
STEM_DW_TOL = 1e-4     # x max |plain dW|


def _stem_inputs(cuda, b, h, w, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, 3, h, w), generator=gen, device=cuda)
    weight = torch.randn((64, 3, 7, 7), generator=gen, device=cuda) * 0.1
    scale = torch.rand(64, generator=gen, device=cuda) + 0.5
    bias = torch.randn(64, generator=gen, device=cuda) * 0.1
    return x, weight, scale, bias


# (B, H, W): whole tiles; a ragged last tile on both axes (33 x 50
# outputs); the smallest shape stem_supported takes; W/2 odd (17, so rows
# are not 16-byte aligned); 594 tiles of 65 x 673 outputs, ragged and W/2
# odd, which neither persistent grid of an H100 (264 forward, 132 dW
# blocks) divides; both buckets
@pytest.mark.parametrize("shape", [(2, 64, 96), (2, 66, 100), (1, 16, 32),
                                   (1, 16, 34), (3, 130, 1346),
                                   (2, 832, 1344), (2, 1344, 832)])
def test_stem_kernels_vs_plain(cuda, shape):
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    torch.backends.cudnn.allow_tf32 = False
    x, weight, scale, bias = _stem_inputs(cuda, *shape)
    counts = (SK.stem_fwd.launches, SK.stem_fwd_res.launches,
              SK.stem_dw.launches)
    want, conv = ts.stem_forward(x, weight, scale, bias, with_conv=True)
    got = SK.stem_fwd(x, weight, scale, bias)
    got_res, got_conv = SK.stem_fwd_res(x, weight, scale, bias)
    g = torch.randn_like(conv)
    dw = SK.stem_dw(x, g)
    torch.cuda.synchronize()
    tol = STEM_FWD_TOL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert torch.equal(got_res, got)
    assert float((got_conv - conv).abs().max()) <= \
        STEM_FWD_TOL * float(conv.abs().max())
    want_dw = ts.stem_weight_grad(x, g)
    assert float((dw - want_dw).abs().max()) <= \
        STEM_DW_TOL * float(want_dw.abs().max())
    assert torch.equal(SK.stem_dw(x, g), dw)  # no atomics: same bits
    assert (SK.stem_fwd.launches, SK.stem_fwd_res.launches,
            SK.stem_dw.launches) == (counts[0] + 1, counts[1] + 1,
                                     counts[2] + 2)


def test_stem_function_grads_vs_plain(cuda):
    from hnd_ghnd_tpu_torch.ops import stem as ts
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    torch.backends.cudnn.allow_tf32 = False
    args = _stem_inputs(cuda, 2, 64, 96)
    got = [a.clone().requires_grad_(True) for a in args]
    ref = [a.clone().requires_grad_(True) for a in args]
    SK.stem_conv_bn_relu(*got).square().sum().backward()
    ts.stem_forward(*ref).square().sum().backward()
    for name, g, r in zip(("dx", "dw", "dscale", "dbias"), got, ref):
        assert float((g.grad - r.grad).abs().max()) <= \
            STEM_DW_TOL * float(r.grad.abs().max()), name


def test_stem_kernels_reject_what_they_do_not_take(cuda):
    from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
    x, weight, scale, bias = _stem_inputs(cuda, 1, 32, 32)
    with pytest.raises(TypeError):
        SK.stem_fwd(x.double(), weight, scale, bias)
    with pytest.raises(ValueError):
        SK.stem_fwd(x[:, :, :31], weight, scale, bias)
    with pytest.raises(ValueError):
        SK.stem_fwd(x.transpose(2, 3), weight, scale, bias)
    with pytest.raises(ValueError):
        SK.stem_fwd(x, weight[:32], scale, bias)
    with pytest.raises(ValueError):
        SK.stem_dw(x, torch.zeros(1, 64, 16, 15, device=cuda))


def _int8_conv_cases():
    """Every distinct conv of the int8 tail's trunk at batch 8 on the
    832x1344 bucket, then chip_smoke's odd cases: (id, NHWC codes shape,
    C_out, kernel, stride, pad, groups)."""
    seen, cases = set(), []
    for name, shape, cout, k, stride, pad in int8_trunk_convs(BUCKETS[0],
                                                             EVAL_BATCH):
        if (shape, cout, k, stride, pad) not in seen:
            seen.add((shape, cout, k, stride, pad))
            cases.append((name, shape, cout, k, stride, pad, 1))
    return cases + list(INT8_CONV_ODD)


@pytest.mark.parametrize("name,shape,cout,k,stride,pad,groups",
                         _int8_conv_cases(), ids=lambda v: str(v))
def test_int8_conv_kernel_bit_exact_vs_plain(cuda, name, shape, cout, k,
                                             stride, pad, groups):
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + cout)
    x = torch.randint(-128, 128, shape, generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, k, k, shape[3] // groups),
                      generator=gen, device=cuda, dtype=torch.int8)
    n = IC.int8_conv.launches
    got = IC.int8_conv(x, w, stride, pad, groups)
    assert IC.int8_conv.launches == n + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, IC.int8_conv_plain(x, w, stride, pad, groups))


def test_int8_conv_kernel_at_storage_offset_1(cuda):
    """Codes 1 byte past an aligned address load byte by byte."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    base = torch.randint(-128, 128, (2 * 19 * 23 * 64 + 1,), device=cuda,
                         dtype=torch.int8)
    x = base[1:].view(2, 19, 23, 64)
    w = torch.randint(-127, 128, (96, 3, 3, 64), device=cuda,
                      dtype=torch.int8)
    assert torch.equal(IC.int8_conv(x, w, 1, 1),
                       IC.int8_conv_plain(x, w, 1, 1))


def test_int8_conv_kernel_rejects_what_it_does_not_take(cuda):
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.int8)
    w = torch.zeros(32, 3, 3, 16, device=cuda, dtype=torch.int8)
    with pytest.raises(TypeError):
        IC.int8_conv(x.float(), w)
    with pytest.raises(TypeError):
        IC.int8_conv(x, w.to(torch.uint8))
    with pytest.raises(ValueError):
        IC.int8_conv(x.transpose(1, 2), w)    # not contiguous NHWC
    with pytest.raises(ValueError):
        IC.int8_conv(x, w[..., :8].contiguous())  # C / groups does not fit
    with pytest.raises(ValueError):
        IC.int8_conv(x, w, groups=3)
    with pytest.raises(ValueError):
        IC.int8_conv(x[:, :2, :2].contiguous(), w)  # no output pixel
    with pytest.raises(ValueError):
        IC.int8_conv(x, w.cpu())


@pytest.mark.parametrize("epilogue", INT8_EPILOGUE_CASES, ids=lambda c: c[0])
@pytest.mark.parametrize("name,shape,cout,k,stride,pad,groups",
                         _int8_conv_cases(), ids=lambda v: str(v))
def test_int8_conv_requant_kernel_bit_exact_vs_plain(cuda, name, shape, cout,
                                                     k, stride, pad, groups,
                                                     epilogue):
    """Each mode of the fused kernel equals its plain version bit for bit
    (NaN where NaN), features included, on every distinct trunk shape at
    batch 8 and the odd cases; the launch goes through the main loop that
    ``template_for`` names."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    _, mode, relu, zp_in, identity, features = epilogue
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + cout + 1)
    x = torch.randint(-128, 128, shape, generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, k, k, shape[3] // groups),
                      generator=gen, device=cuda, dtype=torch.int8)
    kw = int8_epilogue(gen, x, w, stride, pad, groups, mode, relu, zp_in,
                       identity, features)
    path = IC.template_for(x, w, stride, groups)
    n, before = IC.int8_conv_requant.launches, dict(IC.template_launches)
    got = IC.int8_conv_requant(x, w, stride, pad, groups, **kw)
    assert IC.int8_conv_requant.launches == n + 1
    assert IC.template_launches[path] == before[path] + 1
    assert int8_outputs_equal(
        got, IC.int8_conv_requant_plain(x, w, stride, pad, groups, **kw))


def test_int8_conv_requant_kernel_at_storage_offset_1(cuda):
    """Codes 1 byte past an aligned address take the mma.sync main loop,
    byte by byte, with the fused epilogue."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randint(-128, 128, (2 * 19 * 23 * 64 + 1,), generator=gen,
                         device=cuda, dtype=torch.int8)
    x = base[1:].view(2, 19, 23, 64)
    w = torch.randint(-127, 128, (128, 3, 3, 64), generator=gen, device=cuda,
                      dtype=torch.int8)
    assert IC.template_for(x, w, 1) == "mma_sync"
    assert IC.template_for(x.clone(), w, 1) == "wgmma"
    kw = int8_epilogue(gen, x, w, 1, 1, 1, "site", True, True, None, True)
    assert int8_outputs_equal(IC.int8_conv_requant(x, w, 1, 1, **kw),
                              IC.int8_conv_requant_plain(x, w, 1, 1, **kw))


def test_int8_conv_requant_rejects_what_it_does_not_take(cuda):
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.zeros(1, 8, 8, 64, device=cuda, dtype=torch.int8)
    w = torch.zeros(128, 3, 3, 64, device=cuda, dtype=torch.int8)
    kw = int8_epilogue(gen, x, w, 1, 1, 1, "site", True, True, None, False)
    with pytest.raises(ValueError):
        IC.int8_conv_requant(x, w, 1, 1, **dict(kw, mode="requant"))
    with pytest.raises(ValueError):  # float biases on the CPU
        IC.int8_conv_requant(x, w, 1, 1, **dict(kw, bias=kw["bias"].cpu()))
    with pytest.raises(ValueError):  # a share of the wrong width
        IC.int8_conv_requant(x, w, 1, 1, **dict(kw, zp=kw["zp"][0, 0, 0]
                                                .contiguous()[:64]))
    with pytest.raises(ValueError):  # features of the float mode
        IC.int8_conv_requant(x, w, 1, 1, **dict(kw, mode="float",
                                                features=True))
    with pytest.raises(ValueError):  # a float64 scale
        IC.int8_conv_requant(x, w, 1, 1, **dict(kw, scale=kw["scale"]
                                                .double()))
    with pytest.raises(TypeError):
        IC.int8_conv_requant(x.float(), w, 1, 1, **kw)


@pytest.mark.parametrize("site_scale", [2.0 ** -70, 2.0 ** 70, 1e-30,
                                        float("nan"), 2.0 ** -60],
                         ids=["2^-70", "2^70", "1e-30", "nan", "2^-60"])
def test_int8_conv_requant_kernel_site_scales_off_the_fast_quotient(
        cuda, site_scale):
    """Site scales outside [2^-60, 2^60] (and NaN) take IEEE __fdiv_rn,
    2^-60 the branch-free quotient: both equal the plain version."""
    from hnd_ghnd_tpu_torch.ops import int8_conv as IC
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randint(-128, 128, (2, 9, 10, 128), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (128, 3, 3, 128), generator=gen, device=cuda,
                      dtype=torch.int8)
    for mode, relu, identity in (("site", False, None),
                                 ("residual", True, "float")):
        kw = int8_epilogue(gen, x, w, 1, 1, 1, mode, relu, True, identity,
                           True)
        kw["site_scale"] = torch.full((), site_scale, device=cuda)
        # y near the scale's own size, so the codes spread
        kw["scale"] = kw["scale"] * (site_scale / 2.0 ** -7
                                     if site_scale == site_scale else 1.0)
        kw["bias"] = kw["bias"] * (site_scale / 2.0 ** -7
                                   if site_scale == site_scale else 1.0)
        assert IC.template_for(x, w, 1) == "wgmma"
        assert int8_outputs_equal(
            IC.int8_conv_requant(x, w, 1, 1, **kw),
            IC.int8_conv_requant_plain(x, w, 1, 1, **kw))


@pytest.mark.parametrize("n,n_cats,nonfinite,dtype,thr", [
    (1, 0, False, torch.float32, 0.7), (63, 3, True, torch.float32, 0.5),
    (64, 0, True, torch.float32, 0.7), (65, 90, True, torch.float32, 0.5),
    (1000, 0, False, torch.float32, 0.7),
    (1000, 3, True, torch.bfloat16, 0.3007),
    (4096, 90, False, torch.float32, 0.5),
    (5000, 3, True, torch.float32, 0.5)])
def test_nms_kernel_vs_plain(cuda, n, n_cats, nonfinite, dtype, thr):
    """csrc/nms.cu's keep masks equal the plain fixpoint's on the card and
    on the CPU (ties, duplicates, zero areas, invalid rows, NaN and +-inf,
    bfloat16 boxes with a threshold that rounds up in bfloat16)."""
    rng = np.random.RandomState(n + n_cats)
    boxes, scores, valid, cats = nms_problem(rng, 3, n, n_cats, nonfinite,
                                             dtype)
    args = [t.to(cuda) if t is not None else None
            for t in (boxes, scores, valid, cats)]
    before = NMS.nms_keep.launches
    got = NMS.nms_keep(args[0], args[1], thr, args[2], args[3])
    assert NMS.nms_keep.launches == before + 1
    assert torch.equal(got, NMS.nms_plain(*args, thr))
    assert torch.equal(got.cpu(), NMS.nms_plain(boxes, scores, valid, cats,
                                                thr))


def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    boxes = torch.zeros(2, 5, 4, device=cuda)
    scores = torch.zeros(2, 5, device=cuda)
    valid = torch.ones(2, 5, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        NMS.nms_keep(boxes.double(), scores, 0.5, valid)
    with pytest.raises(TypeError):
        NMS.nms_keep(boxes, scores, 0.5, valid.float())
    with pytest.raises(ValueError):
        NMS.nms_keep(boxes, scores[:, :4], 0.5, valid)
    with pytest.raises(TypeError):
        NMS.nms_keep(boxes, scores, 0.5, valid, scores)
    big = NMS.MAX_BOXES + 1
    with pytest.raises(ValueError):
        NMS.nms_keep(torch.zeros(1, big, 4, device=cuda),
                     torch.zeros(1, big, device=cuda), 0.5,
                     torch.ones(1, big, dtype=torch.bool, device=cuda))
