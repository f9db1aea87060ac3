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


@pytest.mark.parametrize("c,pool", [(256, 7), (40, 7), (256, 14)])
def test_roi_align_int8_kernel_vs_plain(cuda, c, pool):
    feats = _int8_inputs(cuda, c, 19, True)
    rng = np.random.RandomState(19)
    boxes = torch.from_numpy(_boxes(rng, 2, 150, 256, 512)).to(cuda)
    valid = torch.from_numpy(rng.rand(2, 150) > 0.3).to(cuda)
    tables = tra.quantize_fpn_levels(feats)
    counts = (RK.roi_align.launches, RK.roi_align.launches_int8)
    got = RK.roi_align(feats, boxes, (256, 512), pool, 2, valid, quant=tables)
    assert (RK.roi_align.launches, RK.roi_align.launches_int8) == (
        counts[0], counts[1] + 1)
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
    launches = RK.roi_align.launches_bf16
    got = RK.roi_align(feats, boxes, size, pool, 2, valid)
    assert RK.roi_align.launches_bf16 == launches + 1
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
    counts = (RK.roi_align.launches, RK.roi_align.launches_bf16,
              RK.roi_align_backward.launches)
    out = RK.roi_align_train(got_in, boxes, size, 7, 2, valid)
    got = torch.autograd.grad(out, got_in, cot)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert (RK.roi_align.launches, RK.roi_align.launches_bf16,
            RK.roi_align_backward.launches) == (counts[0] + f32,
                                                counts[1] + (not f32),
                                                counts[2] + 1)
    top = max(float(g.float().abs().max()) for g in want)
    # atomics add in another order: f32 within 1e-5 of the largest
    # gradient, bf16 within one bf16 ulp of it
    tol = ROI_TOL * top if f32 else _bf16_ulp(top)
    for g, r in zip(got, want):
        assert g.dtype == dtype
        assert float((g.float() - r.float()).abs().max()) <= tol


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
