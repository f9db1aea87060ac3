"""The port's int8 RoIAlign tables against the JAX package's.

``quantize_fpn_levels`` (symmetric per-level int8 codes, one batch-global
scale per level) must give JAX's codes and scales bit for bit: both divide
by the scale as IEEE float32 and round half to even (JAX's jitted program
divides by 127 otherwise; its one-ulp scales are counted apart).  The plain int8 pooling
is held against JAX's XLA ``multiscale_roi_align_batch(..., quant=...)`` to
1e-6 of the largest output (the same float32 operations in the same order:
the codes convert exactly, and the scale folds into the weights in JAX's
order) and against ``pallas_multiscale_roi_align_batch(..., quant=tables,
interpret=True)`` to 3e-3 of it, the bound tests/test_pallas_roi.py holds
the Pallas kernel's int8 path to against the XLA path.  Small sizes: batch
2 on a 96x128 bucket with its padding rows zero, seeds from numpy.  The CUDA
kernels are held against these plain versions on the card in
tests/test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_mix
from hnd_ghnd_tpu.ops import roi_align as jra
from hnd_ghnd_tpu.ops.pallas_roi import pallas_multiscale_roi_align_batch
from hnd_ghnd_tpu_torch.ops import roi_align as tra
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

B, H, W, C = 2, 96, 128, 16
XLA_TOL = 1e-6      # x max |JAX|: same float32 arithmetic, same order
PALLAS_TOL = 3e-3   # x max(|JAX|, 1), as tests/test_pallas_roi.py


def _levels(seed: int, zero_level: bool = False):
    """P2-P5 of a batch whose second image fills 70x100 of the bucket (the
    rest is zero padding, as the FPN of a padded batch is not, but the
    quantizer must count zeros all the same), NHWC float32."""
    rng = np.random.RandomState(seed)
    out = []
    for i, st in enumerate((4, 8, 16, 32)):
        f = (rng.randn(B, H // st, W // st, C) * rng.uniform(0.5, 4.0)
             ).astype(np.float32)
        f[1, 70 // st:, :] = 0.0
        f[1, :, 100 // st:] = 0.0
        if zero_level and i == 3:
            f[:] = 0.0
        out.append(f)
    return out


def _port_views(levels):
    """The NHWC views of NCHW maps, as RoIHeads hands them over."""
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2)))
            .permute(0, 2, 3, 1) for f in levels]


@pytest.mark.parametrize("zero_level", [False, True], ids=["random", "zero_p5"])
def test_quantize_fpn_levels_bit_exact_vs_jax(zero_level):
    levels = _levels(1 + zero_level, zero_level)
    want_q, want_s = jra.quantize_fpn_levels([jnp.asarray(f) for f in levels])
    for port_levels in ([torch.from_numpy(f) for f in levels],
                        _port_views(levels)):
        got_q, got_s = tra.quantize_fpn_levels(port_levels)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        assert got_s.dtype == torch.float32
        for g, w in zip(got_q, want_q):
            assert g.dtype == torch.int8 and g.is_contiguous()
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if zero_level:
        assert float(got_s[3]) == 1.0
    # the codes use the whole range: max |q| is 127 on every live level
    assert all(int(q.abs().max()) == 127 for q in got_q[:3])


def test_jitted_jax_scales_within_one_ulp():
    """Under jit, XLA folds JAX's ``amax / 127.0`` into ``amax * (1/127)``
    (the eval forward's program), which can miss the IEEE quotient the port
    and eager JAX compute by one ulp; a code then moves only where f / s
    lies within that ulp of a rounding boundary.  Counted here: every
    scale within one ulp, every code within one step, and few codes moved."""
    import jax
    levels = _levels(3)
    jl = [jnp.asarray(f) for f in levels]
    jit_q, jit_s = jax.jit(jra.quantize_fpn_levels)(jl)
    got_q, got_s = tra.quantize_fpn_levels([torch.from_numpy(f)
                                            for f in levels])
    ulps = np.abs(np.asarray(jit_s).view(np.int32)
                  - got_s.numpy().view(np.int32))
    assert int(ulps.max()) <= 1
    moved = [np.abs(np.asarray(j, np.int32) - g.numpy().astype(np.int32))
             for j, g in zip(jit_q, got_q)]
    assert max(int(m.max()) for m in moved) <= 1
    assert sum(int((m > 0).sum()) for m in moved) <= 1e-4 * sum(
        m.size for m in moved)


def _assert_close(got, want, tol, floor=0.0):
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err} vs {tol} x {scale}"


@pytest.mark.parametrize("pool,with_valid", [(7, True), (7, False),
                                             (14, True), (14, False)])
def test_plain_int8_vs_jax_xla(pool, with_valid):
    rng = np.random.RandomState(10 + pool + with_valid)
    levels = _levels(pool)
    boxes = box_mix(rng, B, 30, H, W)
    valid = (rng.rand(B, 30) > 0.3) if with_valid else None
    jl = [jnp.asarray(f) for f in levels]
    want = np.asarray(jra.multiscale_roi_align_batch(
        jl, jnp.asarray(boxes), (H, W), pool,
        boxes_valid=None if valid is None else jnp.asarray(valid),
        quant=jra.quantize_fpn_levels(jl)))
    pl = _port_views(levels)
    tv = None if valid is None else torch.from_numpy(valid)
    got = tra.multiscale_roi_align_batch(
        pl, torch.from_numpy(boxes), (H, W), pool, 2, tv,
        quant=tra.quantize_fpn_levels(pl))
    assert got.dtype == torch.float32
    _assert_close(got.numpy(), want, XLA_TOL)
    # "int8" quantizes inside the call: the same tables, the same result
    again = tra.multiscale_roi_align_batch(pl, torch.from_numpy(boxes),
                                           (H, W), pool, 2, tv, quant="int8")
    assert torch.equal(again, got)


def test_plain_int8_vs_pallas_interpret():
    rng = np.random.RandomState(21)
    levels = _levels(21)
    boxes = box_mix(rng, B, 4, H, W)
    valid = rng.rand(B, 4) > 0.3
    jl = [jnp.asarray(f) for f in levels]
    want = np.asarray(pallas_multiscale_roi_align_batch(
        jl, jnp.asarray(boxes), (H, W), 7, boxes_valid=jnp.asarray(valid),
        quant=jra.quantize_fpn_levels(jl), interpret=True))
    pl = _port_views(levels)
    got = tra.multiscale_roi_align_batch(
        pl, torch.from_numpy(boxes), (H, W), 7, 2, torch.from_numpy(valid),
        quant=tra.quantize_fpn_levels(pl))
    _assert_close(got.numpy(), want, PALLAS_TOL, floor=1.0)


def test_int8_pool_within_half_a_step_of_the_float_pool():
    """Each bin is a weighted mean (weights summing to at most 1) of values
    each within half a quantization step of its float: the int8 pool is
    within half its level's step of the float pool, plus float32
    rounding."""
    rng = np.random.RandomState(22)
    levels = _levels(22)
    boxes = torch.from_numpy(box_mix(rng, B, 30, H, W))
    pl = _port_views(levels)
    codes, scales = tra.quantize_fpn_levels(pl)
    got = tra.multiscale_roi_align_batch(pl, boxes, (H, W), 14,
                                         quant=(codes, scales))
    want = tra.multiscale_roi_align_batch([v.contiguous() for v in pl], boxes,
                                          (H, W), 14)
    step = scales[tra.assign_levels(boxes.reshape(-1, 4)).long()]
    err = (got - want).abs().reshape(B * 30, -1).max(1).values
    assert bool((err <= 0.5 * step + 1e-6 * float(want.abs().max())).all())


def test_wrappers_on_cpu_are_the_plain_versions():
    rng = np.random.RandomState(23)
    pl = _port_views(_levels(23))
    boxes = torch.from_numpy(box_mix(rng, B, 10, H, W))
    counts = (RK.roi_align.launches.copy(), RK.quantize_levels.launches)
    codes, scales = RK.quantize_levels(pl)
    want_q, want_s = tra.quantize_fpn_levels(pl)
    assert torch.equal(scales, want_s)
    assert all(torch.equal(a, b) for a, b in zip(codes, want_q))
    got = RK.roi_align(pl, boxes, (H, W), 7, quant=(codes, scales))
    assert torch.equal(got, tra.multiscale_roi_align_batch(
        pl, boxes, (H, W), 7, quant=(want_q, want_s)))
    assert (RK.roi_align.launches, RK.quantize_levels.launches) == counts
    with pytest.raises(ValueError):
        RK.roi_align(pl, boxes, (H, W), 7, quant="int4")
