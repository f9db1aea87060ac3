"""The port's RoIAlign on bfloat16 levels, and its backward, against the
JAX package's, on the CPU.

  * forward on bf16 tables: the port's plain version (the bf16 levels
    upcast, the float32 program, one rounding) against JAX's
    ``pallas_multiscale_roi_align_batch`` in interpret mode and against
    XLA's ``multiscale_roi_align_batch`` in bf16, to 3e-2 of the largest
    output (JAX's own bound between the two, tests/test_pallas_roi.py);
    against the float64 program on the same bf16 values the port is no
    farther off than JAX (both JAX programs round the bilinear weights to
    bf16 as well, the port keeps them float32);
  * backward: the plain version's autograd against ``jax.value_and_grad``
    through ``pallas_multiscale_roi_align_batch_vjp``, f32 to 1e-4 of the
    largest gradient, bf16 no farther from the float64 gradient than
    JAX's (which scatters in bf16); boxes get no gradient;
  * on CPU tensors ``roi_align_train`` is the plain version, and the
    kernels' launch counts do not move.

The card's kernels are held against these plain versions in
tests/test_torch_port_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_mix
from hnd_ghnd_tpu.ops import roi_align as jra
from hnd_ghnd_tpu.ops.pallas_roi import (pallas_multiscale_roi_align_batch,
                                         pallas_multiscale_roi_align_batch_vjp)
from hnd_ghnd_tpu_torch.ops import roi_align as tra
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK

BF16_TOL = 3e-2   # x max |reference|: tests/test_pallas_roi.py's bf16 bound
F32_GRAD_TOL = 1e-4
SIZE = (256, 512)


def _inputs(seed, b, n, c):
    rng = np.random.RandomState(seed)
    h, w = SIZE
    feats = [rng.randn(b, h // s, w // s, c).astype(np.float32)
             for s in (4, 8, 16, 32)]
    boxes = box_mix(rng, b, n, h, w)
    valid = rng.rand(b, n) > 0.2
    cot = rng.randn(b, n, 7, 7, c).astype(np.float32)
    return feats, boxes, valid, cot


def _bf16(a):
    """float32 numpy -> the bf16 values (as float32 numpy), rounded by JAX."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _port(feats, boxes, valid, dtype):
    return tra.multiscale_roi_align_batch(
        [torch.from_numpy(f).to(dtype) for f in feats],
        torch.from_numpy(boxes), SIZE, 7, 2, torch.from_numpy(valid))


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(want, np.float64)).max())


@pytest.fixture(scope="module")
def bf16_case():
    feats, boxes, valid, _ = _inputs(0, 2, 5, 8)
    feats = [_bf16(f) for f in feats]
    exact = _port(feats, boxes, valid, torch.float64).numpy()
    got = _port(feats, boxes, valid, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    return feats, boxes, valid, exact, got.float().numpy()


def test_bf16_forward_vs_pallas_interpret(bf16_case):
    feats, boxes, valid, exact, got = bf16_case
    want = np.asarray(pallas_multiscale_roi_align_batch(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(boxes),
        SIZE, 7, boxes_valid=jnp.asarray(valid), interpret=True)
        .astype(jnp.float32))
    assert _err(got, want) <= BF16_TOL * np.abs(want).max()
    assert _err(got, exact) <= _err(want, exact)


def test_bf16_forward_vs_xla(bf16_case):
    feats, boxes, valid, exact, got = bf16_case
    want = np.asarray(jra.multiscale_roi_align_batch(
        [jnp.asarray(f, jnp.bfloat16) for f in feats], jnp.asarray(boxes),
        SIZE, 7, boxes_valid=jnp.asarray(valid)).astype(jnp.float32))
    assert _err(got, want) <= BF16_TOL * np.abs(want).max()
    assert _err(got, exact) <= _err(want, exact)


def _jax_grads(feats, boxes, valid, cot, dtype):
    """JAX's feature gradients of sum(pool * cot) through the custom-VJP
    train pool, and its box gradient."""
    def loss(fs, bx):
        out = pallas_multiscale_roi_align_batch_vjp(
            fs, bx, SIZE, 7, boxes_valid=jnp.asarray(valid))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(cot))

    fs = [jnp.asarray(f, dtype) for f in feats]
    _, (g, g_boxes) = jax.value_and_grad(loss, argnums=(0, 1))(
        fs, jnp.asarray(boxes))
    return [np.asarray(x.astype(jnp.float32)) for x in g], np.asarray(g_boxes)


def _port_grads(feats, boxes, valid, cot, dtype):
    fs = [torch.from_numpy(f).to(dtype).requires_grad_(True) for f in feats]
    bx = torch.from_numpy(boxes).requires_grad_(True)
    out = RK.roi_align_train(fs, bx, SIZE, 7, 2, torch.from_numpy(valid))
    assert out.dtype == dtype
    g = torch.autograd.grad(out, fs + [bx], torch.from_numpy(cot).to(dtype),
                            allow_unused=True)
    assert g[-1] is None  # the boxes have no gradient path
    assert all(x.dtype == dtype for x in g[:-1])
    return [x.double().numpy() for x in g[:-1]]


def test_f32_backward_vs_jax_vjp():
    feats, boxes, valid, cot = _inputs(1, 2, 6, 8)
    want, g_boxes = _jax_grads(feats, boxes, valid, cot, jnp.float32)
    got = _port_grads(feats, boxes, valid, cot, torch.float32)
    assert float(np.abs(g_boxes).max()) == 0.0
    for g, w in zip(got, want):
        assert _err(g, w) <= F32_GRAD_TOL * np.abs(w).max()


def test_bf16_backward_no_farther_from_float64_than_jax():
    feats, boxes, valid, cot = _inputs(2, 2, 6, 8)
    feats = [_bf16(f) for f in feats]
    cot = _bf16(cot)
    want, _ = _jax_grads(feats, boxes, valid, cot, jnp.bfloat16)
    got = _port_grads(feats, boxes, valid, cot, torch.bfloat16)
    exact = _port_grads(feats, boxes, valid, cot, torch.float64)
    for g, w, e in zip(got, want, exact):
        assert _err(g, e) <= _err(w, e)
        assert _err(g, w) <= BF16_TOL * np.abs(w).max()


def test_wrappers_on_cpu_are_the_plain_version():
    feats, boxes, valid, _ = _inputs(3, 1, 10, 8)
    counts = (RK.roi_align.launches.copy(),
              RK.roi_align_backward.launches.copy())
    fs = [torch.from_numpy(f).bfloat16().requires_grad_(True) for f in feats]
    got = RK.roi_align_train(fs, torch.from_numpy(boxes), SIZE, 7, 2,
                             torch.from_numpy(valid))
    got.float().sum().backward()
    also = RK.roi_align(fs, torch.from_numpy(boxes), SIZE, 7, 2,
                        torch.from_numpy(valid))
    want = _port(feats, boxes, valid, torch.bfloat16)
    assert torch.equal(got, want) and torch.equal(also, want)
    assert (RK.roi_align.launches, RK.roi_align_backward.launches) == counts


def _non_finite_case(seed):
    """The box mix with, in every image, RoI 0 fully below and right of the
    image and RoI 1 fully above and left of it (every sample off its
    level); a cotangent of +inf on RoI 0, NaN on RoI 1 and -inf on one
    channel of an in-image RoI 5."""
    feats, boxes, valid, cot = _inputs(seed, 2, 8, 8)
    h, w = SIZE
    boxes[:, 0] = (w + 60, h + 60, w + 140, h + 120)
    boxes[:, 1] = (-300, -260, -200, -230)
    valid[:, :2] = True
    cot[:, 0] = np.inf
    cot[:, 1] = np.nan
    cot[:, 5, :, :, 3] = -np.inf
    return feats, boxes, valid, cot


def test_non_finite_cotangent_spreads_like_jax_vjp():
    """A non-finite cotangent reaches the same cells in the port's plain
    backward as in jax.vjp of the XLA path: inf * 0 = NaN in the clamped
    cells of an off-level RoI, +-inf where every weight is positive."""
    feats, boxes, valid, cot = _non_finite_case(4)

    def pool(*fs):
        return jra.multiscale_roi_align_batch(
            list(fs), jnp.asarray(boxes), SIZE, 7,
            boxes_valid=jnp.asarray(valid))

    _, vjp = jax.vjp(pool, *[jnp.asarray(f) for f in feats])
    want = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    got = _port_grads(feats, boxes, valid, cot, torch.float32)
    assert any(np.isnan(w).any() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        finite = np.isfinite(w)
        assert _err(g[finite], w[finite]) <= \
            F32_GRAD_TOL * np.abs(w[finite]).max()
