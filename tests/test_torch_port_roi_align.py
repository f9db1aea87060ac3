"""The port's multi-level RoIAlign against the JAX package's.

The plain version is held against JAX ``multiscale_roi_align_batch`` (the
XLA path JAX runs on the CPU) and, at a small size, against
``pallas_multiscale_roi_align_batch`` in interpret mode, on the box mix of
tests/test_pallas_roi.py, to 1e-5 of the largest output (1e-4 against the
Pallas kernel, see PALLAS_TOL).  The CUDA kernel is held against the plain
version on the card in tests/test_torch_port_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import box_mix as _boxes
from hnd_ghnd_tpu.ops import roi_align as jra
from hnd_ghnd_tpu.ops.pallas_roi import pallas_multiscale_roi_align_batch
from hnd_ghnd_tpu_torch.ops import roi_align as tra
from hnd_ghnd_tpu_torch.ops import roi_align_kernels as RK

TOL = 1e-5  # x max |reference|: same arithmetic, summation order may differ
# the Pallas kernel places its samples at (bin + samp) * bin_h, which rounds
# differently from the XLA path's bin * bin_h + samp * bin_h; the JAX package
# holds it to the XLA path at 1e-4 (tests/test_pallas_roi.py), so that is
# the bound against it here too
PALLAS_TOL = 1e-4


def _feats(rng, b, h, w, c):
    return [rng.randn(b, h // st, w // st, c).astype(np.float32)
            for st in (4, 8, 16, 32)]


def _port(feats, boxes, size, pool, valid):
    return tra.multiscale_roi_align_batch(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), size,
        pool, 2, None if valid is None else torch.from_numpy(valid)).numpy()


def _assert_close(got, want, tol=TOL):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max err {err} vs {tol} x {scale}"


@pytest.mark.parametrize("pool,with_valid", [(7, True), (7, False), (14, True)])
def test_plain_vs_jax_xla(pool, with_valid):
    rng = np.random.RandomState(pool + with_valid)
    b, n, h, w = 2, 40, 256, 512
    feats, boxes = _feats(rng, b, h, w, 32), _boxes(rng, b, n, h, w)
    valid = (rng.rand(b, n) > 0.3) if with_valid else None
    want = np.asarray(jra.multiscale_roi_align_batch(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), (h, w), pool,
        boxes_valid=None if valid is None else jnp.asarray(valid)))
    _assert_close(_port(feats, boxes, (h, w), pool, valid), want)


def test_plain_vs_pallas_interpret():
    rng = np.random.RandomState(11)
    b, n, h, w = 2, 5, 256, 512
    feats, boxes = _feats(rng, b, h, w, 8), _boxes(rng, b, n, h, w)
    valid = rng.rand(b, n) > 0.3
    want = np.asarray(pallas_multiscale_roi_align_batch(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes), (h, w), 7,
        boxes_valid=jnp.asarray(valid), interpret=True))
    _assert_close(_port(feats, boxes, (h, w), 7, valid), want, PALLAS_TOL)


def test_level_assignment_matches_jax():
    rng = np.random.RandomState(12)
    boxes = _boxes(rng, 4, 50, 832, 1344).reshape(-1, 4)
    np.testing.assert_array_equal(
        tra.assign_levels(torch.from_numpy(boxes)).numpy(),
        np.asarray(jra.assign_levels(jnp.asarray(boxes))))


def test_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.RandomState(13)
    feats, boxes = _feats(rng, 1, 128, 192, 8), _boxes(rng, 1, 10, 128, 192)
    counts = RK.roi_align.launches.copy()
    got = RK.roi_align([torch.from_numpy(f) for f in feats],
                       torch.from_numpy(boxes), (128, 192), 7)
    assert RK.roi_align.launches == counts
    np.testing.assert_array_equal(got.numpy(),
                                  _port(feats, boxes, (128, 192), 7, None))
