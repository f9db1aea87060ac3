"""The port's plain quantizers on non-finite inputs, against the JAX package.

The rule is the JAX package's on the CPU: min, max and abs-max propagate
NaN; a NaN scale becomes 1 through the ``scale > 0`` guard; the float to
int conversion maps NaN to 0, as XLA's convert does (torch's cast of NaN
promises nothing and differs between the CPU and CUDA).  Each case puts a
NaN, a +inf, a -inf, or all three, at seeded places in an otherwise seeded
tensor:

  * the bottleneck codec, ``quantize_tensor``, against JAX's
    ``hnd_ghnd_tpu.codec.quantizer.quantize_tensor``: codes, scale and zero
    point equal;
  * the level quantizer, ``quantize_fpn_levels``, against JAX's
    ``quantize_fpn_levels`` under ``jax.jit`` (the program JAX's eval
    forward runs): codes and scales equal.  Every level holds the case's
    values, so every scale is 1 or inf; a finite level's jitted scale may
    be one ulp from the IEEE quotient (ROADMAP C11).

The finite case holds each codec to eager JAX and to the formula as it was
before the non-finite repair, bit for bit.  The CUDA kernels are held
against these plain versions on the card in tests/test_torch_port_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnd_ghnd_tpu.codec import quantizer as jq
from hnd_ghnd_tpu.ops import roi_align as jra
from hnd_ghnd_tpu_torch.codec import quantizer as tq
from hnd_ghnd_tpu_torch.ops import roi_align as tra
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

CASES = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
         "nan+-inf": [np.nan, np.inf, -np.inf], "finite": []}
# bottleneck-like NHWC, no multiple of 4; P2-P5 of a 64x96 bucket, C=8
CODEC_SHAPE = (2, 13, 21, 3)
LEVEL_SHAPES = [(2, 64 // s, 96 // s, 8) for s in (4, 8, 16, 32)]


def _with_specials(rng: np.random.RandomState, shape, specials):
    """Seeded N(0, 9) values around an offset, the specials at distinct
    seeded places."""
    x = (rng.randn(*shape) * 3 + rng.uniform(-2, 2)).astype(np.float32)
    flat = x.reshape(-1)
    at = rng.choice(flat.size, len(specials), replace=False)
    flat[at] = np.array(specials, np.float32)
    return x


def _old_codec(x: torch.Tensor):
    """quantize_tensor as it was before the non-finite repair."""
    min_val, max_val = x.min().float(), x.max().float()
    scale = (max_val - min_val) / torch.tensor(255.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    zp = (0.0 - min_val / safe).clamp(0.0, 255.0).to(torch.int32).float()
    codes = torch.round((zp + x.float() / safe).clamp(0.0, 255.0))
    return codes.to(torch.uint8), safe, zp


def _old_levels(levels):
    """quantize_fpn_levels as it was before the non-finite repair."""
    codes, scales = [], []
    for f in levels:
        amax = f.abs().max()
        s = torch.where(amax > 0, amax / torch.tensor(127.0),
                        torch.ones_like(amax))
        codes.append(torch.round(f / s).clamp(-127, 127).to(torch.int8))
        scales.append(s)
    return codes, torch.stack(scales)


@pytest.mark.parametrize("case", list(CASES))
def test_codec_non_finite_vs_jax(case):
    x = _with_specials(np.random.RandomState(40), CODEC_SHAPE, CASES[case])
    want = jq.quantize_tensor(jnp.asarray(x), 8)
    got = tq.quantize_tensor(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.tensor.numpy(), np.asarray(want.tensor))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(got.zero_point.numpy(),
                                  np.asarray(want.zero_point))
    if case == "finite":
        old_q, old_s, old_zp = _old_codec(torch.from_numpy(x))
        assert torch.equal(got.tensor, old_q)
        assert torch.equal(got.scale, old_s)
        assert torch.equal(got.zero_point, old_zp)
    else:
        # the wire carries finite values: the zero point is a code
        assert 0.0 <= got.zero_point.item() <= 255.0


@pytest.mark.parametrize("case", list(CASES))
def test_levels_non_finite_vs_jitted_jax(case):
    rng = np.random.RandomState(41)
    levels = [_with_specials(rng, s, CASES[case]) for s in LEVEL_SHAPES]
    got_q, got_s = tra.quantize_fpn_levels([torch.from_numpy(f)
                                            for f in levels])
    jl = [jnp.asarray(f) for f in levels]
    if case == "finite":
        # eager JAX divides as IEEE; jit folds the division (C11)
        want_q, want_s = jra.quantize_fpn_levels(jl)
        old_q, old_s = _old_levels([torch.from_numpy(f) for f in levels])
        assert torch.equal(got_s, old_s)
        assert all(torch.equal(g, o) for g, o in zip(got_q, old_q))
    else:
        want_q, want_s = jax.jit(jra.quantize_fpn_levels)(jl)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    for g, w in zip(got_q, want_q):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
