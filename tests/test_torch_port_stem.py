"""The port's fused stem against the JAX package's, on the CPU.

ops/stem.py (the plain stem) and ops/stem_kernels.StemConvBnRelu (the
counterpart of pallas_stem's custom VJP; on a CPU tensor its wrappers run
the plain versions, so its backward arithmetic is what runs here) against
``pallas_stem.stem_conv_bn_relu`` in interpret mode and ``stem_reference``,
on the same numpy inputs: forward, dx, dW, dscale and dbias at 64x96 and
at 66x64 (33 output rows: a ragged row tile), at the tolerances of
tests/test_pallas_stem.py (rtol 1e-5 / atol 1e-4 forward, 1e-4 / 1e-3
gradients: float32 sums in another order).  Then the stem switch of the
port's ResNet trunk, and the wrappers' refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnd_ghnd_tpu.ops.pallas_stem import (stem_conv_bn_relu as jax_stem,
                                          stem_reference as jax_stem_ref)
from hnd_ghnd_tpu_torch.models.resnet import ResNetBody
from hnd_ghnd_tpu_torch.ops import stem as ts
from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)
SHAPES = [(64, 96), (66, 64)]


def _inputs(h, w, b=2, seed=0):
    """The inputs of tests/test_pallas_stem.py: NHWC/HWIO for JAX."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, 3).astype(np.float32)
    w7 = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    return x, w7, scale, bias


def _port(x, w7, scale, bias, grad=False):
    """The same tensors in the port's layout: NCHW and OIHW."""
    ts_ = [torch.from_numpy(np.ascontiguousarray(a)) for a in
           (x.transpose(0, 3, 1, 2), w7.transpose(3, 2, 0, 1), scale, bias)]
    return [t.requires_grad_(grad) for t in ts_]


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _hwio(t):
    return t.detach().permute(2, 3, 1, 0).numpy()


@pytest.fixture(scope="module", params=SHAPES, ids=["64x96", "66x64"])
def case(request):
    h, w = request.param
    x, w7, scale, bias = _inputs(h, w)
    args = [jnp.asarray(a) for a in (x, w7, scale, bias)]
    fwd = np.asarray(jax_stem(*args, True))

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) ** 2 * 0.5)

    grads = jax.grad(loss(lambda *a: jax_stem(*a, True)),
                     argnums=(0, 1, 2, 3))(*args)
    ref_grads = jax.grad(loss(jax_stem_ref), argnums=(0, 1, 2, 3))(*args)
    return (x, w7, scale, bias), fwd, [np.asarray(g) for g in grads], \
        [np.asarray(g) for g in ref_grads]


def test_stem_supported_matches_jax():
    from hnd_ghnd_tpu.ops.pallas_stem import stem_supported as jax_supported
    for shape in [(1, 64, 64, 3), (1, 63, 64, 3), (1, 64, 64, 4),
                  (1, 8, 64, 3), (1, 16, 32, 3), (1, 16, 30, 3)]:
        nchw = (shape[0], shape[3], shape[1], shape[2])
        assert ts.stem_supported(torch.zeros(nchw)) == \
            jax_supported(jnp.zeros(shape)), shape


def test_plain_forward_matches_jax(case):
    inputs, fwd, _, _ = case
    got = ts.stem_forward(*_port(*inputs))
    assert got.shape == (2, 64) + tuple(s // 2 for s in inputs[0].shape[1:3])
    np.testing.assert_allclose(_nhwc(got), fwd, **FWD_TOL)
    np.testing.assert_allclose(
        fwd, np.asarray(jax_stem_ref(*[jnp.asarray(a) for a in inputs])),
        **FWD_TOL)


def test_function_forward_and_residual(case):
    inputs, fwd, _, _ = case
    x, w, s, b = _port(*inputs)
    out, conv = SK.stem_fwd_res(x, w, s, b)
    np.testing.assert_allclose(_nhwc(out), fwd, **FWD_TOL)
    torch.testing.assert_close(conv, ts.stem_conv(x, w), rtol=0, atol=0)
    torch.testing.assert_close(SK.stem_fwd(x, w, s, b), out, rtol=0, atol=0)


@pytest.mark.parametrize("which", ["pallas", "reference"])
def test_function_grads_match_jax(case, which):
    inputs, _, grads, ref_grads = case
    want = grads if which == "pallas" else ref_grads
    x, w, s, b = _port(*inputs, grad=True)
    y = SK.stem_conv_bn_relu(x, w, s, b)
    (y * y * 0.5).sum().backward()
    got = [_nhwc(x.grad), _hwio(w.grad), s.grad.numpy(), b.grad.numpy()]
    for name, g, ref in zip(["dx", "dw", "dscale", "dbias"], got, want):
        np.testing.assert_allclose(g, ref, err_msg=name, **GRAD_TOL)


def test_function_grads_match_autograd_of_plain(case):
    """The Function's hand-written backward against autograd through the
    plain stem, including the ReLU's cut at 0 on the saved conv."""
    inputs, _, _, _ = case
    got_args = _port(*inputs, grad=True)
    ref_args = _port(*inputs, grad=True)
    SK.stem_conv_bn_relu(*got_args).pow(3).sum().backward()
    ts.stem_forward(*ref_args).pow(3).sum().backward()
    for name, g, r in zip(["dx", "dw", "dscale", "dbias"], got_args, ref_args):
        scale = float(r.grad.abs().max())
        assert float((g.grad - r.grad).abs().max()) <= 1e-5 * scale, name


def test_no_grad_runs_the_primal():
    x, w, s, b = _port(*_inputs(64, 64))
    w.requires_grad_(True)
    with torch.no_grad():
        y = SK.stem_conv_bn_relu(x, w, s, b)
    assert y.grad_fn is None
    assert SK.stem_conv_bn_relu(x, w, s, b).grad_fn is not None


def test_dx_only_when_asked(case):
    inputs, _, _, _ = case
    x, w, s, b = _port(*inputs)
    w.requires_grad_(True)
    SK.stem_conv_bn_relu(x, w, s, b).sum().backward()
    assert x.grad is None and w.grad is not None


def test_resnet_stem_switch(monkeypatch):
    """Under HND_TPU_PALLAS_STEM=1 the trunk's stem goes through the fused
    Function (plain versions on the CPU) and agrees with conv1/bn1/ReLU,
    forward and gradients of the stem's weight and frozen-BN affine."""
    torch.manual_seed(0)
    body = ResNetBody()
    with torch.no_grad():
        body.bn1.weight.uniform_(0.5, 1.5)
        body.bn1.bias.uniform_(-0.1, 0.1)
        body.bn1.running_mean.uniform_(-0.1, 0.1)
        body.bn1.running_var.uniform_(0.5, 2.0)
    x = torch.from_numpy(_inputs(64, 96)[0]).permute(0, 3, 1, 2).contiguous()
    params = (body.conv1.weight, body.bn1.weight, body.bn1.bias)

    def run():
        y = body.stem(x)
        grads = torch.autograd.grad(y.square().sum(), params)
        return y.detach(), grads

    base, base_g = run()
    monkeypatch.setenv("HND_TPU_PALLAS_STEM", "1")
    launched = SK.StemConvBnRelu.apply
    calls = []
    monkeypatch.setattr(SK.StemConvBnRelu, "apply",
                        lambda *a: calls.append(1) or launched(*a))
    fused, fused_g = run()
    assert calls == [1]
    torch.testing.assert_close(fused, base, rtol=1e-5, atol=1e-4)
    for g, r in zip(fused_g, base_g):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
    # an input the fused stem does not take stays on conv1/bn1/ReLU
    body.stem(x[:, :, :63])
    assert calls == [1]


def test_wrappers_refuse_other_devices():
    x, w, s, b = _port(*_inputs(64, 64))
    meta = [t.to("meta") for t in (x, w, s, b)]
    with pytest.raises(ValueError):
        SK.stem_fwd(*meta)
    with pytest.raises(ValueError):
        SK.stem_fwd_res(*meta)
    with pytest.raises(ValueError):
        SK.stem_dw(meta[0], torch.zeros(2, 64, 32, 32, device="meta"))
