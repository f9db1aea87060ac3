"""The port's fused stem in bfloat16 against the JAX package's, on the CPU.

JAX's Pallas stem runs in the input's dtype (pallas_stem.py): with bf16
activations the weight matrix is rounded to bf16, the products are summed
in float32, the output and the pre-affine conv residual are stored in
bf16, and the backward rounds the conv's cotangent to bf16 for dW.  The
port's plain versions (ops/stem.py) and its autograd Function
(ops/stem_kernels.StemConvBnRelu, on its plain versions for a CPU tensor)
are held against ``pallas_stem.stem_conv_bn_relu`` in interpret mode on
the same numpy inputs:

  * forward and residual within one bf16 ulp of the largest output, and
    at most DIFF_FRAC of the output's elements differing from JAX's: both
    sides round the same float32 sum of exact products, summed in another
    order, so only an element whose sum lies at a rounding boundary may
    flip.  A control with the weight left unrounded (JAX rounds it,
    pallas_stem.py:249) stays within the ulp but fails the count;
  * dW, dscale and dbias from a fixed cotangent, at GRAD_TOL of each
    one's largest element (see there);
  * the trunk to ``layer1`` with the stem switch on, against JAX's jitted
    bf16 trunk with the switch on, within twice JAX's own bf16-vs-float32
    gap of that trunk (tests/test_torch_port_bf16_step.py's scheme);
  * the kernels' dtype check: float16 still raises.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnd_ghnd_tpu.models.resnet import ResNetBody as JaxBody
from hnd_ghnd_tpu.ops.pallas_stem import stem_conv_bn_relu as jax_stem
from hnd_ghnd_tpu_torch.models.convert import state_dict_from_jax
from hnd_ghnd_tpu_torch.models.resnet import ResNetBody
from hnd_ghnd_tpu_torch.ops import stem as ts
from hnd_ghnd_tpu_torch.ops import stem_kernels as SK
from tests.test_torch_port_multiprocess import xdist_threads  # noqa: F401

SHAPE = (2, 64, 96, 3)  # NHWC
# dW sums bf16 x bf16 products (exact in float32) over B x OH x OW in
# float32 on both sides, in another order: the float32 stem's dW bound of
# tests/test_torch_port_stem.py (1e-4 relative); dscale and dbias sum
# float32 products of the same bf16 residual
GRAD_TOL = 1e-4
# forward: the share of elements that may differ from JAX's (6 of 196608
# measured, 3e-5; the unrounded-weight control flips about a fifth)
DIFF_FRAC = 1e-4


def bf16_ulp(x: float) -> float:
    """One bfloat16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*SHAPE).astype(np.float32)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w7 = (rng.randn(7, 7, 3, 64) * 0.1).astype(np.float32)
    scale = (rng.rand(64) + 0.5).astype(np.float32)
    bias = (rng.randn(64) * 0.1).astype(np.float32)
    g = rng.randn(SHAPE[0], SHAPE[1] // 2, SHAPE[2] // 2, 64).astype(
        np.float32)
    return x, w7, scale, bias, g


def _port(x, w7, scale, bias, grad=False):
    """NCHW bf16 x; OIHW float32 weight; float32 scale and bias."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    ts_ = [xt.bfloat16()] + [torch.from_numpy(np.ascontiguousarray(a)) for a
                             in (w7.transpose(3, 2, 0, 1), scale, bias)]
    return [t.requires_grad_(grad and i > 0) for i, t in enumerate(ts_)]


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def jax_case():
    x, w7, scale, bias, g = _inputs()
    args = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w7), jnp.asarray(scale),
            jnp.asarray(bias))
    out = jax_stem(*args, True)
    assert out.dtype == jnp.bfloat16

    def loss(w7, scale, bias):
        y = jax_stem(args[0], w7, scale, bias, True)
        return jnp.sum(y.astype(jnp.float32) * jnp.asarray(g))

    grads = jax.grad(loss, argnums=(0, 1, 2))(*args[1:])
    return (x, w7, scale, bias, g), np.asarray(out.astype(jnp.float32)), \
        [np.asarray(a) for a in grads]


def test_plain_forward_within_one_ulp_of_jax(jax_case):
    inputs, want, _ = jax_case
    x, w, s, b = _port(*inputs[:4])
    out, conv = ts.stem_forward(x, w, s, b, with_conv=True)
    assert out.dtype == conv.dtype == torch.bfloat16
    ulp = bf16_ulp(float(np.abs(want).max()))
    most = DIFF_FRAC * want.size
    assert float(np.abs(_nhwc(out) - want).max()) <= ulp
    assert int((_nhwc(out) != want).sum()) <= most
    # control: the plain output without the weight's rounding to bf16
    ctrl = _nhwc(ts.stem_forward(x.float(), w, s, b).bfloat16())
    assert float(np.abs(ctrl - want).max()) <= ulp
    assert int((ctrl != want).sum()) > most
    # the residual is the float32 conv of the bf16 operands, rounded once
    w_bf = w.to(torch.bfloat16).float()
    ref = torch.nn.functional.conv2d(x.double(), w_bf.double(), stride=2,
                                     padding=3)
    assert float((conv.double() - ref).abs().max()) <= bf16_ulp(
        float(ref.abs().max()))
    torch.testing.assert_close(SK.stem_fwd(x, w, s, b), out, rtol=0, atol=0)
    got_out, got_conv = SK.stem_fwd_res(x, w, s, b)
    assert torch.equal(got_out, out) and torch.equal(got_conv, conv)


def test_function_grads_match_jax(jax_case):
    inputs, _, want = jax_case
    x, w, s, b = _port(*inputs[:4], grad=True)
    y = SK.stem_conv_bn_relu(x, w, s, b)
    assert y.dtype == torch.bfloat16
    g = torch.from_numpy(inputs[4]).permute(0, 3, 1, 2)
    (y.float() * g).sum().backward()
    assert w.grad.dtype == s.grad.dtype == b.grad.dtype == torch.float32
    got = [w.grad.permute(2, 3, 1, 0).numpy(), s.grad.numpy(), b.grad.numpy()]
    for name, gg, ref in zip(["dw", "dscale", "dbias"], got, want):
        err = float(np.abs(gg - ref).max())
        assert err <= GRAD_TOL * float(np.abs(ref).max()), (name, err)


def test_weight_grad_is_the_float32_sum_of_bf16_products():
    """stem_dw's plain version: bf16 patches times a bf16 cotangent summed
    in float32, against the same sum in float64."""
    x, w7, scale, bias, g = _inputs(1)
    xt = _port(x, w7, scale, bias)[0]
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous().bfloat16()
    dw = SK.stem_dw(xt, gt)
    assert dw.dtype == torch.float32
    ref = ts.stem_weight_grad(xt.double(), gt.double())
    assert float((dw - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _live_jax_body(seed=0):
    """JAX's stock ResNet-50 trunk with live frozen BNs (the init zeroes
    every bn3: the residual branches would be invisible)."""
    body = JaxBody("resnet50")
    params, state = body.init(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def live(tree):
        if "scale" in tree:
            n = tree["scale"].shape[0]
            return {"scale": (rng.rand(n) * 0.5 + 0.5).astype(np.float32),
                    "bias": (rng.randn(n) * 0.1).astype(np.float32)}
        return {k: live(v) if isinstance(v, dict) else np.asarray(v)
                for k, v in tree.items()}

    return body, live(params), state


def test_trunk_to_layer1_with_the_switch_on_matches_jitted_jax(monkeypatch):
    """The port's bf16 trunk to layer1 with HND_TPU_PALLAS_STEM=1 (the
    fused Function on its plain versions) against JAX's jitted bf16 trunk
    with the switch on (the Pallas stem in interpret mode), within twice
    JAX's own bf16-vs-float32 gap; the stem's launches counted by its
    Function."""
    body, params, state = _live_jax_body()
    x = _inputs(2)[0]
    monkeypatch.setenv("HND_TPU_PALLAS_STEM", "1")

    def layer1(p, s, xx):
        return body.apply(p, s, xx, upto=1)[0]["layer1"]

    run = jax.jit(layer1)
    j16 = np.asarray(run(params, state, jnp.asarray(x, jnp.bfloat16))
                     .astype(jnp.float32))
    j32 = np.asarray(run(params, state, jnp.asarray(x)))
    port = ResNetBody()
    port.load_state_dict(state_dict_from_jax(params, state))
    calls = []
    apply = SK.StemConvBnRelu.apply
    monkeypatch.setattr(SK.StemConvBnRelu, "apply",
                        lambda *a: calls.append(a[0].dtype) or apply(*a))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().bfloat16()
    port.conv1.weight.requires_grad_(True)
    y = port(xt, upto=1)["layer1"]
    assert calls == [torch.bfloat16] and y.dtype == torch.bfloat16
    got = y.detach().float().permute(0, 2, 3, 1).numpy()
    gap = float(np.abs(j16 - j32).max())
    assert gap > 0
    assert float(np.abs(got - j16).max()) <= 2.0 * gap
    assert os.environ["HND_TPU_PALLAS_STEM"] == "1"


class _OnCuda:
    """A stand-in with a CUDA device for the checks that run before a
    launch (there is no card here)."""

    def __init__(self, t):
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.dim = t.dtype, t.shape, t.dim

    def is_contiguous(self):
        return True


def test_kernels_take_float32_or_bfloat16_only():
    x = _port(*_inputs()[:4])[0]
    SK._check_input(_OnCuda(x))
    SK._check_input(_OnCuda(x.float()))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            SK._check_input(_OnCuda(x.to(dtype)))
