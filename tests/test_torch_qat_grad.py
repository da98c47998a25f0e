"""The port's fake-quant backward (``quant/quantizers.py`` ``FakeQuant``)
against the JAX package's ``fake_quant`` custom VJP (``_fq_bwd``), by
``jax.vjp``.

Cases: symmetric and asymmetric grids of 4 and 8 bits, per tensor, per
channel (a weight's dim 0) and per act axis 2, in the linear and the log
scale domain; the ranges cut the data at both ends, per-channel linear
deltas hold one entry at ``eps`` and one below it, asymmetric per-channel
zero points hold one below the grid and one above it; a bf16 input.
Inputs are made with numpy from a seed.

Tolerances: ``g_x`` bit for bit, and the forward in the linear domain
(in the log domain within rtol 1e-6: the scale is ``exp(delta)``, whose
PyTorch and XLA values differ by ulps); the reduced range
gradients (sums over the reduced dims, in another order than XLA's)
within rtol 1e-5, with an absolute floor of 1e-6 of the tensor's largest
gradient for entries that cancel to near zero.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu_torch.quant import quantizers as TQ

torch.set_num_threads(2)

EPS = 1e-8
# granularity -> (data shape, channel axis of the params or None, axis arg)
GRAINS = {"tensor": ((4, 6, 16), None, None),
          "channel": ((8, 24), 0, None),
          "axis2": ((4, 6, 8), 2, 2)}
CASES = list(itertools.product(("sym", "asym"), (4, 8), sorted(GRAINS),
                               ("linear", "log")))


def _specs(method, bits, domain):
    m = "symmetric_uniform" if method == "sym" else "asymmetric_uniform"
    return (JQ.QuantizerSpec(n_bits=bits, method=JQ.QMethod[m],
                             scale_domain=domain),
            TQ.QuantizerSpec(n_bits=bits, method=TQ.QMethod[m],
                             scale_domain=domain))


def _case(method, bits, grain, domain, seed=0):
    """(x, g, delta, zero_float, signed, axis) as numpy."""
    shape, ch, axis = GRAINS[grain]
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    jspec, _ = _specs(method, bits, domain)
    if ch is None:
        lo, hi = np.float32(-1.5), np.float32(1.0)
    else:
        red = tuple(d for d in range(len(shape)) if d != ch)
        lo = (0.6 * x.min(axis=red)).astype(np.float32)
        hi = (0.5 * x.max(axis=red)).astype(np.float32)
    qp = JQ.set_quant_range(jspec, jnp.asarray(lo), jnp.asarray(hi))
    delta = np.array(qp.delta, np.float32)
    zero = np.array(qp.zero_float, np.float32)
    if ch is not None and domain == "linear":
        delta[0], delta[1] = EPS, EPS / 2   # at eps and below it
    if ch is not None and method == "asym":
        zero[2], zero[3] = -2.6, 2.0 ** bits + 40.0  # off the grid
    return x, g, delta, zero, np.array(qp.signed, np.float32), axis


def _jax_vjp(jspec, x, g, delta, zero, signed, axis):
    qp = JQ.QuantParams(delta=jnp.asarray(delta), zero_float=jnp.asarray(zero),
                        signed=jnp.asarray(signed))
    y, vjp = jax.vjp(lambda q, v: JQ.fake_quant(jspec, q, v, axis=axis),
                     qp, jnp.asarray(x))
    g_qp, g_x = vjp(jnp.asarray(g, y.dtype))
    return (np.asarray(y), np.asarray(g_x), np.asarray(g_qp.delta),
            np.asarray(g_qp.zero_float))


def _port_grads(tspec, x, g, delta, zero, signed, axis):
    d = torch.tensor(delta, requires_grad=True)
    z = torch.tensor(zero, requires_grad=True)
    xt = x.clone().requires_grad_(True) if isinstance(x, torch.Tensor) \
        else torch.tensor(x, requires_grad=True)
    qp = TQ.QuantParams(delta=d, zero_float=z, signed=torch.tensor(signed))
    y = TQ.fake_quant(tspec, qp, xt, axis=axis)
    y.backward(torch.as_tensor(g).to(y.dtype))
    return y.detach(), xt.grad, d.grad, z.grad


def _close(got, want, what):
    got = got.numpy()
    floor = 1e-6 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=floor,
                               err_msg=what)


@pytest.mark.parametrize("method,bits,grain,domain", CASES)
def test_fake_quant_backward_matches_jax_vjp(method, bits, grain, domain):
    x, g, delta, zero, signed, axis = _case(method, bits, grain, domain)
    jspec, tspec = _specs(method, bits, domain)
    jy, jgx, jgd, jgz = _jax_vjp(jspec, x, g, delta, zero, signed, axis)
    ty, tgx, tgd, tgz = _port_grads(tspec, x, g, delta, zero, signed, axis)
    if domain == "linear":
        np.testing.assert_array_equal(ty.numpy(), jy)
    else:  # the scale is exp(delta): PyTorch's and XLA's exp differ by ulps
        np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6)
    np.testing.assert_array_equal(tgx.numpy(), jgx)
    # the grid cuts the data at both ends: both STE branches run
    assert 0 < (jgx == 0).mean() < 1
    assert tgd.shape == delta.shape and tgz.shape == zero.shape
    _close(tgd, jgd, "g_delta")
    if method == "sym":
        assert not tgz.any() and not jgz.any()
    else:
        _close(tgz, jgz, "g_zero_float")
        assert np.abs(jgz).max() > 0
    if GRAINS[grain][1] is not None and domain == "linear":
        # below eps the clamp passes no gradient; at eps it does
        assert tgd[1] == 0 and jgd[1] == 0
        assert jgd[0] != 0


@pytest.mark.parametrize("method", ["sym", "asym"])
def test_bf16_input_gives_its_gradient_in_bf16(method):
    x, g, delta, zero, signed, axis = _case(method, 8, "tensor", "linear")
    jspec, tspec = _specs(method, 8, "linear")
    xb = jnp.asarray(x, jnp.bfloat16)
    jy, jgx, jgd, _ = _jax_vjp(jspec, xb, g, delta, zero, signed, axis)
    ty, tgx, tgd, _ = _port_grads(
        tspec, torch.tensor(x).to(torch.bfloat16), g, delta, zero, signed,
        axis)
    assert ty.dtype == tgx.dtype == torch.bfloat16
    np.testing.assert_array_equal(ty.float().numpy(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(tgx.float().numpy(),
                                  np.asarray(jgx, np.float32))
    _close(tgd, jgd, "g_delta")


def test_no_graph_without_gradients():
    """Calibration and inference (no tensor wants a gradient, or under
    ``torch.no_grad``) take the plain forward: same bits, no graph."""
    x, _, delta, zero, signed, _ = _case("asym", 8, "tensor", "linear")
    _, tspec = _specs("asym", 8, "linear")
    qp = TQ.QuantParams(delta=torch.tensor(delta), zero_float=torch.tensor(
        zero), signed=torch.tensor(signed))
    plain = TQ.fake_quant(tspec, qp, torch.tensor(x))
    assert plain.grad_fn is None
    xg = torch.tensor(x, requires_grad=True)
    with torch.no_grad():
        assert TQ.fake_quant(tspec, qp, xg).grad_fn is None
    live = TQ.fake_quant(tspec, qp, xg)
    assert isinstance(live.grad_fn, torch.autograd.function.BackwardCFunction)
    assert torch.equal(live.detach(), plain)
    # set_quant_range's params never carry a graph (JAX's stop_gradient)
    lo = torch.tensor(-1.0, requires_grad=True)
    out = TQ.set_quant_range(tspec, lo, torch.tensor(2.0))
    assert not out.delta.requires_grad and not out.zero_float.requires_grad
