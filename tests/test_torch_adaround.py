"""Port parity for AdaRound's math (``quant/quantizers.py`` relaxation,
``quant/adaround.py``) against the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX per-layer optimizer runs jitted without XLA's backend optimizations
(``O0``, as tests/test_torch_qat.py does): its source's arithmetic, which
the port repeats in eager PyTorch.

Tolerances:
- the relaxation: equal bit for bit where no transcendental comes first
  (the hard decisions, ``floor``, the clamps, round-to-nearest); after
  one (sigmoid, log) within 1e-6 relative, with an absolute floor of
  1e-6 of the largest value (alphas near 0, soft levels near 0);
- ``temp_decay``: within 1e-6 relative at every sampled step;
- ``combined_loss``: the loss and its parts within rtol 1e-5; the
  gradient with respect to alpha (autograd against ``jax.grad``) within
  rtol 1e-4 with an absolute floor of 5e-5 of its largest entry (an
  entry sums 48 rows' products, each up to the largest entry's size, so
  an entry that cancels to a thousandth of it keeps fewer digits: 2e-3
  relative, 1.5e-5 of the largest, measured there);
- ``mse_grid_init``: the same chosen candidate, so the same scale bit for
  bit;
- ``optimize_layer_rounding`` over 50 iterations at lr 1e-2 with as many
  cached rows as the minibatch (the index draw only reorders rows), on
  targets off the float output (as the asymmetric mode's are): all but
  ``ALPHA_FAR_FRAC`` of the alphas within ``ALPHA_ATOL`` of JAX's (2.1%
  beyond it measured) and every one within ``ALPHA_MAX`` (0.0108
  measured: Adam divides a near-zero gradient entry by its own size, so
  where the two sums round apart its steps part by up to lr); hard
  decisions equal except where JAX's ``|alpha|`` is below ``ALPHA_EPS``
  (at most ``MAX_NEAR_ZERO`` such weights; 0 measured); the four local
  losses within rtol 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.quant import adaround as JAR
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu_torch.quant import adaround as TAR
from transformer_quantization_tpu_torch.quant import quantizers as TQ

torch.set_num_threads(2)

MODES = ("learned_sigmoid", "learned_hard_sigmoid", "sigmoid_temp_decay")
# (bits, symmetric, per-channel)
SPECS = {"w4-tensor": (4, True, False), "w4-channel": (4, True, True),
         "a3-tensor": (3, False, False)}
ALPHA_ATOL, ALPHA_FAR_FRAC, ALPHA_MAX = 1e-4, 0.03, 0.02
ALPHA_EPS, MAX_NEAR_ZERO = 0.02, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _x(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(want, got, rtol=1e-6, floor=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=floor * float(np.abs(want).max()))


def _eq(want, got):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


def _specs(name):
    bits, sym, per_channel = SPECS[name]
    m = "symmetric_uniform" if sym else "asymmetric_uniform"
    return (JQ.QuantizerSpec(n_bits=bits, method=JQ.QMethod[m]),
            TQ.QuantizerSpec(n_bits=bits, method=TQ.QMethod[m]), per_channel)


def _qps(jspec, w, per_channel):
    red = dict(axis=1) if per_channel else {}
    jqp = JQ.set_quant_range(jspec, jnp.min(w, **red), jnp.max(w, **red))
    tqp = TQ.QuantParams(delta=_t(jqp.delta), zero_float=_t(jqp.zero_float),
                         signed=_t(jqp.signed))
    return jqp, tqp


def _o0_jax():
    """The ``jax`` module with ``jit`` compiling at XLA backend
    optimization level 0."""
    ns = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                  if not k.startswith("__")})

    def jit(f=None, **kw):
        opts = dict(kw.pop("compiler_options", None) or {},
                    xla_backend_optimization_level=0)
        return jax.jit(f, compiler_options=opts, **kw)
    ns.jit = jit
    return ns


# ---------------------------------------------------------------------------
# the relaxation
# ---------------------------------------------------------------------------


def test_relaxation_functions_match_jax():
    p = np.concatenate([[0.0, 1.0, 1e-20, 0.5], np.random.RandomState(0)
                        .rand(500)]).astype(np.float32)
    a = _x(1, (500,), 4.0)
    _close(JQ.logit(jnp.asarray(p)), TQ.logit(_t(p)))
    _close(JQ.hard_sigmoid(jnp.asarray(a)), TQ.hard_sigmoid(_t(a)))
    q = p[p < 1.0]
    _close(JQ.hard_logit(jnp.asarray(q)), TQ.hard_logit(_t(q)))
    assert JQ.ZETA == TQ.ZETA and JQ.GAMMA == TQ.GAMMA
    assert ([m.name for m in JQ.AdaRoundMode]
            == [m.name for m in TQ.AdaRoundMode])


@pytest.mark.parametrize("mode", MODES)
def test_adaround_rest_matches_jax(mode):
    a = _x(2, (400,), 5.0)
    _close(JQ.adaround_rest(JQ.AdaRoundMode[mode], jnp.asarray(a), 20.0),
           TQ.adaround_rest(TQ.AdaRoundMode[mode], _t(a), 20.0))


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("mode", MODES)
def test_init_alpha_matches_jax(mode, spec):
    jspec, tspec, per_channel = _specs(spec)
    w = _x(3, (12, 40), 0.3)
    jqp, tqp = _qps(jspec, w, per_channel)
    want = JQ.adaround_init_alpha(JQ.AdaRoundMode[mode], jspec, jqp,
                                  jnp.asarray(w), temperature=20.0)
    got = TQ.adaround_init_alpha(TQ.AdaRoundMode[mode], tspec, tqp, _t(w),
                                 temperature=20.0)
    _close(want, got)


@pytest.mark.parametrize("soft", (True, False), ids=("soft", "hard"))
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("mode", ("nearest",) + MODES)
def test_adaround_fake_quant_matches_jax(mode, spec, soft):
    jspec, tspec, per_channel = _specs(spec)
    w = _x(4, (12, 40), 0.3)
    jqp, tqp = _qps(jspec, w, per_channel)
    alpha = _x(5, (12, 40), 3.0)
    alpha[0, :8] = 0.0  # hard decision's tie: alpha >= 0 rounds up
    want = JQ.adaround_fake_quant(JQ.AdaRoundMode[mode], jspec, jqp,
                                  jnp.asarray(w), jnp.asarray(alpha), soft,
                                  temperature=7.0)
    got = TQ.adaround_fake_quant(TQ.AdaRoundMode[mode], tspec, tqp, _t(w),
                                 _t(alpha), soft, temperature=7.0)
    if soft and mode != "nearest":
        _close(want, got)
    else:
        _eq(want, got)


# ---------------------------------------------------------------------------
# temperature schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [k.name for k in JAR.AdaRoundTempDecayType])
def test_temp_decay_matches_jax(kind):
    kw = dict(iters=100, annealing=(20.0, 2.0), warmup=0.2, decay_start=0.1,
              decay_shape=3.0)
    jcfg = JAR.AdaRoundConfig(decay_type=JAR.AdaRoundTempDecayType[kind],
                              **kw)
    tcfg = TAR.AdaRoundConfig(decay_type=TAR.AdaRoundTempDecayType[kind],
                              **kw)
    ts = np.concatenate([np.arange(0, 101), np.linspace(0, 100, 37)])
    want = np.array([float(JAR.temp_decay(jnp.float32(t), jcfg))
                     for t in ts], np.float32)
    got = np.array([TAR.temp_decay(t, tcfg) for t in ts], np.float32)
    _close(want, got)
    assert got[0] == 20.0 and abs(got[-1] - 2.0) < 1e-4


# ---------------------------------------------------------------------------
# the loss and its gradient
# ---------------------------------------------------------------------------


def _linear_pair(b):
    def jap(w_q, x):
        return jax.nn.gelu(jnp.einsum("...i,oi->...o", x, w_q) + b,
                           approximate=False)

    tb = _t(b)

    def tap(w_q, x):
        y = torch.matmul(x, w_q.transpose(0, 1)) + tb
        return 0.5 * y * torch.special.erfc(-y * float(np.float32(
            np.sqrt(0.5))))
    return jap, tap


@pytest.mark.parametrize("t", (5, 60), ids=("warmup", "regularized"))
@pytest.mark.parametrize("mode", MODES)
def test_combined_loss_and_gradient_match_jax(mode, t):
    jspec, tspec, _ = _specs("w4-channel")
    w, b = _x(6, (16, 24), 0.3), _x(7, (16,), 0.1)
    x = _x(8, (8, 6, 24))
    jqp, tqp = _qps(jspec, w, True)
    kw = dict(iters=100, round_mode=JQ.AdaRoundMode[mode])
    jcfg = JAR.AdaRoundConfig(**kw)
    tcfg = TAR.AdaRoundConfig(**dict(kw, round_mode=TQ.AdaRoundMode[mode]))
    jap, tap = _linear_pair(b)
    tgt = np.asarray(jap(jnp.asarray(w), jnp.asarray(x))) + _x(9, (8, 6, 16),
                                                               0.01)
    alpha = np.asarray(JQ.adaround_init_alpha(
        JQ.AdaRoundMode[mode], jspec, jqp, jnp.asarray(w), axis=0,
        temperature=20.0)) + _x(10, (16, 24), 0.3)
    temp = (float(JAR.temp_decay(jnp.float32(t), jcfg))
            if mode == "sigmoid_temp_decay" else 20.0)

    def jloss(a):
        w_q = JQ.adaround_fake_quant(JQ.AdaRoundMode[mode], jspec, jqp,
                                     jnp.asarray(w), a, True, axis=0,
                                     temperature=temp)
        return JAR.combined_loss(jap(w_q, jnp.asarray(x)), jnp.asarray(tgt),
                                 a, jnp.float32(t), jcfg, temperature=20.0)

    jparts = jloss(jnp.asarray(alpha))
    jgrad = jax.grad(lambda a: jloss(a)[0])(jnp.asarray(alpha))
    a = _t(alpha).requires_grad_(True)
    w_q = TQ.adaround_fake_quant(TQ.AdaRoundMode[mode], tspec, tqp, _t(w), a,
                                 True, axis=0, temperature=temp)
    tparts = TAR.combined_loss(tap(w_q, _t(x)), _t(tgt), a, t, tcfg,
                               temperature=20.0)
    g, = torch.autograd.grad(tparts[0], a)
    for want, got in zip(jparts, tparts):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
    _close(jgrad, g, rtol=1e-4, floor=5e-5)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0


# ---------------------------------------------------------------------------
# grid init
# ---------------------------------------------------------------------------


def _outlier_weight(seed, shape):
    w = _x(seed, (int(np.prod(shape)),), 0.05)
    w[:2] = (1.0, -0.9)
    return w.reshape(shape)


@pytest.mark.parametrize("spec", ("w4-tensor", "a3-tensor"))
def test_mse_grid_init_matches_jax(spec):
    """A weight with two outliers (4-bit symmetric) and a LayerNorm-like
    gamma near 1 (3-bit asymmetric)."""
    jspec, tspec, _ = _specs(spec)
    w = (_outlier_weight(11, (100, 10)) if spec == "w4-tensor"
         else _x(12, (768,), 0.02) + 1.0)
    jqp = JAR.mse_grid_init(jspec, jnp.asarray(w))
    tqp = TAR.mse_grid_init(tspec, _t(w))
    _eq(jqp.delta, tqp.delta)
    _eq(jqp.zero_float, tqp.zero_float)


def test_mse_grid_init_on_a_layer_loss_matches_jax():
    jspec, tspec, _ = _specs("w4-tensor")
    w, b = _outlier_weight(13, (16, 24)), _x(14, (16,), 0.1)
    x = _x(15, (8, 6, 24))
    jap, tap = _linear_pair(b)
    jout = jap(jnp.asarray(w), jnp.asarray(x))
    tout = tap(_t(w), _t(x))

    def jloss(qp):
        return jnp.mean((jap(JQ.fake_quant(jspec, qp, jnp.asarray(w)),
                             jnp.asarray(x)) - jout) ** 2)

    def tloss(qp):
        return torch.mean((tap(TQ.fake_quant(tspec, qp, _t(w)), _t(x))
                           - tout) ** 2)

    jqp = JAR.mse_grid_init(jspec, jnp.asarray(w), loss_fn=jloss)
    tqp = TAR.mse_grid_init(tspec, _t(w), loss_fn=tloss)
    _eq(jqp.delta, tqp.delta)
    # the search moved off absmax: the candidate is not the first
    assert float(tqp.delta) < float(TQ.set_quant_range(
        tspec, -_t(w).abs().max(), _t(w).abs().max()).delta)


# ---------------------------------------------------------------------------
# the per-layer optimizer
# ---------------------------------------------------------------------------


OPT_CASES = {"hard-tensor": ("learned_hard_sigmoid", False),
             "hard-channel": ("learned_hard_sigmoid", True),
             "temp-decay-tensor": ("sigmoid_temp_decay", False)}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimize_layer_rounding_matches_jax(case, monkeypatch):
    mode, per_channel = OPT_CASES[case]
    monkeypatch.setattr(JAR, "jax", _o0_jax())
    jspec, tspec, _ = _specs("w4-tensor")
    w, b = _x(16, (16, 24), 0.3), _x(17, (16,), 0.1)
    x = _x(18, (16, 6, 24))
    jqp, tqp = _qps(jspec, w, per_channel)
    jap, tap = _linear_pair(b)
    # targets off the float layer's output, as the asymmetric mode's are:
    # at the float output the soft weight's start reproduces them to the
    # last bits, and Adam would step on the rounding of a zero gradient
    out = np.asarray(jap(jnp.asarray(w), jnp.asarray(x))) + _x(19, (
        16, 6, 16), 0.05)
    kw = dict(iters=50, batch_size=16, lr=1e-2)
    jalpha, jstats = JAR.optimize_layer_rounding(
        jap, jspec, jqp, jnp.asarray(w), jnp.asarray(x), jnp.asarray(out),
        JAR.AdaRoundConfig(round_mode=JQ.AdaRoundMode[mode], **kw), seed=3)
    talpha, tstats = TAR.optimize_layer_rounding(
        tap, tspec, tqp, _t(w), _t(x), _t(out),
        TAR.AdaRoundConfig(round_mode=TQ.AdaRoundMode[mode], **kw), seed=3)
    jalpha = np.asarray(jalpha)
    a0 = np.asarray(JQ.adaround_init_alpha(
        JQ.AdaRoundMode[mode], jspec, jqp, jnp.asarray(w),
        axis=0 if per_channel else None, temperature=20.0))
    assert np.abs(jalpha - a0).max() > 0.1  # the optimizer moved alpha
    diff = np.abs(talpha.numpy() - jalpha)
    near = np.abs(jalpha) < ALPHA_EPS
    flips = (talpha.numpy() >= 0) != (jalpha >= 0)
    assert (diff > ALPHA_ATOL).mean() <= ALPHA_FAR_FRAC
    assert diff.max() <= ALPHA_MAX
    assert near.sum() <= MAX_NEAR_ZERO
    assert not flips[~near].any()
    for k, v in jstats.items():
        np.testing.assert_allclose(tstats[k], v, rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# the w4-adaround preset
# ---------------------------------------------------------------------------


def test_w4_adaround_preset_copies_the_cli():
    """``ADAROUND_RECIPES["w4-adaround"]`` against the JAX CLI's
    ``--recipe w4-adaround`` as its ``validate-quantized`` command builds
    the site defaults and the AdaRound config."""
    from transformer_quantization_tpu import cli as JCLI
    from transformer_quantization_tpu_torch.training import calibration as TC

    args = JCLI.build_parser().parse_args(
        ["validate-quantized", "--recipe", "w4-adaround"])
    JCLI.apply_recipe(args)
    rec, cfg = TC.ADAROUND_RECIPES["w4-adaround"]
    jd = JCLI.make_quant_defaults(args)
    for f in ("method", "act_method", "n_bits", "n_bits_act",
              "per_channel_weights", "percentile", "weight_range_method",
              "weight_range_opt", "weight_num_candidates",
              "act_range_method", "act_range_opt", "act_momentum",
              "act_num_candidates", "scale_domain"):
        j, t = getattr(jd, f), getattr(rec.defaults, f)
        assert (t.name if hasattr(t, "name") else t) == (
            j.name if hasattr(j, "name") else j), f
    assert rec.act_quant is not args.no_act_quant
    assert rec.quant_setup == args.quant_setup and not rec.quant_dict
    assert rec.est_batch_size == args.est_ranges_batch_size
    assert rec.est_pad is args.est_ranges_pad is False
    assert cfg.layers == tuple(args.adaround)
    assert cfg.annealing == tuple(float(x) for x in
                                  args.adaround_annealing.split(","))
    for f, a in (("num_samples", "adaround_num_samples"),
                 ("asym", "adaround_asym"),
                 ("include_act_func", "adaround_include_act_func"),
                 ("lr", "adaround_lr"), ("iters", "adaround_iters"),
                 ("weight", "adaround_weight"),
                 ("decay_shape", "adaround_decay_shape"),
                 ("decay_start", "adaround_decay_start"),
                 ("warmup", "adaround_warmup"), ("batch_size", "batch_size")):
        assert getattr(cfg, f) == getattr(args, a), f
    for f, a in (("init", "adaround_init"), ("round_mode", "adaround_mode"),
                 ("decay_type", "adaround_decay_type"),
                 ("act_quant_mode", "adaround_act_quant_mode")):
        assert getattr(cfg, f).name == getattr(args, a), f
