"""Port parity for the range estimators: the min-max family, percentile,
the MSE grids and golden-section searches, and cross-entropy, against the
JAX package's on the same numpy inputs from a seed (the cases of
tests/test_ranges.py, plus the quirks the port keeps).

Tolerances:
- current / all / running minmax and percentile: rtol 1e-6;
- ``golden_section_minimize`` on losses both sides compute exactly (a
  quadratic, a step function from a table): bit-equal;
- MSE grids: the chosen candidate index equals JAX's unless JAX's two
  smallest accumulated losses lie within 1e-6 relative of each other
  (then either passes); the thresholds then bit-equal;
- MSE golden section: within rtol 1e-5 of JAX's range; where not (the
  searches part at a near-tie of two float32 loss sums), the loss at the
  port's range, evaluated in float64, is at most 1e-6 relative above the
  loss at JAX's range, and the site is printed. Where neither holds, the
  cause must be the one found for the nested asymmetric search: XLA's CPU
  code fuses some of JAX's bracket updates ``hi - c * (hi - lo)`` into a
  fused multiply-add (one rounding), the inner shift search ends on a
  zero point's rounding edge, and one ulp of a bracket moves it across.
  The port rounds each operation; the test reruns the port's search with
  the fused form (emulated in float64) and holds that run to the rules
  above, printing the site.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant import ranges as JR
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant import ranges as TR

torch.set_num_threads(2)

GRID_TIE, GOLDEN_RTOL, GOLDEN_LOSS_TOL = 1e-6, 1e-5, 1e-6


def _specs(n_bits, method):
    return (JQ.QuantizerSpec(n_bits, JQ.QMethod[method]),
            TQ.QuantizerSpec(n_bits, TQ.QMethod[method]))


def _cfgs(method, **kw):
    """The same estimator config in both packages."""
    jkw = {k: JR.OptMethod[v.name] if isinstance(v, TR.OptMethod) else v
           for k, v in kw.items()}
    return (JR.RangeEstimatorConfig(method=JR.RangeMethod[method], **jkw),
            TR.RangeEstimatorConfig(method=TR.RangeMethod[method], **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The MSE tolerance (shared with tests/test_torch_calibration.py)
# ---------------------------------------------------------------------------


def range_loss64(spec: TQ.QuantizerSpec, x: np.ndarray, xmin, xmax,
                 cross_entropy: bool = False) -> float:
    """The estimator's objective at one per-tensor range, in float64 (the
    fake-quant grid is the float32 one both packages share)."""
    qp = TQ.set_quant_range(spec, _t(np.float32(xmin)), _t(np.float32(xmax)))
    y = TQ.fake_quant(spec, qp, _t(x)).double().numpy()
    x = x.astype(np.float64)
    if not cross_entropy:
        return float(np.sum((x - y) ** 2))
    logq = y - y.max(1, keepdims=True)
    logq = logq - np.log(np.exp(logq).sum(1, keepdims=True))
    p = np.exp(x - x.max(1, keepdims=True))
    p = p / p.sum(1, keepdims=True)
    return float(np.sum(-p * logq))


def _fused_points(lo, hi):
    """The golden section's interior points as XLA's CPU code computes
    them where it fuses the update into a multiply-add: the product and
    the sum rounded once (in float64, then to float32)."""
    inv = float(TR._INVPHI)
    diff = (hi - lo).double()
    return ((hi.double() - inv * diff).float(),
            (lo.double() + inv * diff).float())


@contextlib.contextmanager
def fused_golden_points():
    """Run the port's golden-section searches with ``_fused_points``."""
    real = TR._golden_points
    TR._golden_points = _fused_points
    try:
        yield
    finally:
        TR._golden_points = real


def _golden_losses(spec, row, j, t, cross_entropy):
    """None where the two ranges agree within rtol 1e-5, else the float64
    losses at JAX's and at the port's range."""
    if all(abs(b - a) <= GOLDEN_RTOL * abs(a) for a, b in zip(j, t)):
        return None
    return (range_loss64(spec, row, *j, cross_entropy),
            range_loss64(spec, row, *t, cross_entropy))


def assert_golden_close(name, spec, x, j_range, t_range, per_channel,
                        cross_entropy=False, rerun=None) -> None:
    """A golden-section range against JAX's under the rules above;
    ``rerun()`` gives the port's range from a search with XLA's fused
    bracket updates. Each problem (the tensor or a channel) that is not
    within rtol 1e-5 is printed with the rule that took it."""
    def rows_of(r):
        return list(zip(*(np.atleast_1d(np.asarray(v, np.float64))
                          for v in r)))

    jr, tr = rows_of(j_range), rows_of(t_range)
    rows = x if per_channel else x[None]
    fused = None
    for c in range(len(jr)):
        losses = _golden_losses(spec, rows[c], jr[c], tr[c], cross_entropy)
        if losses is None:
            continue
        lj, lt = losses
        site = (f"{name}[{c}]: JAX range {jr[c]!r} loss {lj!r}, port range "
                f"{tr[c]!r} loss {lt!r}")
        if lt <= lj * (1 + GOLDEN_LOSS_TOL):
            print(f"golden-section near-tie at {site}")
            continue
        assert rerun is not None, site
        if fused is None:
            fused = rows_of(rerun())
        again = _golden_losses(spec, rows[c], jr[c], fused[c],
                               cross_entropy)
        print(f"golden-section parts on XLA's fused brackets at {site}; "
              f"with the fused form the port's range is {fused[c]!r}"
              + ("" if again is None else f", loss {again[1]!r}"))
        assert again is None or again[1] <= again[0] * (
            1 + GOLDEN_LOSS_TOL), site


def assert_grid_close(name, j_est, t_est) -> None:
    """A grid search against JAX's: the same argmin per channel (or a JAX
    near-tie), then bit-equal thresholds."""
    jl = j_est.loss_array.reshape(j_est.loss_array.shape[0], -1)
    tl = t_est.loss_array.reshape(jl.shape[0], -1).numpy()
    jm, jM = (np.atleast_1d(np.asarray(v)) for v in j_est.finalize())
    tm, tM = (np.atleast_1d(v.numpy()) for v in t_est.finalize())
    for c in range(jl.shape[0]):
        ji, ti = int(np.argmin(jl[c])), int(np.argmin(tl[c]))
        if ji != ti:
            a, b = np.sort(jl[c])[:2]
            print(f"grid near-tie at {name}[{c}]: JAX candidate {ji}, port "
                  f"{ti}; JAX's two smallest losses {a!r}, {b!r}")
            assert b - a <= GRID_TIE * abs(a), (name, c, ji, ti, a, b)
            continue
        assert (jm[c], jM[c]) == (tm[c], tM[c]), (name, c)


# ---------------------------------------------------------------------------
# Min-max family and percentile
# ---------------------------------------------------------------------------

REDUCE = {
    "tensor": (dict(), ()),
    "channel": (dict(per_channel=True), (6,)),
    "axis2": (dict(axis=2), (8,)),
    "groups": (dict(axis=2, n_groups=4), (8,)),
    "groups-perm": (dict(axis=2, n_groups=2, permute=True), (8,)),
}


def _batches(n, seed=0, shape=(6, 5, 8)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * rng.uniform(0.5, 3) + rng.randn())
            .astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("rs", sorted(REDUCE))
@pytest.mark.parametrize("method", ["current_minmax", "allminmax",
                                    "running_minmax"])
def test_min_max_family_matches_jax(method, rs):
    """Three batches through each estimator; allminmax ignores the axis
    and groups (per-tensor, broadcast to the state), running_minmax drops
    the permutation and its first batch sets the state."""
    kw, shape = REDUCE[rs]
    jc, tc = _cfgs(method, momentum=0.8)
    perm = (np.random.RandomState(9).permutation(8).astype(np.int32)
            if kw.get("permute") else None)
    jst, tst = JR.init_range_state(shape), TR.init_range_state(shape)
    for x in _batches(3):
        jst = JR.update_range_state(
            jst, jnp.asarray(x), jc, JR.ReduceSpec(**kw),
            perm=None if perm is None else jnp.asarray(perm))
        tst = TR.update_range_state(tst, _t(x), tc, TR.ReduceSpec(**kw),
                                    perm=None if perm is None else _t(perm))
    for j, t in zip(JR.finalize_ranges(jst), TR.finalize_ranges(tst)):
        assert t.shape == np.shape(j)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    assert bool(tst["initialized"])


@pytest.mark.parametrize("per_channel", [False, True],
                         ids=["tensor", "channel"])
@pytest.mark.parametrize("p", [0.01, 1.0, 12.5, 49.9])
def test_percentile_matches_jax(p, per_channel):
    """Per-tensor ``(p, 100)`` of shape (1,), per-channel ``(p, 100-p)``,
    both with jnp.percentile's linear interpolation."""
    x = _batches(1, seed=2, shape=(7, 33, 9))[0]
    rs = dict(per_channel=per_channel)
    want = JR.reduce_min_max(jnp.asarray(x), JR.ReduceSpec(**rs), p)
    got = TR.reduce_min_max(_t(x), TR.ReduceSpec(**rs), p)
    for j, t in zip(want, got):
        assert t.shape == np.shape(j)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    # the current-minmax estimator carries it into its (1,) / (C,) state
    jc, tc = _cfgs("current_minmax", percentile=p)
    shape = (7,) if per_channel else (1,)
    jst = JR.update_range_state(JR.init_range_state(shape), jnp.asarray(x),
                                jc, JR.ReduceSpec(**rs))
    tst = TR.update_range_state(TR.init_range_state(shape), _t(x), tc,
                                TR.ReduceSpec(**rs))
    for j, t in zip(JR.finalize_ranges(jst), TR.finalize_ranges(tst)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_percentile_past_torch_quantile_limit():
    """More than 2^24 elements (``torch.quantile`` refuses them): the
    order statistics and interpolation of numpy's linear percentile."""
    n = (1 << 24) + 4097
    x = np.random.RandomState(3).standard_normal(n).astype(np.float32)
    lo, hi = TR.reduce_min_max(_t(x), TR.ReduceSpec(), 0.1)
    np.testing.assert_allclose(lo.numpy(), [np.percentile(x, 0.1)],
                               rtol=1e-6)
    assert hi.numpy()[0] == x.max()


# ---------------------------------------------------------------------------
# Golden-section search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("center", [2.5, 0.3, 7.77, 9.999])
def test_golden_section_bit_equal_on_a_quadratic(center):
    want = JR.golden_section_minimize(lambda t: (t - center) ** 2, 0.0, 10.0)
    got = TR.golden_section_minimize(lambda t: (t - center) ** 2, 0.0, 10.0)
    assert got.numpy() == np.asarray(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_golden_section_bit_equal_on_a_step_table(seed):
    """A step function given as a float64 table (float32 on both sides,
    as JAX holds it with x64 off), over a bracket that is not [0, 1]."""
    table = np.random.RandomState(seed).rand(1000)
    jt, tt = jnp.asarray(table), _t(table.astype(np.float32))

    def j_fn(t):
        return jt[jnp.clip((t * 100).astype(jnp.int32), 0, 999)]

    def t_fn(t):
        return tt[torch.clamp((t * 100).to(torch.int32), 0, 999).long()]

    for lo, hi, iters in ((0.0, 9.99, 64), (1.25, 7.5, 48)):
        want = JR.golden_section_minimize(j_fn, lo, hi, num_iters=iters)
        got = TR.golden_section_minimize(t_fn, lo, hi, num_iters=iters)
        assert got.numpy() == np.asarray(want)


def test_golden_section_batched_like_vmap():
    """One bracket per problem, as JAX's vmap over channels."""
    centers = np.asarray([1.0, 2.0, 3.0, 0.1], np.float32)
    want = jax.vmap(lambda c: JR.golden_section_minimize(
        lambda t: (t - c) ** 2, 0.0, 10.0))(jnp.asarray(centers))
    ct = _t(centers)
    got = TR.golden_section_minimize(lambda t: (t - ct) ** 2,
                                     torch.zeros(4), torch.full((4,), 10.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# MSE and cross-entropy
# ---------------------------------------------------------------------------


def _data(kind):
    rng = np.random.RandomState({"tails": 0, "uniform": 0, "shifted": 0,
                                 "normal": 3, "offset": 4, "weight": 7,
                                 "logits": 6, "channels": 1}[kind])
    if kind == "tails":  # two outliers in a narrow normal
        x = np.concatenate([rng.normal(0, 0.1, 10000), [1.0, -1.0]])
    elif kind == "uniform":  # one-sided
        x = rng.uniform(0, 1, 1000)
    elif kind == "shifted":
        x = rng.normal(1.0, 0.5, (64, 16))
    elif kind == "normal":
        x = rng.normal(0, 1.0, 4096)
    elif kind == "offset":
        x = rng.normal(2.0, 1.0, 4096)
    elif kind == "weight":  # a linear layer's weight, rows of one scale
        x = rng.randn(24, 96) * rng.uniform(0.01, 0.1, (24, 1))
    elif kind == "logits":
        x = rng.normal(0, 3, (32, 2))
    else:  # two channels ~100x apart
        x = np.stack([np.linspace(-0.1, 0.1, 100),
                      np.linspace(-10.0, 10.0, 100)])
    return x.astype(np.float32)


# (data, bits, method, per_channel, method, estimator options)
MSE_CASES = {
    "grid-sym-tails": ("tails", 4, "symmetric_uniform", False, "MSE",
                       dict(num_candidates=100)),
    "grid-one-sided": ("uniform", 8, "asymmetric_uniform", False, "MSE", {}),
    "grid-2d-asym": ("shifted", 4, "asymmetric_uniform", False, "MSE",
                     dict(num_candidates=20)),
    "grid-sym-200": ("normal", 8, "symmetric_uniform", False, "MSE",
                     dict(num_candidates=200)),
    "grid-channel": ("channels", 8, "symmetric_uniform", True, "MSE",
                     dict(num_candidates=50)),
    "grid-2d-channel": ("weight", 4, "asymmetric_uniform", True, "MSE",
                        dict(num_candidates=20)),
    "golden-sym": ("normal", 8, "symmetric_uniform", False, "MSE", {}),
    "golden-asym": ("offset", 8, "asymmetric_uniform", False, "MSE", {}),
    "golden-one-sided": ("uniform", 8, "asymmetric_uniform", False, "MSE",
                         {}),
    "golden-channel": ("weight", 8, "symmetric_uniform", True, "MSE", {}),
    "golden-asym-channel": ("weight", 8, "asymmetric_uniform", True, "MSE",
                            {}),
    "grid-ce": ("logits", 8, "asymmetric_uniform", False, "cross_entropy",
                dict(num_candidates=50)),
    "golden-ce": ("logits", 8, "asymmetric_uniform", False, "cross_entropy",
                  {}),
}


def _estimators(case):
    data, bits, qmethod, per_channel, method, kw = MSE_CASES[case]
    js, ts = _specs(bits, qmethod)
    opt = (TR.OptMethod.golden_section if case.startswith("golden")
           else TR.OptMethod.grid)
    jc, tc = _cfgs(method, opt_method=opt, **kw)
    ce = method == "cross_entropy"
    return (JR.MSERangeEstimator(js, jc, per_channel=per_channel,
                                 cross_entropy=ce),
            TR.MSERangeEstimator(ts, tc, per_channel=per_channel,
                                 cross_entropy=ce),
            _data(data), ts, per_channel, ce)


@pytest.mark.parametrize("case", sorted(MSE_CASES))
def test_mse_estimators_match_jax(case):
    je, te, x, ts, per_channel, ce = _estimators(case)
    je.update(jnp.asarray(x))
    te.update(_t(x))
    assert te.one_sided == je.one_sided
    for f in ("max_pos_thr", "max_neg_thr", "max_search_range"):
        assert getattr(te, f) == getattr(je, f), f
    got = te.finalize()
    want = je.finalize()
    for j, t in zip(want, got):
        assert t.shape == np.shape(j) and t.dtype == torch.float32
    if case.startswith("grid"):
        assert te.loss_array.dtype == torch.float64
        assert te.loss_array.shape == je.loss_array.shape
        assert np.isinf(te.loss_array[:, 0].numpy()).all()
        assert_grid_close(case, je, te)
    else:
        def rerun():
            with fused_golden_points():
                fresh = _estimators(case)[1]
                fresh.update(_t(x))
                return [v.numpy() for v in fresh.finalize()]

        assert_golden_close(case, ts, x, want, [v.numpy() for v in got],
                            per_channel, ce, rerun)


@pytest.mark.parametrize("case", ["grid-sym-200", "grid-2d-asym",
                                  "golden-sym"])
def test_mse_second_batch(case):
    """Grid losses accumulate across batches; golden section re-solves on
    each batch and the last batch wins."""
    je, te, x, ts, per_channel, ce = _estimators(case)
    x2 = (x * 1.5 + 0.1).astype(np.float32)
    for b in (x, x2):
        je.update(jnp.asarray(b))
        te.update(_t(b))
    if case.startswith("grid"):
        assert_grid_close(case, je, te)
    else:
        assert_golden_close(case, ts, x2, je.finalize(),
                            [v.numpy() for v in te.finalize()], per_channel)


def test_grid_losses_do_not_depend_on_the_chunking(monkeypatch):
    """A candidate's loss is the same whatever the chunk size (2-D grid:
    20 x 64 x 2 candidates; chunks of 1, 7 and all)."""
    x = _data("shifted")
    ts = TQ.QuantizerSpec(8, TQ.QMethod.asymmetric_uniform)
    tc = TR.RangeEstimatorConfig(method=TR.RangeMethod.MSE,
                                 num_candidates=20)
    arrays = []
    for chunk in (x.size, 7 * x.size, 1 << 24):
        monkeypatch.setattr(TR, "CHUNK_ELEMENTS", chunk)
        te = TR.MSERangeEstimator(ts, tc)
        te.update(_t(x))
        arrays.append(te.loss_array)
    for a in arrays[1:]:
        assert torch.equal(a, arrays[0])


def test_make_estimator_routes_methods():
    js, ts = _specs(8, "symmetric_uniform")
    for m in ("MSE", "cross_entropy"):
        est = TR.make_estimator(ts, _cfgs(m)[1], per_channel=True)
        assert est.per_channel
        assert (est.loss_fn is TR._ce_loss) == (m == "cross_entropy")
    with pytest.raises(ValueError, match="pure-update"):
        TR.make_estimator(ts, _cfgs("running_minmax")[1])
    with pytest.raises(RuntimeError, match="no data"):
        TR.make_estimator(ts, _cfgs("MSE")[1]).finalize()
