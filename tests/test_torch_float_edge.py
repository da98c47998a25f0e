"""The float-edge matmul (K4) of the port's recipes, on the CPU: the two
launches the card runs (the level pass, then the GEMM on its int8 bytes)
against the plain version that defines the bits, and that plain version
against JAX's ``int8_matmul(in_mode='f')``.

Inputs come from ``chip_smoke.edge_inputs`` at ``chip_smoke.EDGE_SHAPES``
with the same seeds, the shapes at which the card holds the kernels to
the plain versions: M = 1000 (not a multiple of 64), N = 136 (N % 16 !=
0), 8-bit edges in 1, 2 and 6 permuted groups, groups of 64 and of 256
columns, 16-bit edges in one group at K = 1024 and in 2 and 3 groups;
the layout and the product also at ``chip_smoke.EDGE_TILE_SHAPES`` (M =
16350, the grouped folds over 512 tiles on the card).

Tolerances:
- the level layout against ``edge_levels``, and the product from it
  against ``float_edge_matmul_ref``: exact (integer stages, the same
  float32 roundings after them);
- ``float_edge_matmul_ref`` against JAX's kernel in interpret mode (one
  block of all M rows): emitted payloads equal or one level off on at most
  0.1% of elements, the bounds ``tests/test_torch_recipes.py`` holds the
  recipes' plain versions to (JAX takes x @ w^T as a float32 dot product,
  the port as exact integer sums); the float output within 1e-5 relative
  of the largest.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK

LEVEL_TOL, FRAC_TOL = 1, 1e-3
SHAPES = [pytest.param(i, *shape, id="m{}k{}n{}b{}g{}".format(*shape))
          for i, shape in enumerate(CS.EDGE_SHAPES)]
ALL_SHAPES = SHAPES + [
    pytest.param(len(SHAPES) + i, *shape,
                 id="m{}k{}n{}b{}g{}".format(*shape))
    for i, shape in enumerate(CS.EDGE_TILE_SHAPES)]


def _inputs(i, m, k, n, bits, groups):
    arrays = CS.edge_inputs(m, k, n, bits, groups, CS.EDGE_SEED + i)
    x, w, vecs, s, zp, cols = (torch.from_numpy(a) for a in arrays)
    return arrays, x, vecs, EK.edge_grid(w, s, zp, bits, groups, cols)


@pytest.mark.parametrize("i,m,k,n,bits,groups", ALL_SHAPES)
def test_level_layout_recombines_to_edge_levels(i, m, k, n, bits, groups):
    _, x, _, grid = _inputs(i, m, k, n, bits, groups)
    lv = EK.float_edge_levels_ref(x, grid).to(torch.int32) + 128
    want = EK.edge_levels(x, grid).to(torch.int32)
    if bits <= 8:
        assert tuple(lv.shape) == (m, k)
        back = lv
    else:
        mp = -(-m // 64) * 64
        assert tuple(lv.shape) == (2 * mp, k)
        panels = lv.view(mp // 64, 2, 64, k)
        lo, hi = (panels[:, p].reshape(mp, k) for p in (0, 1))
        back = lo + 256 * hi
        # rows past M hold zero bytes
        assert torch.equal(lo[m:], torch.full_like(lo[m:], 128))
        assert torch.equal(hi[m:], torch.full_like(hi[m:], 128))
        back = back[:m]
    assert torch.equal(back, want)
    assert int(want.min()) == 0 and int(want.max()) == 2 ** bits - 1


def _which_side(got, want, got_fn, want_fn, mode) -> str:
    """A failure's report: how far the two sides differ, and whether each
    repeats its own bits when run again (a side that does not is the one
    that varies with the run: threads, vector tails, the BLAS)."""
    bad = got != want
    again = {name: torch.equal(fn(), first) for name, fn, first in
             (("the product from the layout", got_fn, got),
              ("the plain version", want_fn, want))}
    return (f"{mode}: {int(bad.sum())} of {bad.numel()} elements differ "
            f"(max {float((got.float() - want.float()).abs().max())}); "
            + "; ".join(f"{name} {'repeats' if ok else 'does NOT repeat'} "
                        "its bits" for name, ok in again.items())
            + f"; {torch.get_num_threads()} threads")


@pytest.mark.parametrize("activation", [None, "gelu_new"])
@pytest.mark.parametrize("i,m,k,n,bits,groups", ALL_SHAPES)
def test_product_from_the_layout_equals_the_plain_version(
        i, m, k, n, bits, groups, activation):
    _, x, vecs, grid = _inputs(i, m, k, n, bits, groups)
    lv = EK.float_edge_levels_ref(x, grid)
    for mode in ("emit", "float"):
        def want_fn():
            return EK.float_edge_matmul_ref(x, vecs, grid,
                                            activation=activation,
                                            out_mode=mode)

        def got_fn():
            return EK.float_edge_gemm_ref(lv, m, vecs, grid,
                                          activation=activation,
                                          out_mode=mode)
        want, got = want_fn(), got_fn()
        assert torch.equal(got, want), _which_side(got, want, got_fn,
                                                   want_fn, mode)
        if mode == "emit":   # payloads spread over the int8 grid
            assert len(torch.unique(got)) > 100


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    _, x, vecs, grid = _inputs(0, *CS.EDGE_SHAPES[0])
    EK.reset_launches()
    lv = EK.float_edge_levels(x, grid)
    assert torch.equal(lv, EK.float_edge_levels_ref(x, grid))
    want = EK.float_edge_matmul_ref(x, vecs, grid, activation="gelu_new")
    assert torch.equal(EK.float_edge_gemm(lv, x.shape[0], vecs, grid,
                                          activation="gelu_new"), want)
    assert torch.equal(EK.float_edge_matmul(x, vecs, grid,
                                            activation="gelu_new"), want)
    assert set(EK.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("i,m,k,n,bits,groups", SHAPES)
def test_plain_version_within_jax_bounds(i, m, k, n, bits, groups):
    (x, w, vecs, _, _, _), tx, tvecs, grid = _inputs(i, m, k, n, bits,
                                                     groups)
    scal = jnp.zeros((1, 2), jnp.float32)
    kw = dict(in_mode="f", interpret=True, block_m=m)
    want = np.asarray(JEK.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(vecs), scal,
        activation="gelu_new", **kw)).astype(np.int32)
    got = EK.float_edge_matmul_ref(tx, tvecs, grid, activation="gelu_new")
    diff = np.abs(got.numpy().astype(np.int32) - want)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()
    want_f = np.asarray(JEK.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(vecs), scal,
        out_mode="float", **kw))
    got_f = EK.float_edge_matmul_ref(tx, tvecs, grid, out_mode="float")
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_f).max()))
