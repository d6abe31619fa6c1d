"""Block-sparse (BCSR) matvec: structure building, the XLA gather path
against the NumPy reference, operator wiring, and the oracle/engine
integration."""

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares
from adaprox_tpu.ops.bcsr import (
    BCSROperator,
    bcsr_from_dense,
    bcsr_matvec_ref,
    bcsr_matvec_xla,
)


def _block_sparse(m, n, density, seed):
    """Dense matrix whose nonzeros live in randomly selected (8,128) tiles."""
    rng = np.random.default_rng(seed)
    mp, npd = -(-m // 8) * 8, -(-n // 128) * 128
    mask = rng.random((mp // 8, npd // 128)) < density
    d = rng.standard_normal((mp, npd)) * np.kron(mask, np.ones((8, 128)))
    return d[:m, :n]


@pytest.mark.parametrize("density", [0.1, 0.5])
def test_bcsr_structure_and_ref(density, rng):
    d = _block_sparse(40, 300, density, seed=3)
    vals, cols, rowptr, (mp, npd) = bcsr_from_dense(d, 8, 128)
    assert vals.shape[1:] == (8, 128)
    x = rng.standard_normal(npd)
    y = bcsr_matvec_ref(vals, cols, rowptr, jnp.asarray(x))
    dp = np.zeros((mp, npd)); dp[:40, :300] = d
    np.testing.assert_allclose(np.asarray(y), dp @ x, rtol=1e-9, atol=1e-11)


def _xla(vals, cols, rowptr, x):
    rows = np.repeat(np.arange(len(rowptr) - 1), np.diff(rowptr)).astype(np.int32)
    return bcsr_matvec_xla(jnp.asarray(vals), jnp.asarray(cols),
                           jnp.asarray(rows), x, len(rowptr) - 1)


@pytest.mark.parametrize("block", [(8, 128), (16, 64), (64, 512), (4, 32)])
def test_bcsr_xla_matvec_matches_ref(block, rng):
    """The gather + einsum + segment-sum path at several tile shapes,
    including uneven rows and an empty block row."""
    bm, bn = block
    d = _block_sparse(96, 700, 0.2, seed=5)
    d[bm:2 * bm, :] = 0.0  # an empty block row
    vals, cols, rowptr, (mp, npd) = bcsr_from_dense(d, bm, bn)
    assert vals.shape[1:] == (bm, bn)
    x = jnp.asarray(rng.standard_normal(npd))
    np.testing.assert_allclose(np.asarray(_xla(vals, cols, rowptr, x)),
                               np.asarray(bcsr_matvec_ref(vals, cols, rowptr, x)),
                               rtol=1e-10, atol=1e-12)


def test_bcsr_all_zero_matrix(rng):
    """An all-zero matrix keeps one zero tile so shapes stay valid."""
    d = np.zeros((20, 200))
    op = BCSROperator.from_dense(d, block=(8, 128))
    x = jnp.asarray(rng.standard_normal(200))
    np.testing.assert_array_equal(np.asarray(op.matvec(x)), np.zeros(20))
    assert float(op.norm()) == 0.0


def test_bcsr_operator_parity(rng):
    d = _block_sparse(72, 384, 0.25, seed=7)
    op = BCSROperator.from_dense(d, block=(8, 128))
    assert 0 < op.block_density <= 0.5
    # default (DMA-efficient) 64 KB tiles also stay exact
    op64 = BCSROperator.from_dense(d)
    x64 = jnp.asarray(np.random.default_rng(1).standard_normal(384))
    np.testing.assert_allclose(np.asarray(op64.matvec(x64)), d @ np.asarray(x64),
                               rtol=1e-9, atol=1e-11)
    x = jnp.asarray(rng.standard_normal(384))
    y = jnp.asarray(rng.standard_normal(72))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), d @ np.asarray(x),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), d.T @ np.asarray(y),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(op.norm()), np.linalg.norm(d), rtol=1e-12)


def test_bcsr_in_oracle_and_engine(rng):
    """BCSR-backed LeastSquares drives AdaPGM to the same solution."""
    d = _block_sparse(64, 256, 0.3, seed=11)
    b = np.asarray(rng.standard_normal(64))
    f_dense = LeastSquares(a=jnp.asarray(d), b=jnp.asarray(b))
    f_bcsr = LeastSquares(a=BCSROperator.from_dense(d), b=jnp.asarray(b))
    x = jnp.asarray(rng.standard_normal(256))
    v1, g1 = f_dense.value_and_grad(x)
    v2, g2 = f_bcsr.value_and_grad(x)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-9, atol=1e-11)

    lf = float(np.linalg.norm(d, 2) ** 2)
    kw = dict(g=ap.L1Norm(lam=1.0), rule=ap.AdaPGMRule(gamma=1 / lf),
              tol=1e-9, maxit=2000)
    r1 = ap.adaptive_proxgrad(jnp.zeros(256), f=f_dense, **kw)
    r2 = ap.adaptive_proxgrad(jnp.zeros(256), f=f_bcsr, **kw)
    # tile-wise segment sums reduce in a different order than the dense
    # matmul; f64-level drift compounds over 2000 iterations
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-4, atol=1e-6)
    g = ap.L1Norm(lam=1.0)
    np.testing.assert_allclose(
        float(f_bcsr.value(r2.x) + g(r2.x)), float(f_dense.value(r1.x) + g(r1.x)),
        rtol=1e-10)
