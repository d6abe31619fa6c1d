"""Sparse ELL data path: gather matvecs against dense, and oracle wiring at
reference-like sparsities."""

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares, LogisticLoss
from adaprox_tpu.ops.sparse import ELLOperator, ell_matvec_xla


def _sparse_dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    # ensure at least one nnz per row/col so nothing degenerates
    d[np.arange(m), rng.integers(0, n, m)] += 1.0
    return d


@pytest.mark.parametrize("density", [0.3, 0.03])
def test_ell_matvec_parity(density, rng):
    d = _sparse_dense(100, 350, density, seed=5)
    op = ELLOperator.from_dense(d)
    x = jnp.asarray(rng.standard_normal(350))
    y = jnp.asarray(rng.standard_normal(100))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), d @ np.asarray(x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), d.T @ np.asarray(y),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(op.norm()), np.linalg.norm(d), rtol=1e-12)
    np.testing.assert_allclose(float(op.opnorm(iters=600)), np.linalg.norm(d, 2),
                               rtol=1e-3)


def test_ell_xla_matvec_rows_beyond_m(rng):
    """ell_matvec_xla slices the padded rows away: out_rows rows come back,
    each the dense row product."""
    d = _sparse_dense(61, 256, 0.1, seed=7)
    op = ELLOperator.from_dense(d)
    assert op.vals.shape[0] % 8 == 0 and op.vals.shape[0] >= 61
    x = jnp.asarray(rng.standard_normal(256))
    got = ell_matvec_xla(op.vals, op.cols, x, 61)
    assert got.shape == (61,)
    np.testing.assert_allclose(np.asarray(got), d @ np.asarray(x),
                               rtol=1e-10, atol=1e-12)


def test_ell_density_reporting():
    d = _sparse_dense(64, 512, 0.05, seed=3)
    op = ELLOperator.from_dense(d)
    # k is padded to 128 lanes, so density is k/n
    assert op.density == op.vals.shape[1] / 512
    assert op.density < 0.5  # this problem clears the crossover bar


def test_least_squares_with_ell_operator(rng):
    """The sparse operator plugs into the oracle layer: an AdaPGM lasso
    solve over ELL data matches the dense solve exactly (same reductions)."""
    d = _sparse_dense(96, 400, 0.08, seed=9)
    b = np.asarray(rng.standard_normal(96))
    f_dense = LeastSquares(a=jnp.asarray(d), b=jnp.asarray(b))
    f_ell = LeastSquares(a=ELLOperator.from_dense(d), b=jnp.asarray(b))
    x = jnp.asarray(rng.standard_normal(400))
    v1, g1 = f_dense.value_and_grad(x)
    v2, g2 = f_ell.value_and_grad(x)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-9, atol=1e-11)

    lf = float(np.linalg.norm(d, 2) ** 2)
    kw = dict(g=ap.L1Norm(lam=1.0), rule=ap.AdaPGMRule(gamma=1 / lf),
              tol=1e-9, maxit=2000)
    r1 = ap.adaptive_proxgrad(jnp.zeros(400), f=f_dense, **kw)
    r2 = ap.adaptive_proxgrad(jnp.zeros(400), f=f_ell, **kw)
    assert abs(int(r1.numit) - int(r2.numit)) <= max(2, int(r1.numit) // 50)
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-7, atol=1e-9)


def test_logistic_with_ell_operator(rng):
    """Sparse logreg (the reference's actual sparse workload,
    sparse_logreg/runme.jl + libsvm.jl): ELL-backed LogisticLoss matches
    dense value/grad and solve."""
    from adaprox_tpu.utils.datasets import synthetic_classification

    x_np, y_np = synthetic_classification(120, 300, seed=2)  # ~70% sparse
    f_dense = LogisticLoss(x=jnp.asarray(x_np), y=jnp.asarray(y_np))
    f_ell = LogisticLoss(x=ELLOperator.from_dense(x_np), y=jnp.asarray(y_np))
    w = jnp.asarray(rng.standard_normal(301))
    v1, g1 = f_dense.value_and_grad(w)
    v2, g2 = f_ell.value_and_grad(w)
    np.testing.assert_allclose(float(v2), float(v1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g2), np.asarray(g1), rtol=1e-8, atol=1e-11)

    kw = dict(g=ap.L1Norm(lam=0.01), rule=ap.AdaPGMRule(gamma=1.0),
              tol=1e-7, maxit=600)
    r1 = ap.adaptive_proxgrad(jnp.zeros(301), f=f_dense, **kw)
    r2 = ap.adaptive_proxgrad(jnp.zeros(301), f=f_ell, **kw)
    # gather-sum and matmul reduce in different orders; the f64-level drift
    # compounds over 600 iterations — compare iterates loosely, objective tight
    np.testing.assert_allclose(np.asarray(r2.x), np.asarray(r1.x),
                               rtol=1e-4, atol=1e-6)
    g = ap.L1Norm(lam=0.01)
    np.testing.assert_allclose(
        float(f_ell.value(r2.x) + g(r2.x)), float(f_dense.value(r1.x) + g(r1.x)),
        rtol=1e-10)


def test_ell_in_pd_engine(rng):
    """ELLOperator as the coupling A of the PD engine."""
    d = _sparse_dense(60, 140, 0.1, seed=13)
    yv = np.asarray(rng.standard_normal(60))
    h = ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv))
    op = ELLOperator.from_dense(d)
    na = float(np.linalg.norm(d))
    res = ap.adaptive_primal_dual(
        jnp.zeros(140), jnp.zeros(60), f=ap.ZeroSmooth(), g=ap.L1Norm(lam=10.0),
        h=h, A=op, rule=ap.AdaPGMRule.make(t=1.0, norm_a=na),
        tol=1e-6, maxit=5000)
    ref = ap.adaptive_primal_dual(
        jnp.zeros(140), jnp.zeros(60), f=ap.ZeroSmooth(), g=ap.L1Norm(lam=10.0),
        h=h, A=ap.DenseOperator(a=jnp.asarray(d)),
        rule=ap.AdaPGMRule.make(t=1.0, norm_a=na), tol=1e-6, maxit=5000)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-6, atol=1e-8)
