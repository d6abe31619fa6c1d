"""Randomized robustness fuzz: many random problem instances through the
solver families; every run must stay finite and reach a sane objective.
Shapes are fixed so the whole sweep reuses one compiled program per solver.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares


M, N = 24, 48


def _problem(seed, scale):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((M, N)) * scale
    b = rng.standard_normal(M) * scale
    return LeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)), float(
        np.linalg.norm(a, 2) ** 2
    )


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_adapgm_fuzz(seed, scale):
    """Badly scaled random instances: no NaN, residual criterion met."""
    f, lf = _problem(seed, scale)
    g = ap.L1Norm(lam=0.1 * scale**2)
    res = ap.adaptive_proxgrad(
        jnp.zeros(N), f=f, g=g, rule=ap.AdaPGMRule(gamma=1 / lf),
        tol=1e-7 * max(1.0, scale**2), maxit=50_000,
    )
    assert np.isfinite(np.asarray(res.x)).all()
    assert np.isfinite(float(res.norm_res))
    assert float(res.norm_res) <= 1e-7 * max(1.0, scale**2)


@pytest.mark.parametrize("seed", range(6))
def test_all_solvers_finite_fuzz(seed):
    """Every PG family stays finite on random instances (fixed budget)."""
    f, lf = _problem(seed + 100, 1.0)
    g = ap.ElasticNet(lam1=0.2, lam2=0.1)
    x0 = jnp.zeros(N)
    kw = dict(f=f, g=g, tol=0.0, maxit=300)
    runs = [
        ap.adaptive_proxgrad(x0, rule=ap.AdaPGMRule(gamma=1 / lf), **kw),
        ap.adaptive_proxgrad(x0, rule=ap.MalitskyMishchenkoRule(gamma=1 / lf), **kw),
        ap.adaptive_proxgrad(x0, rule=ap.AdaPGMPlusRule(gamma=1 / lf), **kw),
        ap.backtracking_proxgrad(x0, gamma0=1.0, xi=2.0, **kw),
        ap.backtracking_nesterov(x0, gamma0=1.0, **kw),
        ap.fixed_nesterov(x0, gamma=1 / lf, **kw),
        ap.agraal(x0, gamma0=1 / lf, **kw),
    ]
    objs = []
    for r in runs:
        assert np.isfinite(np.asarray(r.x)).all()
        objs.append(float(f.value(r.x) + g(r.x)))
    # all families should be within a loose band of the best found objective
    best = min(objs)
    assert all(o <= best + 1.0 + 0.5 * abs(best) for o in objs)


@pytest.mark.parametrize("seed", range(4))
def test_fused_ls_kernel_fuzz(seed):
    """Random shapes, scales and tile configurations through the one-pass
    kernel (interpret mode) against the XLA two-pass: ragged edges, more
    programs than panels, single rows and columns."""
    from adaprox_tpu.ops import kernels

    rng = np.random.default_rng(700 + seed)
    m, n = (int(v) for v in rng.integers(1, 160, size=2))
    scale = 10.0 ** rng.uniform(-3, 3)
    a = jnp.asarray(rng.standard_normal((m, n)) * scale, jnp.float32)
    b = jnp.asarray(rng.standard_normal(m) * scale, jnp.float32)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    tm = int(rng.choice([1, 2, 4, 8]))
    tn = int(rng.choice([16, 32, 64, 256]))
    g = int(rng.integers(1, 9))
    f_ref, g_ref = kernels.ls_value_grad_xla(a, b, x)
    f_k, g_k = kernels.fused_ls_value_grad(a, b, x, interpret=True,
                                           block_rows=tm, block_cols=tn,
                                           programs=g)
    assert np.isfinite(float(f_k)) and np.isfinite(np.asarray(g_k)).all()
    np.testing.assert_allclose(float(f_k), float(f_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_ref), rtol=1e-5,
                               atol=1e-5 * float(jnp.max(jnp.abs(g_ref))))


@pytest.mark.parametrize("seed", range(4))
def test_ell_operator_fuzz(seed):
    """Random sparsity patterns (incl. empty rows/cols) through ELLOperator:
    matvec parity with dense at f64 level."""
    rng = np.random.default_rng(200 + seed)
    m, n = 40, 170
    d = rng.standard_normal((m, n)) * (rng.random((m, n)) < rng.uniform(0.02, 0.4))
    from adaprox_tpu.ops.sparse import ELLOperator

    op = ELLOperator.from_dense(d)
    x = jnp.asarray(rng.standard_normal(n))
    y = jnp.asarray(rng.standard_normal(m))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), d @ np.asarray(x),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)), d.T @ np.asarray(y),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("scale", [1e-2, 1.0, 1e2])
def test_f0_family_fuzz(seed, scale):
    """Badly scaled random instances through the f = 0 primal-dual family
    (Condat-Vu, and the Malitsky-Pock and AdaPDM+ t-sweeps as vmapped
    programs — the linesearch paths) for both h kinds: finite outputs."""
    import jax

    rng = np.random.default_rng(500 + seed)
    m_, n_ = 32, 16
    a = jnp.asarray(rng.standard_normal((m_, n_)) * scale)
    bv = jnp.asarray(rng.standard_normal(m_) * scale)
    ts = jnp.asarray(np.geomspace(0.1, 10.0, 5))
    na = float(np.linalg.norm(np.asarray(a)))
    x0, y0 = jnp.zeros(n_), jnp.zeros(m_)
    for inner in (ap.L2Norm, ap.L1Norm):
        kw = dict(f=ap.ZeroSmooth(), g=ap.L1Norm(lam=0.1 * scale),
                  h=ap.Translate(inner=inner(lam=1.0), b=-bv),
                  A=ap.DenseOperator(a=a), tol=0.0, maxit=60)
        mp = jax.vmap(lambda t: ap.malitsky_pock(
            x0, y0, sigma=1.0, t=t, **kw).x)(ts)
        pdp = jax.vmap(lambda t: ap.adaptive_linesearch_primal_dual(
            x0, y0, eta=na, t=t, **kw).x)(ts)
        cv = ap.condat_vu(x0, y0, Lf=0.0, norm_A=na, **kw)
        for x in (mp, pdp, cv.x):
            assert np.isfinite(np.asarray(x)).all(), (seed, scale, inner)
        assert np.isfinite(float(cv.norm_res))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scale", [1e-2, 1.0, 1e2])
def test_bt_fuzz(seed, scale):
    """Badly scaled random instances through backtracking PG / Nesterov
    (step deliberately 10x too large, xi = 1.5) and aGRAAL: finite
    outputs, residuals finite, trial caps surfaced rather than poisoning
    x."""
    import jax

    rng = np.random.default_rng(300 + seed)
    m_, n_ = 32, 128
    a = jnp.asarray(rng.standard_normal((m_, n_)) * scale)
    b = jnp.asarray(rng.standard_normal(m_) * scale)
    lf = float(np.linalg.norm(np.asarray(a), 2) ** 2)
    f = LeastSquares(a=a, b=b)
    g = ap.L1Norm(lam=0.1 * scale**2)
    x0 = jnp.zeros(n_)
    for res in (
        ap.backtracking_proxgrad(x0, f=f, g=g, gamma0=10.0 / lf, xi=1.5,
                                 tol=0.0, maxit=200),
        ap.backtracking_nesterov(x0, f=f, g=g, gamma0=10.0 / lf, tol=0.0,
                                 maxit=200),
        ap.agraal(x0, f=f, g=g, gamma0=1.0 / lf, tol=0.0, maxit=200,
                  x0=x0 + jax.random.normal(jax.random.PRNGKey(seed),
                                            x0.shape, x0.dtype)),
    ):
        assert np.isfinite(np.asarray(res.x)).all(), (seed, scale)
        assert np.isfinite(float(res.norm_res))
