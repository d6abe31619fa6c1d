"""Prox operator correctness: closed forms, prox optimality conditions, and
the Moreau identity (which the dual update in every PD solver relies on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.ops.prox import MoreauConjugate


def prox_objective(g, v, gamma, z):
    return float(g(z)) + float(jnp.sum((z - v) ** 2)) / (2 * gamma)


OPS = [
    ap.Zero(),
    ap.L1Norm(lam=0.7),
    ap.L2Norm(lam=1.3),
    ap.SqrL2Norm(lam=2.0),
    ap.IndBox(lo=-0.5, hi=1.5),
    ap.IndBall2(r=0.8),
    ap.IndZero(),
    ap.IndSimplex(r=1.3),
    ap.IndBall1(r=0.9),
    ap.LInfNorm(lam=0.8),
    ap.Huber(delta=0.6, lam=1.2),
    ap.NuclearNorm(p=4, q=5, lam=0.5),  # the 20-vector is a 4x5 matrix
    ap.Scale(inner=ap.L1Norm(lam=0.5), a=2.0),
    ap.HingeLoss(b=jnp.asarray(np.random.default_rng(0).choice([-1.0, 1.0], 20)),
                 lam=0.9),
    ap.LogBarrier(mu=0.4),
    ap.IndHalfspace(a=jnp.asarray(np.random.default_rng(1).standard_normal(20)),
                    c=0.3),
    ap.IndHyperplane(a=jnp.asarray(np.random.default_rng(2).standard_normal(20)),
                     c=-0.2),
]


@pytest.mark.parametrize("g", OPS, ids=lambda g: type(g).__name__)
def test_prox_minimizes_objective(g, rng):
    """prox output must beat random candidates on g(z) + ||z-v||^2/(2 gamma)."""
    v = jnp.asarray(rng.standard_normal(20))
    gamma = 0.37
    y, g_y = g.prox(v, gamma)
    base = prox_objective(g, v, gamma, y)
    assert np.isfinite(base)
    # value returned by prox matches g at the prox point
    np.testing.assert_allclose(float(g_y), float(g(y)), rtol=1e-12, atol=1e-12)
    for _ in range(20):
        z = y + 0.1 * jnp.asarray(rng.standard_normal(20))
        assert prox_objective(g, v, gamma, z) >= base - 1e-9


def test_l1_soft_threshold_closed_form(rng):
    v = jnp.asarray(rng.standard_normal(50))
    lam, gamma = 0.3, 0.7
    y, _ = ap.L1Norm(lam=lam).prox(v, gamma)
    expected = np.sign(v) * np.maximum(np.abs(v) - gamma * lam, 0)
    np.testing.assert_allclose(np.asarray(y), expected, rtol=1e-14)


def test_box_clamp(rng):
    v = jnp.asarray(rng.standard_normal(50) * 3)
    y, val = ap.IndBox(lo=-1.0, hi=2.0).prox(v, 0.5)
    np.testing.assert_allclose(np.asarray(y), np.clip(v, -1.0, 2.0))
    assert float(val) == 0.0
    assert float(ap.IndBox(lo=-1.0, hi=2.0)(y)) == 0.0
    assert float(ap.IndBox(lo=-1.0, hi=2.0)(v)) == np.inf


def test_l2_block_soft_threshold(rng):
    v = jnp.asarray(rng.standard_normal(30))
    lam, gamma = 0.5, 0.9
    y, _ = ap.L2Norm(lam=lam).prox(v, gamma)
    nv = float(jnp.linalg.norm(v))
    scale = max(0.0, 1 - gamma * lam / nv)
    np.testing.assert_allclose(np.asarray(y), scale * np.asarray(v), rtol=1e-12)
    # below threshold: maps to zero
    y0, _ = ap.L2Norm(lam=lam).prox(v / nv * gamma * lam * 0.5, gamma)
    np.testing.assert_allclose(np.asarray(y0), 0.0)


def test_translate(rng):
    b = jnp.asarray(rng.standard_normal(10))
    v = jnp.asarray(rng.standard_normal(10))
    h = ap.Translate(inner=ap.L2Norm(lam=1.0), b=-b)  # h(x) = ||x - b||
    np.testing.assert_allclose(
        float(h(v)), float(jnp.linalg.norm(v - b)), rtol=1e-12
    )
    y, val = h.prox(v, 0.4)
    base = prox_objective(h, v, 0.4, y)
    for _ in range(20):
        z = y + 0.05 * jnp.asarray(rng.standard_normal(10))
        assert prox_objective(h, v, 0.4, z) >= base - 1e-9


@pytest.mark.parametrize(
    "g", [ap.L1Norm(lam=0.7), ap.L2Norm(lam=1.1), ap.IndBox(lo=-1.0, hi=1.0),
          ap.Zero(), ap.SqrL2Norm(lam=1.7), ap.LInfNorm(lam=0.8),
          ap.IndBall1(r=1.1), ap.IndBall2(r=0.8)],
    ids=lambda g: type(g).__name__,
)
def test_moreau_identity(g, rng):
    """prox_{s g*}(w) == w - s*prox_{g/s}(w/s): the analytic conjugates must
    agree with the generic Moreau wrapper (used at src/AdaProx.jl:345)."""
    w = jnp.asarray(rng.standard_normal(25))
    s = 0.63
    analytic = ap.conjugate(g)
    moreau = MoreauConjugate(inner=g)
    ya, _ = analytic.prox(w, s)
    ym, _ = moreau.prox(w, s)
    np.testing.assert_allclose(np.asarray(ya), np.asarray(ym), rtol=1e-10, atol=1e-12)


def test_conjugate_pairs():
    assert isinstance(ap.conjugate(ap.Zero()), ap.IndZero)
    assert isinstance(ap.conjugate(ap.IndZero()), ap.Zero)
    assert isinstance(ap.conjugate(ap.L1Norm(lam=2.0)), ap.IndBox)
    assert isinstance(ap.conjugate(ap.L2Norm(lam=2.0)), ap.IndBall2)
    assert isinstance(ap.conjugate(ap.IndBall2(r=2.0)), ap.L2Norm)
    assert float(ap.conjugate(ap.IndBall2(r=2.0)).lam) == 2.0
    assert isinstance(ap.conjugate(ap.LInfNorm(lam=0.5)), ap.IndBall1)
    assert float(ap.conjugate(ap.LInfNorm(lam=0.5)).r) == 0.5
    assert isinstance(ap.conjugate(ap.IndBall1(r=3.0)), ap.LInfNorm)
    assert isinstance(ap.conjugate(ap.SqrL2Norm(lam=4.0)), ap.SqrL2Norm)
    assert float(ap.conjugate(ap.SqrL2Norm(lam=4.0)).lam) == 0.25


def test_simplex_projection(rng):
    """Projection sums to r, is nonnegative, and matches a NumPy reference
    implementation of the sort-based algorithm."""
    v = rng.standard_normal(40)
    r = 1.3
    y, val = ap.IndSimplex(r=r).prox(jnp.asarray(v), 0.7)
    y = np.asarray(y)
    assert float(val) == 0.0
    assert (y >= 0).all()
    np.testing.assert_allclose(y.sum(), r, rtol=1e-12)
    # reference: find tau s.t. sum(max(v - tau, 0)) = r
    u = np.sort(v)[::-1]
    css = np.cumsum(u) - r
    rho = np.nonzero(u - css / np.arange(1, 41) > 0)[0][-1] + 1
    tau = css[rho - 1] / rho
    np.testing.assert_allclose(y, np.maximum(v - tau, 0), atol=1e-14)
    # indicator accepts its own prox output, rejects an off-simplex point
    assert float(ap.IndSimplex(r=r)(jnp.asarray(y))) == 0.0
    assert float(ap.IndSimplex(r=r)(jnp.asarray(v))) == np.inf


def test_l1_ball_projection(rng):
    v = jnp.asarray(rng.standard_normal(30) * 2)
    r = 0.9
    g = ap.IndBall1(r=r)
    y, _ = g.prox(v, 1.0)
    np.testing.assert_allclose(float(jnp.sum(jnp.abs(y))), r, rtol=1e-12)
    assert float(g(y)) == 0.0
    # inside the ball: identity
    v_in = v / float(jnp.sum(jnp.abs(v))) * (0.5 * r)
    y_in, _ = g.prox(v_in, 1.0)
    np.testing.assert_allclose(np.asarray(y_in), np.asarray(v_in))


def test_huber_prox_closed_form():
    g = ap.Huber(delta=1.0, lam=2.0)
    gamma = 0.5  # effective unit-huber stepsize = 1.0
    # |v| <= delta*(1+ge): quadratic zone, shrink by 1/(1+ge)
    y, _ = g.prox(jnp.asarray([1.5]), gamma)
    np.testing.assert_allclose(np.asarray(y), [0.75])
    # outside: constant step ge*delta toward zero
    y2, _ = g.prox(jnp.asarray([-4.0]), gamma)
    np.testing.assert_allclose(np.asarray(y2), [-3.0])
    # value: quadratic inside, linear outside
    np.testing.assert_allclose(float(g(jnp.asarray([0.5]))), 2.0 * 0.125)
    np.testing.assert_allclose(float(g(jnp.asarray([3.0]))), 2.0 * 2.5)


def test_nuclear_norm_prox_soft_thresholds_singular_values(rng):
    p, q, lam, gamma = 5, 7, 0.8, 0.6
    m = rng.standard_normal((p, q))
    g = ap.NuclearNorm(p=p, q=q, lam=lam)
    v = jnp.asarray(m.reshape(-1))
    np.testing.assert_allclose(
        float(g(v)), np.linalg.svd(m, compute_uv=False).sum() * lam,
        rtol=1e-12)
    y, val = g.prox(v, gamma)
    s_y = np.linalg.svd(np.asarray(y).reshape(p, q), compute_uv=False)
    s_expected = np.maximum(np.linalg.svd(m, compute_uv=False) - gamma * lam, 0)
    np.testing.assert_allclose(np.sort(s_y), np.sort(s_expected), atol=1e-10)
    np.testing.assert_allclose(float(val), lam * s_expected.sum(), rtol=1e-10)


def test_ind_psd_projection(rng):
    p = 4
    m = rng.standard_normal((p, p))
    sym = 0.5 * (m + m.T)
    g = ap.IndPSD(p=p)
    y, val = g.prox(jnp.asarray(m.reshape(-1)), 0.3)
    assert float(val) == 0.0
    w, q = np.linalg.eigh(sym)
    expected = (q * np.maximum(w, 0)) @ q.T
    np.testing.assert_allclose(np.asarray(y).reshape(p, p), expected,
                               atol=1e-12)
    assert float(g(y)) == 0.0
    indefinite = np.eye(p); indefinite[0, 0] = -1.0
    assert float(g(jnp.asarray(indefinite.reshape(-1)))) == np.inf


def test_scale_postcompose(rng):
    v = jnp.asarray(rng.standard_normal(12))
    g = ap.Scale(inner=ap.L1Norm(lam=0.5), a=2.0)
    y, val = g.prox(v, 0.7)
    y_ref, val_ref = ap.L1Norm(lam=0.5).prox(v, 2.0 * 0.7)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref))
    np.testing.assert_allclose(float(val), 2.0 * float(val_ref))
    np.testing.assert_allclose(float(g(v)), 2.0 * 0.5 * float(jnp.sum(jnp.abs(v))))


def test_hinge_prox_closed_form():
    b = jnp.asarray([1.0, 1.0, 1.0, -1.0])
    g = ap.HingeLoss(b=b, lam=2.0)
    gamma = 0.25  # step budget gamma*lam = 0.5
    #       past margin | inside quadrant (hits margin) | deep violation | flipped label
    v = jnp.asarray([3.0, 0.8, -4.0, 2.0])
    y, val = g.prox(v, gamma)
    # 3.0 > 1: untouched. 0.8: 1-z=0.2 < 0.5 -> lands exactly on margin 1.
    # -4.0: full step +0.5. b=-1, v=2.0: z=-2, 1-z=3 > 0.5 -> step -0.5.
    np.testing.assert_allclose(np.asarray(y), [3.0, 1.0, -3.5, 1.5])
    np.testing.assert_allclose(
        float(g(v)), 2.0 * (0.0 + 0.2 + 5.0 + 3.0), rtol=1e-12)


def test_log_barrier_prox_positive_root(rng):
    g = ap.LogBarrier(mu=0.7)
    v = jnp.asarray(rng.standard_normal(30) * 3)
    gamma = 0.45
    y, val = g.prox(v, gamma)
    y_np = np.asarray(y)
    assert (y_np > 0).all()
    # y solves y^2 - v y - gamma*mu = 0 (stationarity of the prox problem)
    np.testing.assert_allclose(y_np * y_np - np.asarray(v) * y_np,
                               gamma * 0.7, rtol=1e-10)
    np.testing.assert_allclose(float(val), -0.7 * np.log(y_np).sum(),
                               rtol=1e-12)
    assert float(g(jnp.asarray([-1.0, 2.0]))) == np.inf


def test_log_barrier_prox_f32_large_negative_no_cancellation():
    """v + sqrt(v^2 + c) cancels catastrophically for large negative v in
    f32: the naive form returned y == 0 (and value inf) for v = -5e3,
    violating the y > 0 guarantee and inf-poisoning f32 solves
    (r3 ADVICE medium). The rationalized branch 2*gamma*mu/(r - v) must
    stay strictly positive and satisfy stationarity to f32 accuracy."""
    g = ap.LogBarrier(mu=0.4)
    v = jnp.asarray([-5e3, -3.6e3, -1e6, -30.0, 0.0, 2.0], dtype=jnp.float32)
    gamma = 1.0
    y, val = g.prox(v, gamma)
    y_np = np.asarray(y, dtype=np.float64)
    assert (y_np > 0).all()
    assert np.isfinite(float(val))
    # closed form in f64 as oracle: y = 2*g*mu / (sqrt(v^2+4*g*mu) - v)
    v64 = np.asarray(v, dtype=np.float64)
    y_ref = 2 * gamma * 0.4 / (np.sqrt(v64 * v64 + 4 * gamma * 0.4) - v64)
    np.testing.assert_allclose(y_np, y_ref, rtol=1e-5)


def test_halfspace_and_hyperplane_projection(rng):
    a = jnp.asarray(rng.standard_normal(15))
    c = 0.4
    v_out = jnp.asarray(rng.standard_normal(15) * 2)
    hs, hp = ap.IndHalfspace(a=a, c=c), ap.IndHyperplane(a=a, c=c)
    for g in (hs, hp):
        y, val = g.prox(v_out, 0.9)
        assert float(val) == 0.0
        assert float(g(y)) == 0.0  # projection is feasible
        # projection onto {<a,x> (<=|=) c} moves along a only
        d = np.asarray(y - v_out)
        cross = d - (d @ np.asarray(a)) / float(a @ a) * np.asarray(a)
        np.testing.assert_allclose(cross, 0.0, atol=1e-12)
    # hyperplane projection lands exactly on it
    y_hp, _ = hp.prox(v_out, 1.0)
    np.testing.assert_allclose(float(a @ y_hp), c, atol=1e-12)
    # interior point: halfspace prox is the identity, hyperplane's is not
    v_in = v_out - ((float(a @ v_out) - c) + 1.0) / float(a @ a) * a
    y_in, _ = hs.prox(v_in, 1.0)
    np.testing.assert_allclose(np.asarray(y_in), np.asarray(v_in))
    assert float(hs(v_in)) == 0.0
    assert float(hp(v_in)) == np.inf


@pytest.mark.parametrize("g", OPS, ids=lambda g: type(g).__name__)
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_prox_nonexpansive(g, scale, rng):
    """Every prox of a convex function is 1-Lipschitz; check at extreme
    input scales and stepsizes (catches cancellation/overflow edge cases
    the closed-form tests at scale ~1 cannot)."""
    u = jnp.asarray(rng.standard_normal(20) * scale)
    v = jnp.asarray(rng.standard_normal(20) * scale)
    for gamma in (1e-7 * scale, 0.37, 1e5 * scale):
        yu, _ = g.prox(u, gamma)
        yv, _ = g.prox(v, gamma)
        du = float(jnp.linalg.norm(yu - yv))
        dv = float(jnp.linalg.norm(u - v))
        assert np.isfinite(du)
        assert du <= dv * (1 + 1e-10) + 1e-12 * scale


def test_simplex_constrained_solve(rng):
    """The new constraint sets work through the solver engine: min
    0.5||x - c||^2 over the simplex has the simplex projection of c as its
    unique solution."""
    from adaprox_tpu.ops.oracles import FromFunction

    c = jnp.asarray(rng.standard_normal(25))
    f = FromFunction(fn=lambda x: 0.5 * jnp.sum((x - c) ** 2))
    res = ap.adaptive_proxgrad(
        jnp.full(25, 1.0 / 25), f=f, g=ap.IndSimplex(r=1.0),
        rule=ap.AdaPGMRule(gamma=0.5), tol=1e-10, maxit=500)
    expected, _ = ap.IndSimplex(r=1.0).prox(c, 1.0)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(expected),
                               atol=1e-8)


def test_new_prox_vmappable_over_params(rng):
    """The new operators keep numeric fields as dynamic leaves so sweeps can
    vmap over them (e.g. an L1-ball radius path)."""
    v = jnp.asarray(rng.standard_normal((6, 15)))
    rs = jnp.linspace(0.2, 2.0, 6)

    @jax.jit
    @jax.vmap
    def batch(r, vi):
        return ap.IndBall1(r=r).prox(vi, 1.0)[0]

    out = batch(rs, v)
    for i in range(6):
        yi, _ = ap.IndBall1(r=float(rs[i])).prox(v[i], 1.0)
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(yi),
                                   atol=1e-14)


def test_prox_is_jittable_and_vmappable(rng):
    v = jnp.asarray(rng.standard_normal((8, 16)))
    lams = jnp.linspace(0.1, 1.0, 8)

    @jax.jit
    @jax.vmap
    def batch_prox(lam, vi):
        return ap.L1Norm(lam=lam).prox(vi, 0.5)[0]

    out = batch_prox(lams, v)
    for i in range(8):
        yi, _ = ap.L1Norm(lam=float(lams[i])).prox(v[i], 0.5)
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(yi), rtol=1e-12)
