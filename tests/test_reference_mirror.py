"""Trajectory-exact parity: a pure-NumPy mirror of the reference loops.

These mirrors transcribe the reference's iteration order and call sites
(src/AdaProx.jl) in plain NumPy f64 — no JAX — and the compiled engine must
reproduce their per-iteration gamma/x trajectories to float reassociation
tolerance. This is the strongest check that the engine implements the
same algorithm, not merely "an algorithm that also converges".
"""

import jax.numpy as jnp
import numpy as np
import pytest

import adaprox_tpu as ap
from adaprox_tpu.models.objectives import LeastSquares, Quadratic


# --- numpy reference mirrors ------------------------------------------------


def np_adapgm_rule(state, x1, g1, x0, g0):
    """OurRule update, src/AdaProx.jl:258-273 (norm_A=0, t=1, delta=0)."""
    gamma1, gamma0 = state
    dg, dx = g1 - g0, x1 - x0
    dgdx = dg @ dx
    with np.errstate(all="ignore"):
        c = (dg @ dg) / dgdx
        lip = dgdx / (dx @ dx)
    c = 0.0 if np.isnan(c) else c
    lip = 0.0 if np.isnan(lip) else lip
    d = gamma1 * lip * (gamma1 * c - 1)
    with np.errstate(all="ignore"):
        t3 = gamma1 / np.sqrt(2 * max(d + np.sqrt(d * d), 0.0))
    gamma = min(gamma1 * np.sqrt(1 + gamma1 / gamma0), t3)
    return gamma, (gamma, gamma1)


def np_mm_rule(state, x1, g1, x0, g0):
    """MalitskyMishchenkoRule, src/AdaProx.jl:226-230 (t=1)."""
    gamma_prev, rho = state
    lip = np.linalg.norm(g1 - g0) / np.linalg.norm(x1 - x0)
    gamma = min(np.sqrt(1 + rho) * gamma_prev, 1 / (2 * lip))
    return gamma, (gamma, gamma / gamma_prev)


def soft(v, thr):
    return np.sign(v) * np.maximum(np.abs(v) - thr, 0)


def np_adaptive_proxgrad(a, b, lam, gamma0, rule_update, state0, iters):
    """adaptive_primal_dual with h=Zero, A=0 (src/AdaProx.jl:312-364)."""
    grad = lambda x: a.T @ (a @ x - b)
    x = np.zeros(a.shape[1])
    gamma = gamma0
    state = state0
    g = grad(x)
    v = x - gamma * g
    x_prev, g_prev = x, g
    x = soft(v, gamma * lam)
    gammas, xs = [], []
    for _ in range(iters):
        g_x = grad(x)
        gamma, state = rule_update(state, x, g_x, x_prev, g_prev)
        v = x - gamma * g_x
        x_prev, g_prev = x, g_x
        x = soft(v, gamma * lam)
        gammas.append(gamma)
        xs.append(x.copy())
    return np.array(gammas), np.array(xs)


def np_adaptive_pd(q, qv, labels, big_c, t, norm_a, iters):
    """Full PD loop (dual-SVM shape: g=IndBox, h=IndZero so prox_{h*}=id),
    src/AdaProx.jl:312-364 with OurRule (gamma = 1/(2*1.2*t*norm_a))."""
    n = q.shape[0]
    grad = lambda x: q @ x + qv
    clamp = lambda v: np.clip(v, 0.0, big_c)
    a_mv = lambda x: np.array([labels @ x])
    at_mv = lambda y: labels * y[0]

    theta_big = 1.2
    gamma = 1.0 / (2 * theta_big * t * norm_a)
    sigma = gamma * t * t
    g1 = g0 = gamma
    x = np.zeros(n)
    y = np.zeros(1)
    a_x = a_mv(x)
    g_x = grad(x)
    at_y = at_mv(y)
    v = x - gamma * (g_x + at_y)
    x_prev, a_x_prev, g_prev = x, a_x, g_x
    x = clamp(v)
    gammas, res = [], []
    for _ in range(iters):
        a_x = a_mv(x)
        g_x = grad(x)
        primal = (v - x) / gamma + g_x + at_y
        # OurRule with coupling (src/AdaProx.jl:258-273)
        dg, dx = g_x - g_prev, x - x_prev
        dgdx = dg @ dx
        with np.errstate(all="ignore"):
            c = (dg @ dg) / dgdx
            lip = dgdx / (dx @ dx)
        c = 0.0 if np.isnan(c) else c
        lip = 0.0 if np.isnan(lip) else lip
        d = g1 * lip * (g1 * c - 1)
        xi = t * t * g1 * g1 * norm_a * norm_a
        m4 = 1 - 4 * xi
        with np.errstate(all="ignore"):
            t3 = g1 * np.sqrt(m4) / np.sqrt(2 * max(d + np.sqrt(d * d + xi * m4), 0.0))
        gamma_new = min(g1 * np.sqrt(1 + g1 / g0), 1 / (2 * theta_big * t * norm_a), t3)
        g0, g1 = g1, gamma_new
        sigma = gamma_new * t * t
        rho = gamma_new / gamma
        gamma = gamma_new
        w = y + sigma * ((1 + rho) * a_x - rho * a_x_prev)
        y = w  # prox of (IndZero)* = Zero -> identity
        dual = (w - y) / sigma - a_x
        res.append(np.sqrt(primal @ primal + dual @ dual))
        at_y = at_mv(y)
        v = x - gamma * (g_x + at_y)
        x_prev, a_x_prev, g_prev = x, a_x, g_x
        x = clamp(v)
        gammas.append(gamma)
    return np.array(gammas), np.array(res)


# --- parity assertions ------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rule_name", ["ours", "mm"])
def test_pg_trajectory_matches_numpy_mirror(seed, rule_name):
    rng = np.random.default_rng(seed)
    m, n = 30, 50
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.3
    gamma0 = 1.0 / np.linalg.norm(a, 2) ** 2
    iters = 60

    if rule_name == "ours":
        np_rule, state0 = np_adapgm_rule, (gamma0, gamma0)
        jx_rule = ap.AdaPGMRule(gamma=gamma0)
    else:
        np_rule, state0 = np_mm_rule, (gamma0, np.inf)
        jx_rule = ap.MalitskyMishchenkoRule(gamma=gamma0)

    gammas_np, xs_np = np_adaptive_proxgrad(a, b, lam, gamma0, np_rule, state0, iters)

    res = ap.adaptive_proxgrad(
        jnp.zeros(n), f=LeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)),
        g=ap.L1Norm(lam=lam), rule=jx_rule, tol=0.0, maxit=iters, history=True,
    )
    gammas_jx = np.asarray(res.records.gamma)
    # float reassociation (jnp reductions vs BLAS) is amplified by the
    # recurrence; 1e-7 over 60 iterations is still trajectory-exact evidence
    np.testing.assert_allclose(gammas_jx, gammas_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.x), xs_np[-1], rtol=1e-7, atol=1e-10)


# --- nonsmooth prox helpers for the PD-linesearch mirrors -------------------


def np_prox_l2(v, gamma, lam=1.0):
    """NormL2 block soft-threshold (ProximalOperators NormL2)."""
    nv = np.linalg.norm(v)
    scale = max(0.0, 1 - gamma * lam / nv) if nv > 0 else 0.0
    return scale * v


def np_prox_translate_l2_conj(w, sigma, b, lam=1.0):
    """prox of (Translate(NormL2(lam), b))^* via Moreau:
    prox_{sigma h*}(w) = w - sigma * prox_{h/sigma}(w/sigma)
    (ProximalCore convex_conjugate semantics, used src/AdaProx.jl:492,594)."""
    u = w / sigma
    inner = np_prox_l2(u + b, 1.0 / sigma, lam) - b  # Translate prox shift
    return w - sigma * inner


def np_adapdm_plus(a_f, b_f, lam, yv, a, x0, y0, eta0, t, iters,
                   delta=1e-8, Theta=1.2, r=2.0, R=0.95):
    """adaptive_linesearch_primal_dual mirror (src/AdaProx.jl:463-550):
    f = 0.5||A_f x - b_f||^2, g = lam*l1, h = Translate(NormL2, -yv).
    Returns per-iteration (gamma, sigma, eta, inner-trial count,
    cumulative At_evals)."""
    f_grad = lambda x: a_f.T @ (a_f @ x - b_f)
    prox_g = lambda v, gamma: soft(v, gamma * lam)
    prox_hc = lambda w, sigma: np_prox_translate_l2_conj(w, sigma, -yv)

    gamma = 1.0 / (2 * Theta * t * eta0)
    delta1 = 1 + delta
    gamma_prev = gamma
    eta = eta0
    x, y = x0.copy(), y0.copy()
    a_x = a @ x
    grad_x = f_grad(x)
    at_y = a.T @ y
    at_count = 1
    v = x - gamma * (grad_x + at_y)
    x_prev, a_x_prev, grad_prev = x, a_x, grad_x
    x = prox_g(v, gamma)
    gammas, sigmas, etas, trials_hist, at_hist = [], [], [], [], []
    for _ in range(iters):
        a_x = a @ x
        grad_x = f_grad(x)
        dg, dx = grad_x - grad_prev, x - x_prev
        with np.errstate(all="ignore"):
            c = (dg @ dg) / (dg @ dx)
            lip = (dg @ dx) / (dx @ dx)
        c = 0.0 if np.isnan(c) else c
        lip = 0.0 if np.isnan(lip) else lip
        big_delta = gamma * lip * (gamma * c - 1)
        xi_bar = t**2 * gamma**2 * eta**2 * delta1**2
        m4 = 1 - 4 * xi_bar
        eta = R * eta  # optimistic decay (src/AdaProx.jl:513)
        trials = 0
        while True:  # inner linesearch (src/AdaProx.jl:516-533)
            trials += 1
            gamma_next = min(
                gamma * np.sqrt(1 + gamma / gamma_prev),
                1 / (2 * Theta * t * eta),
                gamma * np.sqrt(m4 / (2 * delta1 * (
                    big_delta + np.sqrt(big_delta**2 + m4 * (t * eta * gamma) ** 2)))),
            )
            rho = gamma_next / gamma
            sigma = t**2 * gamma_next
            w = y + sigma * ((1 + rho) * a_x - rho * a_x_prev)
            y_next = prox_hc(w, sigma)
            at_y_next = a.T @ y_next
            at_count += 1
            if eta >= np.linalg.norm(at_y_next - at_y) / np.linalg.norm(y_next - y):
                gamma, gamma_prev = gamma_next, gamma
                y, at_y = y_next, at_y_next
                break
            eta *= r
        gammas.append(gamma)
        sigmas.append(sigma)
        etas.append(eta)
        trials_hist.append(trials)
        at_hist.append(at_count)
        v = x - gamma * (grad_x + at_y)
        x_prev, a_x_prev, grad_prev = x, a_x, grad_x
        x = prox_g(v, gamma)
    return (np.array(gammas), np.array(sigmas), np.array(etas),
            np.array(trials_hist), np.array(at_hist), x)


def np_malitsky_pock(a_f, b_f, lam, yv, a, x0, y0, sigma0, t, iters):
    """malitsky_pock mirror (src/AdaProx.jl:555-629), same problem parts as
    np_adapdm_plus. Returns per-iteration (gamma, sigma, trial count,
    cumulative A_evals, cumulative f_evals)."""
    f_val = lambda x: 0.5 * np.sum((a_f @ x - b_f) ** 2)
    f_grad = lambda x: a_f.T @ (a_f @ x - b_f)
    prox_g = lambda v, gamma: soft(v, gamma * lam)
    prox_hc = lambda w, sigma: np_prox_translate_l2_conj(w, sigma, -yv)

    sigma = sigma0
    theta = 1.0  # never updated in the outer loop (src/AdaProx.jl:597)
    x, y = x0.copy(), y0.copy()
    a_x = a @ x
    at_y = a.T @ y
    a_count, f_count = 1, 0
    gammas, sigmas, trials_hist, a_hist, f_hist = [], [], [], [], []
    for _ in range(iters):
        at_y_prev = at_y
        w = y + sigma * a_x
        y = prox_hc(w, sigma)
        at_y = a.T @ y
        sigma_prev = sigma
        sigma = sigma * np.sqrt(1 + theta)
        f_x_prev = f_val(x)
        grad_prev = f_grad(x)
        f_count += 1
        x_prev, a_x_prev = x, a_x
        trials = 0
        while True:  # backtrack_stepsize_MP (src/AdaProx.jl:555-579)
            trials += 1
            th = sigma / sigma_prev
            gamma = t**2 * sigma
            at_ybar = (1 + th) * at_y - th * at_y_prev
            v = x_prev - gamma * (at_ybar + grad_prev)
            x = prox_g(v, gamma)
            a_x = a @ x
            f_x = f_val(x)
            a_count += 1
            f_count += 1
            lhs = gamma * sigma * np.linalg.norm(a_x - a_x_prev) ** 2 + 2 * gamma * (
                f_x - f_x_prev - grad_prev @ (x - x_prev))
            if lhs <= 0.95 * np.linalg.norm(x - x_prev) ** 2:
                break
            sigma /= 2
        gammas.append(gamma)
        sigmas.append(sigma)
        trials_hist.append(trials)
        a_hist.append(a_count)
        f_hist.append(f_count)
    return (np.array(gammas), np.array(sigmas), np.array(trials_hist),
            np.array(a_hist), np.array(f_hist), x)


@pytest.mark.parametrize("eta_frac", [1.0, 0.3])
def test_adapdm_plus_trajectory_matches_numpy_mirror(eta_frac):
    """Step-exact AdaPDM+ parity incl. inner-trial counts (VERDICT r2 #7):
    eta_frac < 1 underestimates ||A|| so the eta-inflation branch
    (src/AdaProx.jl:532) is genuinely exercised."""
    rng = np.random.default_rng(7)
    m, n = 40, 64
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    yv = rng.standard_normal(m)
    a_f = rng.standard_normal((20, n)) / np.sqrt(n)
    b_f = rng.standard_normal(20)
    lam, t, iters = 0.05, 1.0, 60
    eta0 = eta_frac * float(np.linalg.norm(a, 2))

    gam_np, sig_np, eta_np, trials_np, at_np, x_np = np_adapdm_plus(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), eta0, t, iters)
    assert trials_np.max() > 1 or eta_frac == 1.0  # inflation exercised

    from adaprox_tpu.models.objectives import LeastSquares

    res = ap.adaptive_linesearch_primal_dual(
        jnp.zeros(n), jnp.zeros(m),
        f=LeastSquares(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
        g=ap.L1Norm(lam=lam),
        h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
        A=ap.DenseOperator(a=jnp.asarray(a)),
        eta=eta0, t=t, tol=0.0, maxit=iters, history=True,
    )
    np.testing.assert_allclose(np.asarray(res.records.gamma), gam_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.sigma), sig_np, rtol=1e-7)
    # per-iteration inner-trial counts: each trial bumps At_evals once, so
    # the cumulative At_evals trajectory pins the exact trial sequence
    np.testing.assert_array_equal(np.asarray(res.records.At_evals), at_np)
    np.testing.assert_allclose(float(res.diag["eta"]), eta_np[-1], rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-9)


def test_malitsky_pock_trajectory_matches_numpy_mirror():
    """Step-exact Malitsky-Pock parity incl. backtracking trial counts
    (VERDICT r2 #7): sigma0 is set large enough that the sigma-halving
    branch (src/AdaProx.jl:566-579) fires repeatedly."""
    rng = np.random.default_rng(11)
    m, n = 40, 64
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    yv = rng.standard_normal(m)
    a_f = rng.standard_normal((20, n)) / np.sqrt(n)
    b_f = rng.standard_normal(20)
    lam, t, iters = 0.05, 1.0, 60
    sigma0 = 2.0 / float(np.linalg.norm(a, 2))  # deliberately too big

    gam_np, sig_np, trials_np, a_np_hist, f_np_hist, x_np = np_malitsky_pock(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), sigma0, t, iters)
    assert trials_np.max() > 1  # backtracking exercised

    from adaprox_tpu.models.objectives import LeastSquares

    res = ap.malitsky_pock(
        jnp.zeros(n), jnp.zeros(m),
        f=LeastSquares(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
        g=ap.L1Norm(lam=lam),
        h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
        A=ap.DenseOperator(a=jnp.asarray(a)),
        sigma=sigma0, t=t, tol=0.0, maxit=iters, history=True,
    )
    np.testing.assert_allclose(np.asarray(res.records.gamma), gam_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.sigma), sig_np, rtol=1e-7)
    # trial counts: each trial bumps A_evals once (and f_evals once on top
    # of the per-iteration f_x_prev eval) — cumulative counters pin them
    np.testing.assert_array_equal(np.asarray(res.records.A_evals), a_np_hist)
    np.testing.assert_array_equal(np.asarray(res.records.f_evals), f_np_hist)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("t", [0.1, 1.0])
def test_pd_trajectory_matches_numpy_mirror(t):
    rng = np.random.default_rng(3)
    n = 24
    feats = rng.standard_normal((n, 5))
    labels = np.sign(rng.standard_normal(n))
    labels[labels == 0] = 1
    q = (labels[:, None] * feats) @ (labels[:, None] * feats).T
    qv = -np.ones(n)
    big_c = 0.5
    norm_a = float(np.linalg.norm(labels))
    iters = 80

    gammas_np, res_np = np_adaptive_pd(q, qv, labels, big_c, t, norm_a, iters)

    res = ap.adaptive_primal_dual(
        jnp.zeros(n), jnp.zeros(1),
        f=Quadratic(q_mat=jnp.asarray(q), q_vec=jnp.asarray(qv)),
        g=ap.IndBox(lo=0.0, hi=big_c), h=ap.IndZero(),
        A=ap.DenseOperator(a=jnp.asarray(labels[None, :])),
        rule=ap.AdaPGMRule.make(t=t, norm_a=norm_a),
        tol=0.0, maxit=iters, history=True,
    )
    np.testing.assert_allclose(np.asarray(res.records.gamma), gammas_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), res_np, rtol=1e-7)


# --- backtracking PG / Nesterov mirrors (src/AdaProx.jl:35-89) --------------


def np_backtrack_stepsize(gamma, a, b, lam, x, f_x, grad_x, shrink=0.5):
    """backtrack_stepsize (src/AdaProx.jl:35-49); returns the per-call
    f-eval count (= trials) so trial-count equality is assertable."""
    f = lambda z: 0.5 * np.sum((a @ z - b) ** 2)

    def ub(z, gam):
        d = z - x
        return f_x + grad_x @ d + (d @ d) / (2 * gam)

    z = soft(x - gamma * grad_x, gamma * lam)
    f_z = f(z)
    trials = 1
    while f_z > ub(z, gamma):
        gamma *= shrink
        z = soft(x - gamma * grad_x, gamma * lam)
        f_z = f(z)
        trials += 1
    g_z = lam * np.abs(z).sum()
    return gamma, z, f_z, g_z, trials


def np_backtracking(a, b, lam, gamma0, iters, xi=1.0, nesterov=False):
    """backtracking_proxgrad (:51-66, trial step xi*gamma) and
    backtracking_nesterov (:68-89, no inflation, theta momentum).
    Returns per-iteration gammas, norm_res, and CUMULATIVE f/prox counts at
    the log site (grad_f_evals excluded: identical by construction)."""
    x = z = np.zeros(a.shape[1])
    gamma = gamma0
    theta = 1.0
    f_x = 0.5 * np.sum((a @ x - b) ** 2)
    grad_x = a.T @ (a @ x - b)
    f_evals, prox_evals = 1, 0  # eval_with_gradient counts one f eval
    gammas, nres, f_seq, prox_seq = [], [], [], []
    for _ in range(iters):
        z_prev = z
        trial = gamma if nesterov else xi * gamma
        gamma, z, f_z, g_z, trials = np_backtrack_stepsize(
            trial, a, b, lam, x, f_x, grad_x)
        f_evals += trials
        prox_evals += trials
        gammas.append(gamma)
        nres.append(np.linalg.norm(z - x) / gamma)
        f_seq.append(f_evals)
        prox_seq.append(prox_evals)
        if nesterov:
            theta_prev = theta
            theta = (1 + np.sqrt(1 + 4 * theta_prev**2)) / 2
            x = z + (theta_prev - 1) / theta * (z - z_prev)
            f_x = 0.5 * np.sum((a @ x - b) ** 2)
            grad_x = a.T @ (a @ x - b)
            f_evals += 1
        else:
            x, f_x = z, f_z
            grad_x = a.T @ (a @ x - b)
    return (np.array(gammas), np.array(nres), np.array(f_seq),
            np.array(prox_seq), z)


@pytest.mark.parametrize("nesterov,xi", [(False, 1.0), (False, 2.0),
                                         (True, 1.0)])
def test_backtracking_trajectory_matches_numpy_mirror(nesterov, xi):
    rng = np.random.default_rng(7)
    m, n = 30, 50
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.3
    # start too LARGE so the linesearch actually shrinks (trial counts > 1)
    gamma0 = 10.0 / np.linalg.norm(a, 2) ** 2
    iters = 40

    g_np, r_np, f_np, p_np, z_np = np_backtracking(
        a, b, lam, gamma0, iters, xi=xi, nesterov=nesterov)

    fn = ap.backtracking_nesterov if nesterov else ap.backtracking_proxgrad
    kw = {} if nesterov else {"xi": xi}
    res = fn(jnp.zeros(n), f=LeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)),
             g=ap.L1Norm(lam=lam), gamma0=gamma0, tol=0.0, maxit=iters,
             history=True, **kw)
    np.testing.assert_allclose(np.asarray(res.records.gamma), g_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), r_np,
                               rtol=1e-6)
    # per-iteration TRIAL counts: cumulative f/prox evals at each log site
    np.testing.assert_array_equal(np.asarray(res.records.f_evals), f_np)
    np.testing.assert_array_equal(np.asarray(res.records.prox_g_evals), p_np)
    np.testing.assert_allclose(np.asarray(res.x), z_np, rtol=1e-6, atol=1e-10)


# --- fixed Nesterov mirror (src/AdaProx.jl:96-146) --------------------------


def np_fixed_nesterov(a, b, lam, gamma, muf, mug, iters):
    x = x_prev = np.zeros(a.shape[1])
    mu = muf + mug
    q = gamma * mu / (1 + gamma * mug)
    theta = 1 / np.sqrt(q) if q > 0 else 0.0
    nres = []
    for _ in range(iters):
        theta_prev = theta
        if mu == 0:
            theta = (1 + np.sqrt(1 + 4 * theta_prev**2)) / 2
            beta = (theta_prev - 1) / theta
        else:
            aq = 1 - q * theta_prev**2
            theta = (aq + np.sqrt(aq**2 + 4 * theta_prev**2)) / 2
            beta = ((theta_prev - 1) * (1 + gamma * mug - theta * gamma * mu)
                    / theta / (1 - gamma * muf))
        z = x + beta * (x - x_prev)
        grad_z = a.T @ (a @ z - b)
        x_prev = x
        x = soft(z - gamma * grad_z, gamma * lam)
        nres.append(np.linalg.norm(x - z) / gamma)
    return np.array(nres), x


@pytest.mark.parametrize("muf", [0.0, 0.5])
def test_fixed_nesterov_trajectory_matches_numpy_mirror(muf):
    rng = np.random.default_rng(3)
    m, n = 60, 40  # overdetermined so muf>0 is honest
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.3
    lf = np.linalg.norm(a, 2) ** 2
    gamma = 1 / lf
    iters = 50

    r_np, x_np = np_fixed_nesterov(a, b, lam, gamma, muf, 0.0, iters)
    res = ap.fixed_nesterov(
        jnp.zeros(n), f=LeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)),
        g=ap.L1Norm(lam=lam), gamma=gamma, muf=muf, tol=0.0, maxit=iters,
        history=True)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), r_np,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-10)


# --- aGRAAL mirror (src/AdaProx.jl:150-192) ---------------------------------


def np_agraal(a, b, lam, x1, x0, gamma0, gamma_max, phi, iters):
    x, x_prev, x_bar = x1, x0, x1
    grad = lambda v: a.T @ (a @ v - b)
    grad_x, grad_x_prev = grad(x), grad(x_prev)
    gamma = gamma0
    rho = 1 / phi + 1 / phi**2
    theta = 1.0
    gammas, nres = [], []
    for _ in range(iters):
        c = (np.linalg.norm(x - x_prev) ** 2
             / np.linalg.norm(grad_x - grad_x_prev) ** 2)
        gamma_prev = gamma
        gamma = min(rho * gamma_prev, phi * theta * c / (4 * gamma_prev),
                    gamma_max)
        theta = phi * gamma / gamma_prev
        x_bar = ((phi - 1) * x + x_bar) / phi
        x_prev, grad_x_prev = x, grad_x
        x = soft(x_bar - gamma * grad_x_prev, gamma * lam)
        gammas.append(gamma)
        nres.append(np.linalg.norm(x - x_prev) / gamma)
        grad_x = grad(x)
    return np.array(gammas), np.array(nres), x


def test_agraal_trajectory_matches_numpy_mirror():
    rng = np.random.default_rng(11)
    m, n = 30, 50
    a = rng.standard_normal((m, n))
    b = rng.standard_normal(m)
    lam = 0.3
    x1 = np.zeros(n)
    x0 = x1 + rng.standard_normal(n)  # the reference's random perturbation
    gamma0 = 1e-3
    iters = 60

    g_np, r_np, x_np = np_agraal(a, b, lam, x1, x0, gamma0, 1e6, 1.5, iters)
    res = ap.agraal(
        jnp.asarray(x1), f=LeastSquares(a=jnp.asarray(a), b=jnp.asarray(b)),
        g=ap.L1Norm(lam=lam), x0=jnp.asarray(x0), gamma0=gamma0,
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma), g_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), r_np,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-10)


# --- Condat-Vu mirror: generic PD loop + FixedStepsize (src/AdaProx.jl:
#     312-364 driven by :396-416's gamma/sigma heuristics) -----------------


def np_condat_vu(a_f, b_f, lam, yv, a, x0, y0, lf, iters):
    """Generic adaptive_primal_dual loop with the FixedStepsize rule and the
    Condat-Vu parameter heuristics (par=5, par2=100, src/AdaProx.jl:399-412);
    f = least squares, g = L1, h = Translate(NormL2, -yv)."""
    par, par2 = 5.0, 100.0
    norm_a = np.linalg.norm(a)  # Julia norm(A): Frobenius
    alpha = 1.0 if norm_a > par * lf else par2 * norm_a / lf
    gamma = 1.0 / (lf / 2 + norm_a / alpha)
    sigma = 0.99 / (norm_a * alpha)

    grad = lambda v: a_f.T @ (a_f @ v - b_f)
    x, y = x0.copy(), y0.copy()
    a_x = a @ x
    grad_x = grad(x)
    at_y = a.T @ y
    v = x - gamma * (grad_x + at_y)
    x_prev, a_x_prev = x, a_x
    x = soft(v, gamma * lam)
    nres = []
    for _ in range(iters):
        a_x = a @ x
        grad_x = grad(x)
        primal = (v - x) / gamma + grad_x + at_y
        rho = 1.0  # fixed rule
        w = y + sigma * ((1 + rho) * a_x - rho * a_x_prev)
        y = np_prox_translate_l2_conj(w, sigma, -yv, lam=1.0)
        dual = (w - y) / sigma - a_x
        nres.append(np.sqrt(primal @ primal + dual @ dual))
        at_y = a.T @ y
        v = x - gamma * (grad_x + at_y)
        x_prev, a_x_prev = x, a_x
        x = soft(v, gamma * lam)
    return np.array(nres), x, gamma, sigma


def test_condat_vu_trajectory_matches_numpy_mirror():
    rng = np.random.default_rng(5)
    m, n = 20, 30
    a_f = rng.standard_normal((m, n))
    b_f = rng.standard_normal(m)
    a = rng.standard_normal((m, n))
    yv = rng.standard_normal(m)
    lam = 0.3
    lf = np.linalg.norm(a_f, 2) ** 2
    iters = 50

    r_np, x_np, gamma_np, sigma_np = np_condat_vu(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), lf, iters)
    res = ap.condat_vu(
        jnp.zeros(n), jnp.zeros(m),
        f=LeastSquares(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
        g=ap.L1Norm(lam=lam),
        h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
        A=ap.DenseOperator(a=jnp.asarray(a)), Lf=lf,
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma),
                               np.full(iters, gamma_np), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res.records.sigma),
                               np.full(iters, sigma_np), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), r_np,
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-10)


# --- the engine on the problems the old whole-solve kernels covered ---------
#
# Dual SVM (dense Gram and factored), logistic regression, the cubic model,
# Condat-Vu with an L1 inner term, the Malitsky-Pock and AdaPDM+ t-sweeps
# as ONE vmapped program, and bf16 storage — each against the f64 NumPy
# mirror of the reference loop.


def _dsvm(seed=3, n=24, d=5):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d))
    labels = np.sign(rng.standard_normal(n))
    labels[labels == 0] = 1
    bmat = labels[:, None] * feats
    return bmat, labels


@pytest.mark.parametrize("t", [0.05, 0.5, 2.0, 10.0])
@pytest.mark.parametrize("form", ["dense", "factored"])
def test_dsvm_tsweep_matches_numpy_mirror(form, t):
    """Dual-SVM AdaPDM rows of the reference t-grid (dual_svm/runme.jl:61),
    Gram dense (Quadratic) or gram-free (FactoredQuadratic), against the
    mirror on the explicit Gram."""
    from adaprox_tpu.models.objectives import FactoredQuadratic

    bmat, labels = _dsvm()
    q = bmat @ bmat.T
    qv = -np.ones(q.shape[0])
    big_c, iters = 0.5, 60
    norm_a = float(np.linalg.norm(labels))
    gammas_np, res_np = np_adaptive_pd(q, qv, labels, big_c, t, norm_a, iters)
    f = (Quadratic(q_mat=jnp.asarray(q), q_vec=jnp.asarray(qv)) if form == "dense"
         else FactoredQuadratic(b_mat=jnp.asarray(bmat), q_vec=jnp.asarray(qv)))
    res = ap.adaptive_primal_dual(
        jnp.zeros(q.shape[0]), jnp.zeros(1), f=f,
        g=ap.IndBox(lo=0.0, hi=big_c), h=ap.IndZero(),
        A=ap.DenseOperator(a=jnp.asarray(labels[None, :])),
        rule=ap.AdaPGMRule.make(t=t, norm_a=norm_a),
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma), gammas_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), res_np,
                               rtol=1e-6, atol=1e-12)


def np_adaptive_proxgrad_grad(grad, n, prox, gamma0, rule_update, state0, iters):
    """np_adaptive_proxgrad for any gradient and prox (same loop)."""
    x = np.zeros(n)
    gamma, state = gamma0, state0
    g = grad(x)
    v = x - gamma * g
    x_prev, g_prev = x, g
    x = prox(v, gamma)
    gammas = []
    for _ in range(iters):
        g_x = grad(x)
        gamma, state = rule_update(state, x, g_x, x_prev, g_prev)
        v = x - gamma * g_x
        x_prev, g_prev = x, g_x
        x = prox(v, gamma)
        gammas.append(gamma)
    return np.array(gammas), x


def _rule(rule_name, gamma0):
    if rule_name == "ours":
        return np_adapgm_rule, (gamma0, gamma0), ap.AdaPGMRule(gamma=gamma0)
    return np_mm_rule, (gamma0, np.inf), ap.MalitskyMishchenkoRule(gamma=gamma0)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rule_name", ["ours", "mm"])
def test_logreg_trajectory_matches_numpy_mirror(rule_name, seed):
    """L1 logistic regression (sparse_logreg/runme.jl:23-39, bias folded in
    the last coordinate) under both adaptive rules."""
    from adaprox_tpu.models.objectives import LogisticLoss

    rng = np.random.default_rng(seed)
    m, d = 60, 12
    xm = rng.standard_normal((m, d))
    y = (rng.random(m) > 0.5).astype(float)
    # 15 iterations: the residual reaches ~1e-7 there; past the f64 floor
    # the rule's ratios are ratios of rounding noise and trajectories part
    lam, iters = 0.01, 15

    def grad(w):
        p = 1.0 / (1.0 + np.exp(-(xm @ w[:-1] + w[-1])))
        return np.concatenate([xm.T @ (p - y) / m, [np.mean(p - y)]])

    x1 = np.hstack([xm, np.ones((m, 1))])
    gamma0 = 4 * m / np.linalg.norm(x1.T @ x1)
    np_rule, state0, jx_rule = _rule(rule_name, gamma0)
    g_np, x_np = np_adaptive_proxgrad_grad(
        grad, d + 1, lambda v, gam: soft(v, gam * lam), gamma0, np_rule,
        state0, iters)
    res = ap.adaptive_proxgrad(
        jnp.zeros(d + 1), f=LogisticLoss(x=jnp.asarray(xm), y=jnp.asarray(y)),
        g=ap.L1Norm(lam=lam), rule=jx_rule, tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma), g_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("c", [0.0, 1.0])
@pytest.mark.parametrize("rule_name", ["ours", "mm"])
def test_cubic_trajectory_matches_numpy_mirror(rule_name, c):
    """The cubic model (cubic_sparse_logreg/runme.jl:26-32; c = 0 is the
    plain quadratic of nesterov_worst_case) with g = 0."""
    from adaprox_tpu.models.objectives import Cubic

    rng = np.random.default_rng(4)
    n = 20
    r = rng.standard_normal((n, n))
    q = r @ r.T / n + 0.1 * np.eye(n)
    qv = rng.standard_normal(n)
    iters = 15  # before the residual reaches the f64 floor (see logreg)

    def grad(x):
        return q @ x + qv + (c * np.linalg.norm(x) / 2) * x

    gamma0 = 0.5 / np.linalg.norm(q, 2)
    np_rule, state0, jx_rule = _rule(rule_name, gamma0)
    g_np, x_np = np_adaptive_proxgrad_grad(
        grad, n, lambda v, gam: v, gamma0, np_rule, state0, iters)
    res = ap.adaptive_proxgrad(
        jnp.zeros(n), f=Cubic(q_mat=jnp.asarray(q), q_vec=jnp.asarray(qv),
                              c=jnp.asarray(c)),
        g=ap.Zero(), rule=jx_rule, tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma), g_np, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.x), x_np, rtol=1e-6, atol=1e-10)


def np_prox_translate_l1_conj(w, sigma, b):
    """prox of (Translate(NormL1, b))^* via Moreau (cf. the L2 version)."""
    u = w / sigma
    inner = soft(u + b, 1.0 / sigma) - b
    return w - sigma * inner


@pytest.mark.parametrize("seed", [5, 6])
def test_condat_vu_l1_inner_matches_numpy_mirror(seed):
    """Condat-Vu on the least-absolute-deviation shape: h = Translate(L1)."""
    rng = np.random.default_rng(seed)
    m, n = 20, 30
    a_f = rng.standard_normal((m, n))
    b_f = rng.standard_normal(m)
    a = rng.standard_normal((m, n))
    yv = rng.standard_normal(m)
    lam, iters = 0.3, 50
    lf = np.linalg.norm(a_f, 2) ** 2
    par, par2 = 5.0, 100.0
    norm_a = np.linalg.norm(a)
    alpha = 1.0 if norm_a > par * lf else par2 * norm_a / lf
    gamma = 1.0 / (lf / 2 + norm_a / alpha)
    sigma = 0.99 / (norm_a * alpha)
    grad = lambda v: a_f.T @ (a_f @ v - b_f)
    x, y = np.zeros(n), np.zeros(m)
    a_x, grad_x, at_y = a @ x, grad(x), a.T @ y
    v = x - gamma * (grad_x + at_y)
    a_x_prev = a_x
    x = soft(v, gamma * lam)
    nres = []
    for _ in range(iters):
        a_x, grad_x = a @ x, grad(x)
        primal = (v - x) / gamma + grad_x + at_y
        w = y + sigma * (2 * a_x - a_x_prev)
        y = np_prox_translate_l1_conj(w, sigma, -yv)
        dual = (w - y) / sigma - a_x
        nres.append(np.sqrt(primal @ primal + dual @ dual))
        at_y = a.T @ y
        v = x - gamma * (grad_x + at_y)
        a_x_prev = a_x
        x = soft(v, gamma * lam)
    res = ap.condat_vu(
        jnp.zeros(n), jnp.zeros(m),
        f=LeastSquares(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
        g=ap.L1Norm(lam=lam),
        h=ap.Translate(inner=ap.L1Norm(lam=1.0), b=-jnp.asarray(yv)),
        A=ap.DenseOperator(a=jnp.asarray(a)), Lf=lf,
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), nres, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.x), x, rtol=1e-6, atol=1e-10)


def _pd_linesearch_problem(seed):
    rng = np.random.default_rng(seed)
    m, n = 40, 64
    a = rng.standard_normal((m, n)) / np.sqrt(n)
    yv = rng.standard_normal(m)
    a_f = rng.standard_normal((20, n)) / np.sqrt(n)
    b_f = rng.standard_normal(20)
    return a, yv, a_f, b_f


def _pd_parts(a, yv, a_f, b_f, lam):
    return dict(f=LeastSquares(a=jnp.asarray(a_f), b=jnp.asarray(b_f)),
                g=ap.L1Norm(lam=lam),
                h=ap.Translate(inner=ap.L2Norm(lam=1.0), b=-jnp.asarray(yv)),
                A=ap.DenseOperator(a=jnp.asarray(a)))


TS = [0.2, 1.0, 5.0]


@pytest.mark.parametrize("i", range(len(TS)))
def test_mp_tsweep_vmapped_matches_numpy_mirror(i):
    """The Malitsky-Pock t-sweep as ONE vmapped program: row i against the
    mirror at t = TS[i] (trial counts included)."""
    import jax

    a, yv, a_f, b_f = _pd_linesearch_problem(11)
    m, n = a.shape
    lam, iters = 0.05, 40
    sigma0 = 2.0 / float(np.linalg.norm(a, 2))
    parts = _pd_parts(a, yv, a_f, b_f, lam)

    def one(t):
        res = ap.malitsky_pock(jnp.zeros(n), jnp.zeros(m), sigma=sigma0, t=t,
                               tol=0.0, maxit=iters, history=True, **parts)
        return res.records.gamma, res.records.A_evals, res.x

    gam, a_ev, xs = jax.vmap(one)(jnp.asarray(TS))
    g_np, _, _, a_np, _, x_np = np_malitsky_pock(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), sigma0, TS[i], iters)
    np.testing.assert_allclose(np.asarray(gam[i]), g_np, rtol=1e-7)
    np.testing.assert_array_equal(np.asarray(a_ev[i]), a_np)
    np.testing.assert_allclose(np.asarray(xs[i]), x_np, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("i", range(len(TS)))
def test_adapdm_plus_tsweep_vmapped_matches_numpy_mirror(i):
    """The AdaPDM+ t-sweep as ONE vmapped program, row i against the
    mirror at t = TS[i] with eta underestimated (inflation exercised)."""
    import jax

    a, yv, a_f, b_f = _pd_linesearch_problem(7)
    m, n = a.shape
    lam, iters = 0.05, 40
    eta0 = 0.3 * float(np.linalg.norm(a, 2))
    parts = _pd_parts(a, yv, a_f, b_f, lam)

    def one(t):
        res = ap.adaptive_linesearch_primal_dual(
            jnp.zeros(n), jnp.zeros(m), eta=eta0, t=t, tol=0.0, maxit=iters,
            history=True, **parts)
        return res.records.gamma, res.records.At_evals, res.x

    gam, at_ev, xs = jax.vmap(one)(jnp.asarray(TS))
    g_np, _, _, _, at_np, x_np = np_adapdm_plus(
        a_f, b_f, lam, yv, a, np.zeros(n), np.zeros(m), eta0, TS[i], iters)
    np.testing.assert_allclose(np.asarray(gam[i]), g_np, rtol=1e-7)
    np.testing.assert_array_equal(np.asarray(at_ev[i]), at_np)
    np.testing.assert_allclose(np.asarray(xs[i]), x_np, rtol=1e-6, atol=1e-9)


# bf16 storage: the matrix is stored in bf16, iterates and accumulation are
# f32. The mirror runs in f64 on the SAME bf16-rounded matrix, so the only
# difference is f32 arithmetic, which the adaptive rule amplifies through
# its gradient-difference ratios: 2e-3 relative over these short runs.
BF16_RTOL = 2e-3


def _bf16_round(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float64))


@pytest.mark.parametrize("rule_name", ["ours", "mm"])
def test_bf16_storage_pg_matches_numpy_mirror(rule_name):
    rng = np.random.default_rng(2)
    m, n = 30, 50
    a = _bf16_round(rng.standard_normal((m, n)))
    b = rng.standard_normal(m).astype(np.float32).astype(np.float64)
    lam, iters = 0.3, 20
    gamma0 = 1.0 / np.linalg.norm(a, 2) ** 2
    np_rule, state0, _ = _rule(rule_name, gamma0)
    g_np, xs_np = np_adaptive_proxgrad(a, b, lam, gamma0, np_rule, state0, iters)
    jx_rule = (ap.AdaPGMRule(gamma=jnp.float32(gamma0)) if rule_name == "ours"
               else ap.MalitskyMishchenkoRule(gamma=jnp.float32(gamma0)))
    res = ap.adaptive_proxgrad(
        jnp.zeros(n, jnp.float32),
        f=LeastSquares(a=jnp.asarray(a, jnp.bfloat16), b=jnp.asarray(b, jnp.float32)),
        g=ap.L1Norm(lam=jnp.float32(lam)), rule=jx_rule, tol=0.0, maxit=iters,
        history=True)
    assert res.x.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(res.records.gamma), g_np, rtol=BF16_RTOL)
    np.testing.assert_allclose(np.asarray(res.x), xs_np[-1], rtol=BF16_RTOL,
                               atol=1e-5)


def test_bf16_storage_dsvm_matches_numpy_mirror():
    from adaprox_tpu.models.objectives import FactoredQuadratic

    bmat, labels = _dsvm(seed=8)
    bmat = _bf16_round(bmat)
    q = bmat @ bmat.T
    qv = -np.ones(q.shape[0])
    big_c, t, iters = 0.5, 1.0, 40
    norm_a = float(np.linalg.norm(labels))
    gammas_np, res_np = np_adaptive_pd(q, qv, labels, big_c, t, norm_a, iters)
    f32 = jnp.float32
    res = ap.adaptive_primal_dual(
        jnp.zeros(q.shape[0], f32), jnp.zeros(1, f32),
        f=FactoredQuadratic(b_mat=jnp.asarray(bmat, jnp.bfloat16),
                            q_vec=jnp.asarray(qv, f32)),
        g=ap.IndBox(lo=0.0, hi=big_c), h=ap.IndZero(),
        A=ap.DenseOperator(a=jnp.asarray(labels[None, :], f32)),
        rule=ap.AdaPGMRule.make(t=f32(t), norm_a=f32(norm_a)),
        tol=0.0, maxit=iters, history=True)
    np.testing.assert_allclose(np.asarray(res.records.gamma), gammas_np,
                               rtol=BF16_RTOL)
    np.testing.assert_allclose(np.asarray(res.records.norm_res), res_np,
                               rtol=1e-3, atol=1e-5)
