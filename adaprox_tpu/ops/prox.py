"""Proximable functions (the `g` and `h` parts of min f(x) + g(x) + h(Ax)).

A JAX re-design of the behavioral surface the reference pulls in from
ProximalCore.jl / ProximalOperators.jl (see reference src/AdaProx.jl:5 and the
experiment drivers, e.g. experiments/lasso/runme.jl:11, dual_svm/runme.jl:14-16,
square_root_lasso/runme.jl:13,40-42).

Every operator is a pure pytree dataclass with:

  * ``op(x)``            -> the (extended-real) function value at x
  * ``op.prox(v, gamma)``-> ``(y, g_y)`` with y = argmin_z g(z) + ||z-v||^2/(2*gamma)
                            and g_y = g(y), mirroring ProximalCore's
                            ``prox(g, v, gamma) -> (y, g_y)``
  * ``conjugate(op)``    -> the convex conjugate, analytic where known and a
                            Moreau-identity wrapper otherwise (reference uses
                            ``convex_conjugate`` at src/AdaProx.jl:325,492,594)

All prox maps are elementwise/VPU-friendly closed forms; XLA fuses them into
the surrounding update (x <- prox(x - gamma * d)). Numeric fields (lam, lo,
hi, ...) are dynamic pytree leaves so solvers can be vmap-ed over them
(regularization paths, box sweeps).
"""

from __future__ import annotations

import jax.numpy as jnp

from .._pytree import pytree_dataclass

__all__ = [
    "Zero",
    "L1Norm",
    "L2Norm",
    "SqrL2Norm",
    "IndBox",
    "IndBall2",
    "IndZero",
    "ElasticNet",
    "GroupL2",
    "IndSimplex",
    "IndBall1",
    "LInfNorm",
    "Huber",
    "NuclearNorm",
    "IndPSD",
    "HingeLoss",
    "LogBarrier",
    "IndHalfspace",
    "IndHyperplane",
    "SeparableSum",
    "Scale",
    "Translate",
    "MoreauConjugate",
    "conjugate",
]



@pytree_dataclass
class Zero:
    """g(x) = 0; prox is the identity (ProximalCore.Zero)."""

    def __call__(self, x):
        return jnp.zeros((), dtype=jnp.result_type(x))

    def prox(self, v, gamma):
        del gamma
        return v, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class IndZero:
    """Indicator of {0}; prox maps everything to 0 (ProximalCore.IndZero)."""

    def __call__(self, x):
        zero = jnp.zeros((), dtype=jnp.result_type(x))
        ok = jnp.all(x == 0)
        return jnp.where(ok, zero, jnp.inf)

    def prox(self, v, gamma):
        del gamma
        return jnp.zeros_like(v), jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class L1Norm:
    """g(x) = lam * ||x||_1; prox = soft-thresholding (NormL1 in the reference)."""

    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.lam * jnp.sum(jnp.abs(x))

    def prox(self, v, gamma):
        thr = gamma * self.lam
        y = jnp.sign(v) * jnp.maximum(jnp.abs(v) - thr, 0)
        return y, self(y)


@pytree_dataclass
class L2Norm:
    """g(x) = lam * ||x||_2; prox = block soft-thresholding (NormL2)."""

    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.lam * jnp.sqrt(jnp.sum(x * x))

    def prox(self, v, gamma):
        nrm = jnp.sqrt(jnp.sum(v * v))
        thr = gamma * self.lam
        scale = jnp.where(nrm > thr, 1 - thr / jnp.where(nrm > 0, nrm, 1.0), 0.0)
        y = scale * v
        return y, self.lam * scale * nrm


@pytree_dataclass
class SqrL2Norm:
    """g(x) = (lam/2) * ||x||_2^2; prox = shrinkage v / (1 + gamma*lam)."""

    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        return 0.5 * self.lam * jnp.sum(x * x)

    def prox(self, v, gamma):
        y = v / (1 + gamma * self.lam)
        return y, self(y)


@pytree_dataclass
class IndBox:
    """Indicator of the box [lo, hi]; prox = clamp (IndBox in the reference,
    used by dual SVM at experiments/dual_svm/runme.jl:52)."""

    lo: jnp.ndarray = -jnp.inf
    hi: jnp.ndarray = jnp.inf

    def __call__(self, x):
        zero = jnp.zeros((), dtype=jnp.result_type(x))
        ok = jnp.all((x >= self.lo) & (x <= self.hi))
        return jnp.where(ok, zero, jnp.inf)

    def prox(self, v, gamma):
        del gamma
        y = jnp.clip(v, self.lo, self.hi)
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class IndBall2:
    """Indicator of the L2 ball of radius r; prox = radial projection.

    Arises as the conjugate of L2Norm(r)."""

    r: jnp.ndarray = 1.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        zero = jnp.zeros((), dtype=dt)
        nrm = jnp.sqrt(jnp.sum(x * x))
        # dtype-relative tolerance: the radial projection lands exactly on
        # the boundary in exact arithmetic but its recomputed norm can
        # overshoot by a few ulp (a fixed 1e-12 is BELOW f32 eps, so the
        # indicator of the prox's own output read inf in f32)
        eps = jnp.finfo(dt).eps
        ok = nrm <= self.r * (1 + 8 * eps) + jnp.finfo(dt).tiny
        return jnp.where(ok, zero, jnp.inf)

    def prox(self, v, gamma):
        del gamma
        nrm = jnp.sqrt(jnp.sum(v * v))
        scale = jnp.where(nrm > self.r, self.r / jnp.where(nrm > 0, nrm, 1.0), 1.0)
        y = scale * v
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class ElasticNet:
    """g(x) = lam1 * ||x||_1 + (lam2/2) * ||x||_2^2; prox = soft-threshold
    then shrink (closed form). Beyond the reference's operator set."""

    lam1: jnp.ndarray = 1.0
    lam2: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.lam1 * jnp.sum(jnp.abs(x)) + 0.5 * self.lam2 * jnp.sum(x * x)

    def prox(self, v, gamma):
        soft = jnp.sign(v) * jnp.maximum(jnp.abs(v) - gamma * self.lam1, 0)
        y = soft / (1 + gamma * self.lam2)
        return y, self(y)


@pytree_dataclass(meta=("n_groups",))
class GroupL2:
    """Group lasso penalty: g(x) = lam * sum_g ||x_g||_2 over ``n_groups``
    equal contiguous groups; prox = per-group block soft-thresholding.
    Beyond the reference's operator set."""

    n_groups: int
    lam: jnp.ndarray = 1.0

    def _blocks(self, x):
        return x.reshape(self.n_groups, -1)

    def __call__(self, x):
        blocks = self._blocks(x)
        return self.lam * jnp.sum(jnp.sqrt(jnp.sum(blocks * blocks, axis=1)))

    def prox(self, v, gamma):
        blocks = self._blocks(v)
        nrm = jnp.sqrt(jnp.sum(blocks * blocks, axis=1, keepdims=True))
        thr = gamma * self.lam
        scale = jnp.where(nrm > thr, 1 - thr / jnp.where(nrm > 0, nrm, 1.0), 0.0)
        y = (scale * blocks).reshape(v.shape)
        return y, self(y)


def _project_simplex(v, r):
    """Euclidean projection of ``v`` onto {x >= 0, sum(x) = r} (Held et al.
    1974 / Duchi et al. 2008 sort-based algorithm). Static shapes, one
    XLA sort — jit/vmap friendly."""
    n = v.shape[0]
    u = jnp.sort(v)[::-1]
    css = jnp.cumsum(u) - r
    k = jnp.arange(1, n + 1, dtype=v.dtype)
    rho = jnp.sum(u - css / k > 0)  # >= 1 whenever r > 0
    # r == 0 (e.g. a lam=0 point in a vmapped sweep) gives rho == 0; clamp
    # to 1 so tau = max(v) and the projection is exactly 0 everywhere
    rho = jnp.maximum(rho, 1)
    tau = jnp.take(css, rho - 1) / rho.astype(v.dtype)
    return jnp.maximum(v - tau, 0)


@pytree_dataclass
class IndSimplex:
    """Indicator of the scaled probability simplex {x >= 0, sum(x) = r};
    prox = sort-based Euclidean projection. Beyond the reference's operator
    set (ProximalOperators.IndSimplex equivalent)."""

    r: jnp.ndarray = 1.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        eps = jnp.finfo(dt).eps
        tol = x.size * eps * jnp.maximum(1.0, jnp.abs(self.r))
        ok = jnp.all(x >= -tol) & (jnp.abs(jnp.sum(x) - self.r) <= tol)
        return jnp.where(ok, jnp.zeros((), dt), jnp.inf)

    def prox(self, v, gamma):
        del gamma
        y = _project_simplex(v, self.r)
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class IndBall1:
    """Indicator of the L1 ball of radius r; prox = L1-ball projection
    (sign-split simplex projection). Arises as the conjugate of LInfNorm."""

    r: jnp.ndarray = 1.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        eps = jnp.finfo(dt).eps
        nrm = jnp.sum(jnp.abs(x))
        ok = nrm <= self.r * (1 + 8 * x.size * eps) + jnp.finfo(dt).tiny
        return jnp.where(ok, jnp.zeros((), dt), jnp.inf)

    def prox(self, v, gamma):
        del gamma
        a = jnp.abs(v)
        w = _project_simplex(a, self.r)
        y = jnp.where(jnp.sum(a) <= self.r, v, jnp.sign(v) * w)
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class LInfNorm:
    """g(x) = lam * ||x||_inf; prox via the Moreau decomposition against the
    L1 ball: prox_{gamma g}(v) = v - P_{B1(gamma*lam)}(v)."""

    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.lam * jnp.max(jnp.abs(x))

    def prox(self, v, gamma):
        y = v - IndBall1(r=gamma * self.lam).prox(v, 1.0)[0]
        return y, self(y)


@pytree_dataclass
class Huber:
    """g(x) = lam * sum_i huber_delta(x_i) with huber_delta(t) = t^2/2 for
    |t| <= delta, delta*|t| - delta^2/2 beyond; prox is the elementwise
    closed form (shrink inside the quadratic zone, constant step outside)."""

    delta: jnp.ndarray = 1.0
    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        a = jnp.abs(x)
        per = jnp.where(a <= self.delta, 0.5 * x * x,
                        self.delta * a - 0.5 * self.delta * self.delta)
        return self.lam * jnp.sum(per)

    def prox(self, v, gamma):
        ge = gamma * self.lam  # effective stepsize of the unit-scale huber
        y = jnp.where(jnp.abs(v) <= self.delta * (1 + ge),
                      v / (1 + ge),
                      v - ge * self.delta * jnp.sign(v))
        return y, self(y)


@pytree_dataclass(meta=("p", "q"))
class NuclearNorm:
    """g(X) = lam * sum of singular values of the (p, q) matrix stored in
    the flat iterate; prox = singular-value soft-thresholding. Gives the
    solver family low-rank matrix problems (matrix completion / RPCA-style
    g) beyond the reference's vector-only operator set."""

    p: int
    q: int
    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        s = jnp.linalg.svd(x.reshape(self.p, self.q), compute_uv=False)
        return self.lam * jnp.sum(s)

    def prox(self, v, gamma):
        u, s, vt = jnp.linalg.svd(v.reshape(self.p, self.q),
                                  full_matrices=False)
        s2 = jnp.maximum(s - gamma * self.lam, 0)
        y = jnp.matmul(u * s2[None, :], vt, precision="highest")
        return y.reshape(v.shape), self.lam * jnp.sum(s2)


@pytree_dataclass(meta=("p",))
class IndPSD:
    """Indicator of the positive-semidefinite cone over (p, p) symmetric
    matrices stored flat; prox = eigenvalue clamping (the Frobenius-nearest
    PSD matrix of the symmetrized input)."""

    p: int

    def __call__(self, x):
        m = x.reshape(self.p, self.p)
        m = 0.5 * (m + m.T)
        w = jnp.linalg.eigvalsh(m)
        dt = jnp.result_type(x)
        tol = 8 * self.p * jnp.finfo(dt).eps * jnp.maximum(
            1.0, jnp.max(jnp.abs(w)))
        return jnp.where(jnp.min(w) >= -tol, jnp.zeros((), dt), jnp.inf)

    def prox(self, v, gamma):
        del gamma
        m = v.reshape(self.p, self.p)
        m = 0.5 * (m + m.T)
        w, q = jnp.linalg.eigh(m)
        y = jnp.matmul(q * jnp.maximum(w, 0)[None, :], q.T, precision="highest")
        return y.reshape(v.shape), jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class HingeLoss:
    """g(x) = lam * sum_i max(0, 1 - b_i * x_i) with labels b in {-1, +1}
    (ProximalOperators.HingeLoss; the primal SVM loss whose dual is the
    reference's dual-SVM box-QP, experiments/dual_svm/runme.jl:47-54).
    Elementwise closed-form prox: step toward the margin by at most
    gamma*lam, stopping exactly on it."""

    b: jnp.ndarray = 1.0
    lam: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.lam * jnp.sum(jnp.maximum(0.0, 1.0 - self.b * x))

    def prox(self, v, gamma):
        z = self.b * v  # signed margin; |b_i| == 1 so the substitution is isometric
        y = v + self.b * jnp.minimum(gamma * self.lam,
                                     jnp.maximum(0.0, 1.0 - z))
        return y, self(y)


@pytree_dataclass
class LogBarrier:
    """g(x) = -mu * sum_i log(x_i) (domain x > 0); elementwise closed-form
    prox y = (v + sqrt(v^2 + 4*gamma*mu)) / 2 > 0 — the positive root of
    y^2 - v*y - gamma*mu = 0. Gives the solver family interior-point-style
    barrier terms beyond the reference's operator set."""

    mu: jnp.ndarray = 1.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        ok = jnp.all(x > 0)
        val = -self.mu * jnp.sum(jnp.log(jnp.where(x > 0, x, 1.0)))
        return jnp.where(ok, val.astype(dt), jnp.inf)

    def prox(self, v, gamma):
        # v + sqrt(v^2 + c) cancels catastrophically for large negative v
        # (f32: prox(-5e3, 1, mu=0.4) rounded to exactly 0, violating y > 0
        # and inf-poisoning the solve). Rationalize the negative branch:
        # (v + r)/2 == 2*gamma*mu / (r - v), cancellation-free since r-v >= r.
        r = jnp.sqrt(v * v + 4.0 * gamma * self.mu)
        y = jnp.where(v > 0, 0.5 * (v + r), 2.0 * gamma * self.mu / (r - v))
        return y, self(y)


@pytree_dataclass
class IndHalfspace:
    """Indicator of {x : <a, x> <= c}; prox = one-reflection projection
    x - max(0, (<a,x> - c)/||a||^2) * a."""

    a: jnp.ndarray
    c: jnp.ndarray = 0.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        s = jnp.sum(self.a * x)
        # dtype-relative tolerance: the projection lands on the boundary in
        # exact arithmetic but the recomputed inner product can overshoot
        scale = jnp.maximum(1.0, jnp.abs(s)) + jnp.sqrt(jnp.sum(self.a**2))
        tol = 8 * x.size * jnp.finfo(dt).eps * scale
        return jnp.where(s <= self.c + tol, jnp.zeros((), dt), jnp.inf)

    def prox(self, v, gamma):
        del gamma
        nrm2 = jnp.sum(self.a * self.a)
        excess = jnp.maximum(0.0, jnp.sum(self.a * v) - self.c)
        y = v - (excess / jnp.where(nrm2 > 0, nrm2, 1.0)) * self.a
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass
class IndHyperplane:
    """Indicator of {x : <a, x> = c}; prox = affine projection
    x - ((<a,x> - c)/||a||^2) * a (the single-row case of
    ProximalOperators.IndAffine; general affine constraints go through
    h(Ax) with h = Translate(IndZero, -c) as the reference's dual SVM does)."""

    a: jnp.ndarray
    c: jnp.ndarray = 0.0

    def __call__(self, x):
        dt = jnp.result_type(x)
        s = jnp.sum(self.a * x)
        scale = jnp.maximum(1.0, jnp.abs(s)) + jnp.sqrt(jnp.sum(self.a**2))
        tol = 8 * x.size * jnp.finfo(dt).eps * scale
        return jnp.where(jnp.abs(s - self.c) <= tol, jnp.zeros((), dt), jnp.inf)

    def prox(self, v, gamma):
        del gamma
        nrm2 = jnp.sum(self.a * self.a)
        off = (jnp.sum(self.a * v) - self.c) / jnp.where(nrm2 > 0, nrm2, 1.0)
        y = v - off * self.a
        return y, jnp.zeros((), dtype=jnp.result_type(v))


@pytree_dataclass(meta=("sizes",))
class SeparableSum:
    """g(x) = sum_i g_i(x_i) over contiguous slices of the given static
    sizes (ProximalOperators.SlicedSeparableSum); prox applies each g_i to
    its slice. As an ``h``, pairs with ``linops.StackedOperator`` so one PD
    solve handles h(Ax) = sum_i h_i(A_i x) — the conjugate is the separable
    sum of the conjugates, so the dual prox stays slice-wise closed-form.
    """

    fns: tuple
    sizes: tuple

    def _slices(self, x):
        out, off = [], 0
        for s in self.sizes:
            out.append(x[off:off + s])
            off += s
        return out

    def __call__(self, x):
        total = None
        for f, xi in zip(self.fns, self._slices(x)):
            v = f(xi)
            total = v if total is None else total + v
        return total

    def prox(self, v, gamma):
        ys, total = [], None
        for f, vi in zip(self.fns, self._slices(v)):
            y, val = f.prox(vi, gamma)
            ys.append(y)
            total = val if total is None else total + val
        return jnp.concatenate(ys), total


@pytree_dataclass
class Scale:
    """g(x) = a * inner(x) for a > 0 (ProximalOperators.Postcompose):
    prox_{gamma g} = prox_{(a gamma) inner}."""

    inner: object
    a: jnp.ndarray = 1.0

    def __call__(self, x):
        return self.a * self.inner(x)

    def prox(self, v, gamma):
        y, val = self.inner.prox(v, self.a * gamma)
        return y, self.a * val


@pytree_dataclass
class Translate:
    """g(x) = inner(x + b)  (ProximalOperators.Translate; used as
    h = Translate(NormL2(), -y) at experiments/square_root_lasso/runme.jl:41).

    prox_{gamma g}(v) = prox_{gamma inner}(v + b) - b.
    """

    inner: object
    b: jnp.ndarray

    def __call__(self, x):
        return self.inner(x + self.b)

    def prox(self, v, gamma):
        u, val = self.inner.prox(v + self.b, gamma)
        return u - self.b, val


@pytree_dataclass
class MoreauConjugate:
    """Convex conjugate h* with prox given by the Moreau identity:

        prox_{gamma h*}(v) = v - gamma * prox_{h / gamma}(v / gamma)

    This is how ProximalCore evaluates ``prox(convex_conjugate(h), w, sigma)``
    in the reference dual update (src/AdaProx.jl:345). The value h*(y) is not
    needed by any solver (the reference discards it too); we return 0.
    """

    inner: object

    def __call__(self, x):  # pragma: no cover - not used by solvers
        raise NotImplementedError(
            "MoreauConjugate has no closed-form value; solvers never need it"
        )

    def prox(self, v, gamma):
        u, _ = self.inner.prox(v / gamma, 1.0 / gamma)
        y = v - gamma * u
        return y, jnp.zeros((), dtype=jnp.result_type(v))


def conjugate(g):
    """Convex conjugate of ``g`` — analytic where known, Moreau otherwise."""
    if isinstance(g, Zero):
        return IndZero()
    if isinstance(g, IndZero):
        return Zero()
    if isinstance(g, L1Norm):
        return IndBox(-g.lam, g.lam)
    if isinstance(g, L2Norm):
        return IndBall2(g.lam)
    if isinstance(g, IndBall2):
        return L2Norm(lam=g.r)
    if isinstance(g, LInfNorm):
        return IndBall1(r=g.lam)
    if isinstance(g, IndBall1):
        return LInfNorm(lam=g.r)
    if isinstance(g, SqrL2Norm):
        return SqrL2Norm(lam=1.0 / g.lam)
    if isinstance(g, SeparableSum):
        # (g1 (+) g2)* = g1* (+) g2* — slice-wise duals stay closed-form
        return SeparableSum(fns=tuple(conjugate(f) for f in g.fns),
                            sizes=g.sizes)
    return MoreauConjugate(g)
