"""Adaptive stepsize rules — the core contribution of the reference paper
("Adaptive proximal algorithms for convex optimization under local Lipschitz
continuity of the gradient", arXiv:2301.04431).

Protocol (mirrors the 2-arity ``stepsize`` dispatch at src/AdaProx.jl:213-308):

  * ``rule.init() -> ((gamma, sigma), state)``
  * ``rule.update(state, curv) -> ((gamma, sigma), state)``

where ``curv`` is the `Curvature` triple of cross-iterate reductions

    ndg2 = ||grad_1 - grad_0||^2
    dgdx = <grad_1 - grad_0, x_1 - x_0>
    ndx2 = ||x_1 - x_0||^2

These three scalars are the ONLY cross-device communication an adaptive step
needs per iteration: on a sharded problem they are local partial reductions +
one psum. Rules consume the reductions rather than the raw iterate vectors
so XLA can fuse the three into one pass.

All rule parameters are dynamic pytree leaves -> a solver can be ``vmap``-ed
over e.g. ``t`` for the coupling sweeps (dual_svm/runme.jl:61-76) in one
compiled program.
"""

from __future__ import annotations

import numbers
import warnings
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .._pytree import pytree_dataclass

__all__ = [
    "Curvature",
    "FixedStepsize",
    "MalitskyMishchenkoRule",
    "AdaPGMRule",
    "AdaPGMPlusRule",
    "OurRule",
    "OurRulePlus",
    "nan_to_zero",
]


class Curvature(NamedTuple):
    """Cross-iterate reductions feeding an adaptive rule."""

    ndg2: jnp.ndarray  # ||grad_1 - grad_0||^2
    dgdx: jnp.ndarray  # <grad_1 - grad_0, x_1 - x_0>
    ndx2: jnp.ndarray  # ||x_1 - x_0||^2

    @staticmethod
    def of(x1, grad1, x0, grad0, dtype=None):
        """``dtype``: compute the reductions in a wider dtype (the f64-scalar
        hybrid). Upcasting BEFORE the subtraction makes the differences of
        f32 iterates exact in f64, so the delicate dgdx inner product (the
        reference's f64 regime, src/AdaProx.jl:260-261) loses nothing to
        cancellation even though the iterates live in f32."""
        if dtype is not None:
            x1, grad1, x0, grad0 = (v.astype(dtype) for v in (x1, grad1, x0, grad0))
        dg = grad1 - grad0
        dx = x1 - x0
        return Curvature(
            ndg2=jnp.sum(dg * dg), dgdx=jnp.vdot(dg, dx).real, ndx2=jnp.sum(dx * dx)
        )


def nan_to_zero(v):
    """NaN guard on curvature ratios (src/AdaProx.jl:24): 0/0 -> 0, but
    +/-inf are preserved (they fall out of the min/max as in the reference)."""
    return jnp.where(jnp.isnan(v), jnp.zeros_like(v), v)


def validate_positive(**params):
    """Raise ValueError for any concrete non-positive parameter.

    Shared by every rule `.make` and solver entry point so invalid
    parameters fail loudly with a uniform message instead of NaN-poisoning
    the trajectory (the reference's equivalent is a Julia DomainError at
    the first stepsize update, src/AdaProx.jl:267). Traced/array values are
    skipped — they cannot be validated at trace time; vmapped sweeps stay
    usable. Bools are rejected (gamma=True silently meaning gamma=1.0 is a
    bug, not a parameter), and any concrete real scalar — Python or NumPy —
    is checked (np.float32(-1) must fail the same way float(-1) does)."""
    for name, v in params.items():
        if isinstance(v, (bool, np.bool_)):
            raise TypeError(
                f"{name} must be a positive number, got the bool {v!r}")
        if isinstance(v, jax.core.Tracer):
            continue
        if isinstance(v, numbers.Complex) and not isinstance(v, numbers.Real):
            # complex step sizes NaN/garbage-poison the solve exactly like
            # negative ones — same loud failure, uniform message
            raise TypeError(
                f"{name} must be a positive real number, got {v!r}")
        if isinstance(v, numbers.Real):
            val = float(v)
        elif isinstance(v, (np.ndarray, jnp.ndarray)) and jnp.ndim(v) == 0:
            if not jax.core.is_concrete(v):
                continue
            if v.dtype == jnp.bool_:  # np.asarray(True) is the same bug
                raise TypeError(
                    f"{name} must be a positive number, got the bool {v!r}")
            if jnp.issubdtype(v.dtype, jnp.complexfloating):
                raise TypeError(
                    f"{name} must be a positive real number, got {v!r}")
            val = float(v)
        else:
            continue
        if not val > 0:
            raise ValueError(f"{name} must be positive, got {name}={v!r}")


@pytree_dataclass
class FixedStepsize:
    """Constant (gamma, gamma * t^2) (src/AdaProx.jl:208-215)."""

    gamma: jnp.ndarray
    t: jnp.ndarray = 1.0

    @classmethod
    def make(cls, gamma, t=1.0):
        """Validated constructor: gamma, t > 0 (uniform with the other
        rules' .make; a non-positive gamma makes every prox step a no-op
        or reversed)."""
        validate_positive(gamma=gamma, t=t)
        return cls(gamma=gamma, t=t)

    def init(self):
        g = jnp.asarray(self.gamma)
        return (g, g * self.t**2), ()

    def update(self, state, curv):
        del curv
        return self.init()[0], state


@pytree_dataclass
class MalitskyMishchenkoRule:
    """Malitsky & Mishchenko, "Adaptive Gradient Descent without Descent"
    (PMLR 119:6702-6712). gamma = min(sqrt(1+rho)*gamma_prev, 1/(2L)) with
    L = ||dgrad|| / ||dx|| (src/AdaProx.jl:217-230). State: (gamma, rho)."""

    gamma: jnp.ndarray
    t: jnp.ndarray = 1.0

    @classmethod
    def make(cls, gamma, t=1.0):
        """Validated constructor: gamma, t > 0 (uniform with the other
        rules' .make)."""
        validate_positive(gamma=gamma, t=t)
        return cls(gamma=gamma, t=t)

    def init(self):
        g = jnp.asarray(self.gamma)
        return (g, g * self.t**2), (g, jnp.asarray(jnp.inf, dtype=g.dtype))

    def update(self, state, curv):
        gamma_prev, rho = state
        lip = jnp.sqrt(curv.ndg2) / jnp.sqrt(curv.ndx2)
        # rho is inf on the first update (init state): growth bound inactive.
        # Guard explicitly rather than relying on sqrt(1+inf)==inf: some
        # backends' emulated f64 evaluates sqrt(1+inf) to NaN; the where()
        # gives the exact limit on every backend.
        growth = jnp.where(
            jnp.isfinite(rho), jnp.sqrt(1 + rho) * gamma_prev, jnp.inf
        )
        # identical iterates give L = 0/0 = NaN; fall back to the growth
        # bound instead of poisoning gamma (latent in the f64 reference)
        gamma = jnp.where(
            jnp.isnan(lip), growth, jnp.minimum(growth, 1 / (2 * lip))
        )
        return (gamma, gamma * self.t**2), (gamma, gamma / gamma_prev)


def _resolve_gamma(gamma, t, norm_a, theta, delta=0.0):
    """Reference OurRule constructor logic (src/AdaProx.jl:240-250):
    gamma if gamma > 0, else 1/(2*Theta*t*||A||) if ||A|| > 0, else error.

    Additionally clamps a user-provided gamma to the reference's actual
    failure bound 1/(2*t*||A||*(1+delta)): the first stepsize update
    computes sqrt(1 - 4*xi*(1+delta)^2) with xi = t^2*gamma^2*||A||^2
    (src/AdaProx.jl:267), so any larger init makes that argument negative —
    Julia raises DomainError there; jnp.sqrt would silently NaN the whole
    solve. Theta does NOT enter the failure bound (it only sets the default
    gamma and the per-update coupling cap): inits in
    (1/(2*Theta*t*||A||), 1/(2*t*||A||*(1+delta))] run fine in the
    reference — the first iterate uses gamma_init as given, the coupling
    min only binds from update 1 — and pass through here unchanged. The
    clamp is nudged strictly inside the bound because landing exactly on it
    zeroes the sqrt argument (0/0 when D <= 0)."""
    if gamma is None:
        gamma = 0.0
    if all(isinstance(v, (int, float)) for v in (gamma, t, norm_a, theta, delta)):
        if gamma <= 0 and norm_a <= 0:
            raise ValueError("you must provide gamma > 0 if norm_A = 0")
        if norm_a <= 0:
            return gamma
        bound = 1.0 / (2 * t * norm_a * (1.0 + delta) * (1 + 1e-6))
        if gamma <= 0:
            return 1.0 / (2 * theta * t * norm_a)
        if gamma > bound:
            warnings.warn(
                f"gamma={gamma} exceeds the coupling bound "
                f"1/(2*t*||A||*(1+delta)) = {bound:.3g}; clamping "
                "(the reference raises DomainError at the first stepsize "
                "update for such an init)", stacklevel=3)
            return bound
        return gamma
    # traced values (e.g. under vmap over t): select and clamp at runtime
    g = jnp.where(jnp.asarray(gamma) > 0, gamma, 1.0 / (2 * theta * t * norm_a))
    bound = 1.0 / (2 * t * norm_a * (1.0 + jnp.asarray(delta)) * (1 + 1e-6))
    return jnp.where(jnp.asarray(norm_a) > 0, jnp.minimum(g, bound), g)


@pytree_dataclass
class AdaPGMRule:
    """The paper's adaptive rule ("OurRule", AdaPGM/AdaPDM;
    src/AdaProx.jl:232-273). State: (gamma_1, gamma_0).

    gamma = min( gamma1 * sqrt(1 + gamma1/gamma0),
                 1 / (2 * Theta * t * ||A||),
                 gamma1 * sqrt(1 - 4 xi (1+delta)^2)
                   / sqrt(2 (1+delta) (D + sqrt(D^2 + xi (1 - 4 xi (1+delta)^2)))) )
    with xi = t^2 gamma1^2 ||A||^2,
         C  = ||dg||^2 / <dg, dx>   (nan -> 0)
         L  = <dg, dx> / ||dx||^2   (nan -> 0)
         D  = gamma1 * L * (gamma1 * C - 1)
    sigma = gamma * t^2.
    """

    gamma: jnp.ndarray
    t: jnp.ndarray = 1.0
    norm_a: jnp.ndarray = 0.0
    delta: jnp.ndarray = 0.0
    theta: jnp.ndarray = 1.2

    @classmethod
    def make(cls, gamma=None, t=1.0, norm_a=0.0, delta=0.0, theta=1.2):
        g = _resolve_gamma(gamma, t, norm_a, theta, delta)
        return cls(gamma=g, t=t, norm_a=norm_a, delta=delta, theta=theta)

    def init(self):
        g = jnp.asarray(self.gamma)
        return (g, g * self.t**2), (g, g)

    def update(self, state, curv):
        gamma1, gamma0 = state
        xi = self.t**2 * gamma1**2 * self.norm_a**2
        # D = gamma1 * L * (gamma1 * C - 1) with C = ndg2/dgdx, L = dgdx/ndx2
        # (src/AdaProx.jl:260-262). The dgdx factors cancel, so compute the
        # cancellation-free form directly: the reference's factored form
        # produces 0 * inf = NaN when dgdx underflows to exactly 0 near
        # convergence (triggered in f32; latent in the f64 reference). The
        # nan guard then covers only the genuine 0/0 case ndx2 == 0.
        dd = nan_to_zero(gamma1 * (gamma1 * curv.ndg2 - curv.dgdx) / curv.ndx2)
        one_p_delta = 1 + self.delta
        m4xim1 = 1 - 4 * xi * one_p_delta**2
        # D + sqrt(D^2 + xi*m4xim1) is mathematically >= 0 but can round to a
        # tiny negative when D < 0 and xi == 0 (sqrt(D^2) can be one ulp below
        # |D|), which would NaN the sqrt; clamping gives the exact limit +inf
        # for the term, and the min falls through to the other two bounds.
        denom = jnp.maximum(dd + jnp.sqrt(dd**2 + xi * m4xim1), 0.0)
        # jnp division so norm_a == 0 gives +inf (no coupling bound), never a
        # python ZeroDivisionError when fields are concrete floats
        coupling = 1 / (2 * self.theta * self.t * jnp.asarray(self.norm_a))
        gamma = jnp.minimum(
            gamma1 * jnp.sqrt(1 + gamma1 / gamma0),
            jnp.minimum(
                coupling,
                gamma1 * jnp.sqrt(m4xim1) / jnp.sqrt(2 * one_p_delta * denom),
            ),
        )
        sigma = gamma * self.t**2
        return (gamma, sigma), (gamma, gamma1)


@pytree_dataclass
class AdaPGMPlusRule:
    """Variant rule with (nu, xi, r) parameters ("OurRulePlus",
    src/AdaProx.jl:277-308; part of the public API surface though no
    experiment invokes it). State: (gamma_1, gamma_0); sigma == gamma."""

    gamma: jnp.ndarray
    xi: jnp.ndarray = 1.0
    nu: jnp.ndarray = 1.0
    r: jnp.ndarray = 0.5

    @classmethod
    def make(cls, gamma=None, xi=1.0, nu=1.0, r=0.5):
        """Validated constructor (mirrors AdaPGMRule.make). The reference
        ctor (src/AdaProx.jl:285-292) only checks gamma > 0; but the update
        at :300-307 computes sqrt((nu*(1+xi) - 1)/(nu*(nu+xi))) and
        sqrt(1/(r*(nu+xi)) + ...), so nu*(1+xi) <= 1 or r <= 0 silently
        NaN-poisons every subsequent stepsize under jnp.sqrt — the same
        failure mode make() was added to close for AdaPGMRule. Direct
        AdaPGMPlusRule(...) construction stays unvalidated (pytree
        unflatten cannot validate); prefer .make."""
        if gamma is None or (isinstance(gamma, (int, float)) and gamma <= 0):
            raise ValueError("you must provide gamma > 0")
        validate_positive(xi=xi, nu=nu, r=r)
        if all(isinstance(v, (int, float)) for v in (nu, xi)):
            if not nu * (1 + xi) > 1:
                raise ValueError(
                    f"need nu*(1+xi) > 1 (got nu={nu}, xi={xi}: "
                    f"nu*(1+xi)={nu * (1 + xi)}); the stepsize bound "
                    "sqrt((nu*(1+xi)-1)/(nu*(nu+xi))) is imaginary otherwise "
                    "and every update would be NaN")
        return cls(gamma=gamma, xi=xi, nu=nu, r=r)

    def init(self):
        g = jnp.asarray(self.gamma)
        return (g, g), (g, g)

    def update(self, state, curv):
        gamma1, gamma0 = state
        # cancellation-free form of 1 - 2r + gamma1*L*(gamma1*C + 2(r-1))
        # (src/AdaProx.jl:300-302); see AdaPGMRule.update for why. The nan
        # guard wraps ONLY the 0/0 fraction: on identical iterates the
        # reference's per-ratio nan_to_zero gives C = L = 0, so D = 1 - 2r
        # (a live constant when r != 0.5) — guarding the whole expression
        # would erase it
        dd = 1 - 2 * self.r + nan_to_zero(
            gamma1 * (gamma1 * curv.ndg2 + 2 * (self.r - 1) * curv.dgdx)
            / curv.ndx2
        )
        gamma = gamma1 * jnp.minimum(
            jnp.sqrt(1 / (self.r * (self.nu + self.xi)) + gamma1 / gamma0),
            jnp.sqrt((self.nu * (1 + self.xi) - 1) / (self.nu * (self.nu + self.xi)))
            / jnp.sqrt(jnp.maximum(dd, 0)),
        )
        return (gamma, gamma), (gamma, gamma1)


# Reference-parity aliases
OurRule = AdaPGMRule
OurRulePlus = AdaPGMPlusRule
