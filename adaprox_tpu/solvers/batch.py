"""Batched solves via vmap — one compiled program for many problem instances.

The reference runs hyperparameter sweeps as sequential outer loops (e.g. the
t-grid at dual_svm/runme.jl:63-76 or per-lambda lasso paths); here the
whole grid vectorizes over the rule/operator pytree leaves and executes as a
single program (SURVEY §2.4 "Batched problem instances").

``batch_solve(solve, batched)`` vmaps ``solve`` over one pytree of batched
inputs; ``regularization_path`` is the canonical instance: a lasso path over
a vector of L1 weights (the BASELINE.json "vmapped regularization-path
batch" config).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.prox import L1Norm
from ..solvers.rules import AdaPGMRule
from .primal_dual import adaptive_proxgrad

__all__ = ["batch_solve", "regularization_path"]


def batch_solve(solve, batched):
    """vmap ``solve`` over the leading axis of every leaf in ``batched``.

    ``solve(batched_slice) -> SolveResult``. The result's ``name`` (a string)
    cannot ride through vmap; it is stripped and must be attached by the
    caller per slice.
    """

    def inner(sl):
        return solve(sl)._replace(name=None)

    return jax.vmap(inner)(batched)


def regularization_path(
    x0,
    *,
    f,
    lams,
    gamma,
    tol=1e-5,
    maxit=1000,
    history=False,
):
    """Solve min f(x) + lam * ||x||_1 for every lam in ``lams`` as ONE
    compiled vmapped program. Returns a SolveResult whose leaves have a
    leading axis of len(lams)."""
    lams = jnp.asarray(lams)

    def solve(lam):
        return adaptive_proxgrad(
            x0, f=f, g=L1Norm(lam=lam), rule=AdaPGMRule(gamma=gamma),
            tol=tol, maxit=maxit, history=history,
        )

    return batch_solve(solve, lams)
