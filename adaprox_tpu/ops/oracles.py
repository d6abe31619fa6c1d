"""Smooth-term oracles (the `f` in min f(x) + g(x) + h(Ax)).

The reference's gradient interface is ``eval_with_pullback(f, x) -> (f_x, pb)``
with ``pb() -> grad`` (src/AdaProx.jl:11-16): experiments hand-write pullbacks
that reuse the forward matvec (e.g. lasso's residual, lasso/runme.jl:21-26).

A returned closure cannot live in a ``lax.while_loop``/``scan`` carry, so the
protocol here splits the pullback into data + a pure function:

  * ``value_and_aux(x) -> (f_x, aux)``  — forward pass; ``aux`` is a pytree of
    residuals that makes the gradient cheap (the "saved pullback state").
  * ``grad_from_aux(x, aux) -> grad``   — finishes the gradient from ``aux``.

``aux`` IS carry-able, so backtracking linesearch loops can evaluate values
per trial and finish exactly one gradient after acceptance — the same oracle
economy the reference gets from lazy pullbacks (src/AdaProx.jl:37,45,61).

``FromFunction`` wraps any jittable python callable via ``jax.value_and_grad``
(the autodiff default the reference deliberately avoids; here XLA makes the
hand-written and autodiff paths equivalent after fusion).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .._pytree import pytree_dataclass

__all__ = ["SmoothOracle", "FromFunction", "ZeroSmooth",
           "value_and_grad"]


class SmoothOracle:
    """Method mixin: concrete oracles define value_and_aux / grad_from_aux."""

    def value_and_aux(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def grad_from_aux(self, x, aux):  # pragma: no cover - interface
        raise NotImplementedError

    def value(self, x):
        return self.value_and_aux(x)[0]

    def __call__(self, x):
        return self.value(x)

    def grad(self, x):
        f_x, aux = self.value_and_aux(x)
        del f_x
        return self.grad_from_aux(x, aux)

    def value_and_grad(self, x):
        f_x, aux = self.value_and_aux(x)
        return f_x, self.grad_from_aux(x, aux)

    def bregman_from_aux(self, dx, aux, aux_prev):
        """Optional: the Bregman term f(x) - f(x_prev) - <grad(x_prev), dx>
        in a cancellation-RESISTANT form, or None when the oracle has no
        better form than the raw difference.

        Linesearch acceptance tests (Malitsky-Pock src/AdaProx.jl:564,
        backtracking :38-44) compare this term against ~||dx||^2. The raw
        difference form carries absolute rounding error ~eps*|f(x)|, which
        at f32 with |f| >> ||dx||^2 makes the test garbage: measured on the
        synthetic mushrooms dual SVM, MP stalls at residual ~2e+01 in f32
        where f64 reaches 3e-05 (tools/adjudicate_dsvm.py). Quadratic-type
        oracles can compute the term as 0.5*||A dx||^2 (>= 0, second-order
        noise only) from already-carried auxes — no extra HBM pass."""
        del dx, aux, aux_prev
        return None


def value_and_grad(f, x):
    """``eval_with_gradient`` analogue (src/AdaProx.jl:13-16)."""
    if isinstance(f, SmoothOracle) or hasattr(f, "value_and_grad"):
        return f.value_and_grad(x)
    return jax.value_and_grad(f)(x)


@pytree_dataclass
class ZeroSmooth(SmoothOracle):
    """f = 0 with a zero pullback — the reference defines this ad hoc for the
    fully-nonsmooth problems (square_root_lasso/runme.jl:18-21)."""

    def value_and_aux(self, x):
        return jnp.zeros((), dtype=jnp.result_type(x)), None

    def grad_from_aux(self, x, aux):
        del aux
        return jnp.zeros_like(x)


@pytree_dataclass(meta=("fn",))
class FromFunction(SmoothOracle):
    """Adapter: any jittable callable -> SmoothOracle via JAX autodiff.

    ``aux`` stores the gradient itself (computed jointly with the value),
    so ``grad_from_aux`` is free. This costs a backward pass per value
    evaluation — write a custom oracle for hot linesearch loops.
    """

    fn: object

    def value_and_aux(self, x):
        f_x, g = jax.value_and_grad(self.fn)(x)
        return f_x, g

    def grad_from_aux(self, x, aux):
        del x
        return aux
